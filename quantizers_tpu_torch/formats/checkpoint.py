"""Checkpoint-level save/load of compressed models.

Counterpart of ``quantizers_tpu/formats/checkpoint.py``: a directory of
safetensors shards, a ``model.safetensors.index.json`` and a
``config.json`` whose ``quantization_config`` block follows the
compressed-tensors schema, the layout ``save_pretrained(save_compressed=True)``
writes, so the outputs interchange with vLLM, with the reference pipeline
and with the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..core.numerics import QuantizedTensor
from ..core.scheme import QuantizationArgs, QuantScheme, QuantType, is_ignored, match_targets
from .compressed_tensors import (
    build_quantization_config,
    compress_tensor,
    decompress_tensor,
    parse_quantization_config,
)
from .safetensors_io import ShardedReader, ShardedWriter, dump_json, load_json


@dataclasses.dataclass
class CompressedParam:
    """A weight selected for quantization, with its scheme and group name."""

    qt: QuantizedTensor
    args: QuantizationArgs
    group: str = "group_0"
    g_idx: Optional[torch.Tensor] = None  # actorder permutation, if any


def _qt_to(qt: QuantizedTensor, device: torch.device) -> QuantizedTensor:
    """The quantized tensor with every part on ``device``."""
    def to(t):
        return None if t is None else t.to(device)
    return qt._replace(values=to(qt.values), scale=to(qt.scale),
                       zero_point=to(qt.zero_point), global_scale=to(qt.global_scale))


def save_compressed_model(
    out_dir: Union[str, Path],
    plain_params: Dict[str, torch.Tensor],
    quant_params: Dict[str, CompressedParam],
    config_groups: Dict[str, QuantScheme],
    ignore: List[str],
    base_config: Optional[Dict[str, Any]] = None,
    kv_cache_scheme: Optional[QuantizationArgs] = None,
    max_shard_bytes: int = 5 * 1024**3,
    scale_dtype: torch.dtype = torch.bfloat16,
    pack_device: Optional[torch.device] = None,
) -> None:
    """Write a compressed-tensors checkpoint directory.

    ``plain_params`` maps full param names (``...weight``) to tensors stored
    as they are; ``quant_params`` maps *module prefixes* (no ``.weight``
    suffix) to their quantized payloads, which are packed on
    ``pack_device`` (their own device if None), one at a time, and then
    moved to the CPU.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    writer = ShardedWriter(out, max_shard_bytes=max_shard_bytes)
    for name, t in plain_params.items():
        writer.add(name, t)
    for prefix, cp in quant_params.items():
        qt = cp.qt if pack_device is None else _qt_to(cp.qt, pack_device)
        tensors = compress_tensor(prefix, qt, cp.args, scale_dtype=scale_dtype)
        if cp.g_idx is not None:
            tensors[f"{prefix}.weight_g_idx"] = cp.g_idx.to(torch.int32)
        writer.add_many(tensors)
    writer.finalize(metadata={"format": "pt"})

    cfg = dict(base_config or {})
    cfg["quantization_config"] = build_quantization_config(
        config_groups, ignore, kv_cache_scheme=kv_cache_scheme
    )
    dump_json(cfg, out / "config.json")


def _module_prefixes(keys: List[str]) -> Dict[str, List[str]]:
    """Group on-disk tensor names by module prefix for quantized params."""
    suffixes = (
        ".weight_packed",
        ".weight_scale",
        ".weight_shape",
        ".weight_zero_point",
        ".weight_g_idx",
        ".weight_global_scale",
        ".weight_scale_inv",
    )
    groups: Dict[str, List[str]] = {}
    for key in keys:
        for suf in suffixes:
            if key.endswith(suf):
                groups.setdefault(key[: -len(suf)], []).append(key)
                break
    return groups


#: Mixtral/MiniMax expert-path dialect: a config whose targets use
#: ``block_sparse_moe...w1/w2/w3`` must still resolve against the native
#: on-disk naming ``mlp.experts.N.gate/up/down_proj``, and the other way
#: round when reading a MiniMax checkpoint with a native-dialect config.
_EXPERT_PATH_ALIASES = (
    (".mlp.experts.", ".block_sparse_moe.experts.",
     {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}),
    (".block_sparse_moe.experts.", ".mlp.experts.",
     {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}),
)


def _alias_prefixes(prefix: str) -> List[str]:
    out = [prefix]
    for container, alt_container, names in _EXPERT_PATH_ALIASES:
        if container in prefix:
            leaf = prefix.rsplit(".", 1)[-1]
            alt = names.get(leaf)
            if alt is not None:
                out.append(prefix.replace(container, alt_container)
                           .rsplit(".", 1)[0] + "." + alt)
    return out


def _scheme_for(prefix: str, groups: Dict[str, QuantScheme], ignore: List[str],
                stored: Optional[List[str]] = None) -> Optional[QuantScheme]:
    """Resolve the scheme for a module. In mixed-precision checkpoints
    several groups may target the same module type, so when the on-disk
    parameter names are known the candidates are filtered by consistency
    with what is actually stored. Expert paths match under both the native
    and the Mixtral/MiniMax w1/w2/w3 dialect (:data:`_EXPERT_PATH_ALIASES`)."""
    paths = _alias_prefixes(prefix)
    if any(is_ignored(p, ignore) for p in paths):
        return None
    candidates = [s for s in groups.values()
                  if any(match_targets(p, "Linear", list(s.targets)) for p in paths)]
    if not candidates:
        return None
    if stored and len(candidates) > 1:
        consistent = [s for s in candidates
                      if s.weights is not None and _args_match_stored(s.weights, prefix, stored)]
        if consistent:
            return consistent[0]
    return candidates[0]


def _args_match_stored(args: QuantizationArgs, prefix: str, stored: List[str]) -> bool:
    names = set(stored)
    packed = f"{prefix}.weight_packed" in names
    global_scale = f"{prefix}.weight_global_scale" in names
    if args.type == QuantType.FLOAT and args.num_bits == 4:
        return packed and global_scale
    if args.type == QuantType.INT and args.num_bits < 8:
        return packed and not global_scale
    # 8-bit float/int: stored as plain `.weight` + `.weight_scale`
    return not packed


class CompressedModelReader:
    """Load a compressed-tensors checkpoint (the port's, the JAX package's,
    vLLM's or the reference's) back into quantized tensors + plain tensors,
    on the CPU."""

    def __init__(self, ckpt_dir: Union[str, Path]):
        self.dir = Path(ckpt_dir)
        cfg_path = self.dir / "config.json"
        self.config = load_json(cfg_path) if cfg_path.exists() else {}
        qcfg = self.config.get("quantization_config") or {}
        self.config_groups, self.ignore, self.kv_cache_scheme = (
            parse_quantization_config(qcfg) if qcfg else ({}, [], None)
        )
        self.reader = ShardedReader(self.dir)
        self._quant_prefixes = _module_prefixes(self.reader.keys())

    def quantized_modules(self) -> List[str]:
        return sorted(self._quant_prefixes)

    def plain_tensors(self) -> List[str]:
        quant_keys = {k for keys in self._quant_prefixes.values() for k in keys}
        return [k for k in self.reader.keys() if k not in quant_keys]

    def scheme_for(self, prefix: str) -> Optional[QuantScheme]:
        return _scheme_for(prefix, self.config_groups, self.ignore,
                           stored=self._quant_prefixes.get(prefix))

    def load_quantized(self, prefix: str, device=None
                       ) -> Tuple[QuantizedTensor, QuantizationArgs]:
        """The module's quantized tensor, unpacked on ``device`` (default:
        the CPU, where the tensors are read)."""
        scheme = self.scheme_for(prefix)
        if scheme is None or scheme.weights is None:
            raise KeyError(f"No quantization scheme matches module {prefix}")
        keys = list(self._quant_prefixes[prefix])
        # float-/int-quantized payloads live under plain `.weight`
        if f"{prefix}.weight" in self.reader:
            keys.append(f"{prefix}.weight")
        tensors = {k: self.reader.get(k).to(device) for k in keys}
        return decompress_tensor(prefix, tensors, scheme.weights), scheme.weights

    def load_plain(self, name: str) -> torch.Tensor:
        return self.reader.get(name)

    def g_idx(self, prefix: str) -> Optional[torch.Tensor]:
        key = f"{prefix}.weight_g_idx"
        return self.reader.get(key) if key in self.reader else None

    def close(self) -> None:
        self.reader.close()

    def __enter__(self) -> "CompressedModelReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
