"""Data-free PTQ: quantize a checkpoint shard by shard, with no model graph.

Counterpart of ``quantizers_tpu/oneshot/model_free.py``, the reference's
``llmcompressor.model_free_ptq`` (``scripts/quant_GLM-4.7-Flash-FP8.py:11-24``):
stream the safetensors shards, quantize every matching 2-D ``.weight`` under
the scheme on a pool of worker threads, and write compressed shards, a
``config.json`` with its ``quantization_config`` and the other assets. No
calibration data and no full-model load: host memory holds the open shards
(``ShardedReader``'s bound) and the tensors in flight.

The tensors are read on the calling thread, in the checkpoint's order
(``ShardedReader`` closes a shard's map when it opens another, so it is not
shared with the pool), and a bounded window of them is quantized on the
pool: each moves to the device, is quantized by
:func:`~quantizers_tpu_torch.core.numerics.quantize`, and its codes and
scales come back to the host before :func:`compress_tensor`, so device
memory holds only the tensors in flight. The results are written in the
checkpoint's order, so the output does not depend on ``max_workers``.
"""

from __future__ import annotations

import collections
import logging
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .._device import DeviceLike, resolve_device
from ..core.numerics import quantize
from ..core.scheme import QuantScheme, is_ignored, resolve_scheme
from ..formats.compressed_tensors import build_quantization_config, compress_tensor
from ..formats.safetensors_io import INDEX_NAME, ShardedReader, ShardedWriter, dump_json, load_json
from .modifiers import _to_host

logger = logging.getLogger(__name__)

# name fragments that are never weight-quantized even without an ignore entry
_ALWAYS_PLAIN = ("embed_tokens", "rotary_emb", "layernorm", ".norm.")


def _quantizable(name: str, t: torch.Tensor, ignore: Sequence[str]) -> Optional[str]:
    """The module prefix of ``name`` if it is a weight to quantize."""
    if not name.endswith(".weight") or t.ndim != 2:
        return None
    prefix = name[: -len(".weight")]
    if any(frag in name for frag in _ALWAYS_PLAIN):
        return None
    if is_ignored(prefix, list(ignore)):
        return None
    return prefix


def model_free_ptq(
    model_dir: Union[str, Path],
    save_directory: Union[str, Path],
    scheme: Union[str, QuantScheme, Dict[str, Any]] = "FP8_BLOCK",
    ignore: Sequence[str] = (),
    max_workers: int = 8,
    max_shard_bytes: int = 5 * 1024**3,
    device: DeviceLike = None,
) -> List[str]:
    """Quantize ``model_dir`` (HF safetensors layout) into a
    compressed-tensors checkpoint at ``save_directory`` on ``device`` (the
    CUDA card unless the caller names another). Returns the quantized
    module prefixes, in the checkpoint's order."""
    dev = resolve_device(device)
    model_dir, save_directory = Path(model_dir), Path(save_directory)
    sch = resolve_scheme(scheme) if not isinstance(scheme, QuantScheme) else scheme
    args = sch.weights
    if args is None:
        raise ValueError("scheme must quantize weights")

    save_directory.mkdir(parents=True, exist_ok=True)
    writer = ShardedWriter(save_directory, max_shard_bytes=max_shard_bytes)
    quantized: List[str] = []

    def _process(name: str, t: torch.Tensor
                 ) -> Tuple[Optional[str], Dict[str, torch.Tensor]]:
        prefix = _quantizable(name, t, ignore)
        if prefix is None:
            return None, {name: t}
        qt = _to_host(quantize(t.to(dev).float(), args))
        return prefix, compress_tensor(prefix, qt, args)

    def _drain(pending) -> None:
        prefix, tensors = pending.popleft().result()
        if prefix is not None:
            quantized.append(prefix)
        writer.add_many(tensors)

    with ShardedReader(model_dir) as reader, ThreadPoolExecutor(max_workers=max_workers) as pool:
        pending: collections.deque = collections.deque()
        for name in reader.keys():
            if len(pending) >= 2 * max_workers:
                _drain(pending)
            pending.append(pool.submit(_process, name, reader.get(name)))
        while pending:
            _drain(pending)
    writer.finalize(metadata={"format": "pt"})

    # config.json: the source's config with a quantization_config block
    cfg: Dict[str, Any] = {}
    src_cfg = model_dir / "config.json"
    if src_cfg.exists():
        cfg = load_json(src_cfg)
    cfg["quantization_config"] = build_quantization_config({"group_0": sch}, list(ignore))
    dump_json(cfg, save_directory / "config.json")

    # the tokenizer and generation assets, verbatim
    for f in model_dir.iterdir():
        if f.name == "config.json" or f.suffix == ".safetensors" or f.name == INDEX_NAME:
            continue
        if f.is_file():
            shutil.copy2(f, save_directory / f.name)

    logger.info("model_free_ptq: quantized %d tensors on %s -> %s", len(quantized), dev,
                save_directory)
    return quantized
