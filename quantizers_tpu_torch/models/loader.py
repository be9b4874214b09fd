"""Checkpoint -> params loaders, and params -> checkpoint writers.

Counterpart of ``quantizers_tpu/models/loader.py``: a plain HF bf16
safetensors checkpoint or a compressed-tensors checkpoint (the port's, the
JAX package's, vLLM's or the reference pipeline's) loads straight into the
transformer's params, with quantized weights in the port's at-rest
:class:`~quantizers_tpu_torch.ops.linear.QuantLinear` /
:class:`~quantizers_tpu_torch.models.moe.ExpertLinears` layouts. Tensors
are read on the CPU and unpacked on the target device, which is the CUDA
card unless the caller passes ``device="cpu"``. MLA models load with their
latent-attention projections, and FP8 (``float-quantized``) modules as
``fp8`` linears. The JAX package's zero-allocation ``abstract_quantized_tree``
is not ported yet (ROADMAP).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from .._device import DeviceLike, resolve_device
from ..formats.checkpoint import CompressedModelReader
from ..formats.safetensors_io import ShardedReader, ShardedWriter, dump_json
from ..ops.linear import QuantLinear, dense_linear, from_quantized
from .config import ModelSpec
from .moe import ExpertLinears

logger = logging.getLogger(__name__)


def _build_params(
    spec: ModelSpec,
    get_array: Callable[[str], Optional[torch.Tensor]],
    get_linear: Callable[[str], Optional[QuantLinear]],
    device: torch.device,
    dtype=torch.bfloat16,
) -> Dict[str, Any]:
    """Assemble the params dict from name-addressed accessors."""

    def arr(name: str) -> torch.Tensor:
        a = get_array(name)
        if a is None:
            raise KeyError(f"missing tensor {name}")
        return a.to(device=device, dtype=dtype)

    def lin(prefix: str, required: bool = True) -> Optional[QuantLinear]:
        out = get_linear(prefix)
        if out is None and required:
            raise KeyError(f"missing linear {prefix}")
        return out

    layers: List[Dict[str, Any]] = []
    for i in range(spec.num_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        layer: Dict[str, Any] = {
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
            "o_proj": lin(f"{a}.o_proj"),
        }
        if spec.is_mla:
            if spec.q_lora_rank:
                layer["q_a_proj"] = lin(f"{a}.q_a_proj")
                layer["q_a_layernorm"] = arr(f"{a}.q_a_layernorm.weight")
                layer["q_b_proj"] = lin(f"{a}.q_b_proj")
            else:
                layer["q_proj"] = lin(f"{a}.q_proj")
            layer["kv_a_proj_with_mqa"] = lin(f"{a}.kv_a_proj_with_mqa")
            layer["kv_a_layernorm"] = arr(f"{a}.kv_a_layernorm.weight")
            layer["kv_b_proj"] = lin(f"{a}.kv_b_proj")
        else:
            for proj in ("q_proj", "k_proj", "v_proj"):
                layer[proj] = lin(f"{a}.{proj}")
        if spec.qk_norm:
            layer["q_norm"] = arr(f"{p}.self_attn.q_norm.weight")
            layer["k_norm"] = arr(f"{p}.self_attn.k_norm.weight")
        if spec.layer_is_moe(i):
            projs = ("gate_proj", "up_proj", "down_proj")
            layer["moe"] = {
                "router": lin(f"{p}.mlp.gate"),
                **{proj: ExpertLinears.stack([lin(f"{p}.mlp.experts.{e}.{proj}")
                                              for e in range(spec.num_experts)])
                   for proj in projs},
            }
            bias = get_array(f"{p}.mlp.gate.e_score_correction_bias")
            if bias is not None:
                layer["moe"]["e_score_correction_bias"] = bias.to(device=device,
                                                                  dtype=torch.float32)
            if spec.num_shared_experts:
                layer["moe"]["shared_experts"] = {
                    proj: lin(f"{p}.mlp.shared_experts.{proj}") for proj in projs}
        else:
            layer["mlp"] = {proj: lin(f"{p}.mlp.{proj}")
                            for proj in ("gate_proj", "up_proj", "down_proj")}
        layers.append(layer)

    lm_head = None
    if not spec.tie_word_embeddings:
        lm_head = lin("lm_head", required=False)
        if lm_head is None:
            logger.info("no lm_head found; falling back to tied embeddings")
    return {
        "embed": arr("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": arr("model.norm.weight"),
        "lm_head": lm_head,
    }


# ---------------------------------------------------------------------------
# plain HF checkpoint
# ---------------------------------------------------------------------------

def load_hf_model(ckpt_dir: Union[str, Path], spec: Optional[ModelSpec] = None,
                  dtype=torch.bfloat16, device: DeviceLike = None
                  ) -> Tuple[ModelSpec, Dict[str, Any]]:
    """Load a local HF-format (bf16 safetensors) checkpoint directory onto
    ``device``."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    spec = spec or ModelSpec.from_hf_config(ckpt_dir)
    with ShardedReader(ckpt_dir) as reader:
        keys = set(reader.keys())

        def get_array(name: str) -> Optional[torch.Tensor]:
            return reader.get(name) if name in keys else None

        def get_linear(prefix: str) -> Optional[QuantLinear]:
            wname = f"{prefix}.weight"
            if wname not in keys:
                return None
            return dense_linear(reader.get(wname).to(dev), bias=get_array(f"{prefix}.bias"),
                                dtype=dtype)

        params = _build_params(spec, get_array, get_linear, dev, dtype=dtype)
    return spec, params


# ---------------------------------------------------------------------------
# compressed-tensors checkpoint
# ---------------------------------------------------------------------------

def load_compressed_model(ckpt_dir: Union[str, Path], spec: Optional[ModelSpec] = None,
                          dtype=torch.bfloat16, device: DeviceLike = None
                          ) -> Tuple[ModelSpec, Dict[str, Any]]:
    """Load a compressed-tensors checkpoint onto ``device``: dense, w4/w8
    INT, FP8 and NVFP4 linears, MoE expert stacks, shared experts and the
    router's ``e_score_correction_bias``."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    spec = spec or ModelSpec.from_hf_config(ckpt_dir)
    with CompressedModelReader(ckpt_dir) as reader:
        plain = set(reader.reader.keys())
        quant = set(reader.quantized_modules())

        def get_array(name: str) -> Optional[torch.Tensor]:
            return reader.load_plain(name) if name in plain else None

        def get_linear(prefix: str) -> Optional[QuantLinear]:
            bias = get_array(f"{prefix}.bias")
            if prefix in quant:
                qt, args = reader.load_quantized(prefix, device=dev)
                scheme = reader.scheme_for(prefix)
                return from_quantized(qt, args, bias=bias,
                                      act_args=scheme.input_activations if scheme else None)
            wname = f"{prefix}.weight"
            if wname in plain:
                return dense_linear(reader.load_plain(wname).to(dev), bias=bias, dtype=dtype)
            return None

        params = _build_params(spec, get_array, get_linear, dev, dtype=dtype)
    return spec, params


def load_checkpoint(ckpt_dir: Union[str, Path], device: DeviceLike = None
                    ) -> Tuple[ModelSpec, Dict[str, Any], Dict[str, Any]]:
    """(spec, params, config.json) of a checkpoint directory: compressed
    when its config has a ``quantization_config``, plain HF otherwise (the
    CLIs' rule)."""
    cfg = json.loads((Path(ckpt_dir) / "config.json").read_text())
    load = load_compressed_model if cfg.get("quantization_config") else load_hf_model
    spec, params = load(ckpt_dir, device=device)
    return spec, params, cfg


# ---------------------------------------------------------------------------
# params -> HF-named tensors (for saving)
# ---------------------------------------------------------------------------

def iter_model_linears(spec: ModelSpec, params: Dict[str, Any]):
    """Yield (hf_prefix, QuantLinear) pairs; an MoE layer yields its router
    and each expert of its stacks under per-expert prefixes, the module
    paths the reference's recipes target."""
    if spec.is_mla:
        attn_projs = (("q_a_proj", "q_b_proj") if spec.q_lora_rank else ("q_proj",)
                      ) + ("kv_a_proj_with_mqa", "kv_b_proj", "o_proj")
    else:
        attn_projs = ("q_proj", "k_proj", "v_proj", "o_proj")
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        for proj in attn_projs:
            yield f"{p}.self_attn.{proj}", layer[proj]
        if spec.layer_is_moe(i):
            moe = layer["moe"]
            yield f"{p}.mlp.gate", moe["router"]
            for proj in ("gate_proj", "up_proj", "down_proj"):
                el: ExpertLinears = moe[proj]
                for e in range(el.num_experts):
                    yield f"{p}.mlp.experts.{e}.{proj}", el.expert(e)
            if "shared_experts" in moe:
                for proj in ("gate_proj", "up_proj", "down_proj"):
                    yield f"{p}.mlp.shared_experts.{proj}", moe["shared_experts"][proj]
        else:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                yield f"{p}.mlp.{proj}", layer["mlp"][proj]
    if params.get("lm_head") is not None:
        yield "lm_head", params["lm_head"]


def save_hf_model(spec: ModelSpec, params: Dict[str, Any], out_dir: Union[str, Path],
                  max_shard_bytes: int = 5 * 1024**3) -> None:
    """Write params as a plain HF-format bf16 safetensors checkpoint."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tensors = model_plain_tensors(spec, params)
    for prefix, lin in iter_model_linears(spec, params):
        tensors[f"{prefix}.weight"] = lin.dequantize(torch.bfloat16).t()
        if lin.bias is not None:
            tensors[f"{prefix}.bias"] = lin.bias.to(torch.bfloat16)
    w = ShardedWriter(out, max_shard_bytes=max_shard_bytes)
    w.add_many(tensors)
    w.finalize(metadata={"format": "pt"})
    dump_json(spec.to_hf_config(), out / "config.json")


def model_plain_tensors(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """All non-linear tensors under their HF names (for checkpoint writing)."""
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = layer["input_layernorm"]
        out[f"{p}.post_attention_layernorm.weight"] = layer["post_attention_layernorm"]
        if spec.qk_norm:
            out[f"{p}.self_attn.q_norm.weight"] = layer["q_norm"]
            out[f"{p}.self_attn.k_norm.weight"] = layer["k_norm"]
        if spec.is_mla:
            if spec.q_lora_rank:
                out[f"{p}.self_attn.q_a_layernorm.weight"] = layer["q_a_layernorm"]
            out[f"{p}.self_attn.kv_a_layernorm.weight"] = layer["kv_a_layernorm"]
        if spec.layer_is_moe(i) and "e_score_correction_bias" in layer["moe"]:
            out[f"{p}.mlp.gate.e_score_correction_bias"] = (
                layer["moe"]["e_score_correction_bias"].float())
    return out
