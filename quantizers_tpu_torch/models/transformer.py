"""Decoder-only transformer over QuantLinear weights, dense and MoE, in PyTorch.

Counterpart of ``quantizers_tpu/models/transformer.py``. Params are a plain
dict, ``{"embed", "layers": [per-layer dict...], "final_norm", "lm_head"}``,
with every projection a :class:`~quantizers_tpu_torch.ops.linear.QuantLinear`
and, in an MoE layer, a ``"moe"`` dict of router and expert stacks
(:mod:`.moe`).
The rounding points follow the JAX package: norms in f32 then cast, rope
tables cast to the activation dtype, SiLU in f32 then cast, f32
accumulation in every product.

Unlike the JAX package, the KV cache is updated in place: prefill and the
decode kernel write into the caller's buffers and advance ``length``.
Clone a cache (:meth:`KVCache.clone`) to replay a decode from one start.
A forward without a cache attends through the flash kernel
(:mod:`~quantizers_tpu_torch.ops.flash`) where the JAX package does.
MLA models wait for their port slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.dispatch import matmul_f32acc
from ..ops.linear import QuantLinear, concat_linears, dense_linear
from .config import ModelSpec
from .moe import ExpertLinears, moe_forward


def _no_mla(spec: ModelSpec) -> None:
    if spec.is_mla:
        raise NotImplementedError("MLA models are not ported yet: ROADMAP queue 1, slice 5")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., T) -> cos/sin (..., T, head_dim/2) f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); HF rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache, head-major ``(B, n_kv, S_max, head_dim)`` bf16,
    with per-row fill lengths ``length`` (B,) int32. Updated in place.

    Right-padded prefill writes junk at slots ``[len_row, T_pad)``; every
    later decode step writes its token at exactly ``length`` before
    attention admits that position, so junk is overwritten before it is
    visible."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def init(cls, spec: ModelSpec, batch: int, max_len: int,
             device: DeviceLike = None) -> List["KVCache"]:
        """Zeroed bf16 caches, one per layer. (The fp8 cache of the JAX
        package waits for ROADMAP queue 1, slice 5.)"""
        _no_mla(spec)
        dev = resolve_device(device)
        (hk, dk), (hv, dv) = spec.kv_cache_dims()
        return [cls(k=torch.zeros((batch, hk, max_len, dk), dtype=torch.bfloat16, device=dev),
                    v=torch.zeros((batch, hv, max_len, dv), dtype=torch.bfloat16, device=dev),
                    length=torch.zeros((batch,), dtype=torch.int32, device=dev))
                for _ in range(spec.num_layers)]

    def clone(self) -> "KVCache":
        return KVCache(k=self.k.clone(), v=self.v.clone(), length=self.length.clone())


def _store(cache_arr: torch.Tensor, new: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write new (B, T, KV, hd) into the head-major cache (B, KV, S, hd) at
    per-row offsets, in place. Like ``dynamic_update_slice``, a start that
    would run past the end is moved back so the T rows fit."""
    B, T = new.shape[:2]
    S = cache_arr.shape[2]
    start = offsets.long().clamp(min=0, max=S - T)
    pos = start[:, None] + torch.arange(T, device=new.device)[None, :]  # (B, T)
    rows = torch.arange(B, device=new.device)[:, None]
    cache_arr[rows, :, pos] = new.to(cache_arr.dtype)


def _read(cache_arr: torch.Tensor, dtype) -> torch.Tensor:
    return cache_arr if cache_arr.dtype == dtype else cache_arr.to(dtype)


def _cache_and_mask(cache: Optional[KVCache], k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[KVCache]]:
    """Append new k/v (B, T, KV, hd) to the cache in place and build the
    causal mask over the key axis. Returns ``(k_att, v_att, mask (B|1, T, S),
    cache)`` with k_att/v_att head-major (B, KV, S, hd)."""
    T = k.shape[1]
    if cache is not None:
        _store(cache.k, k, cache.length)
        _store(cache.v, v, cache.length)
        cache.length += T
        k_att, v_att = _read(cache.k, dtype), _read(cache.v, dtype)
        kv_pos = torch.arange(k_att.shape[2], device=k.device)[None, :]
        mask = kv_pos[None, :, :] <= positions[:, :, None]  # (B, T, S)
        return k_att, v_att, mask, cache
    idx = torch.arange(T, device=k.device)
    mask = idx[None, :, None] >= idx[None, None, :]  # (1, T, T) causal
    return k.transpose(1, 2), v.transpose(1, 2), mask, None


# ---------------------------------------------------------------------------
# attention + mlp blocks
# ---------------------------------------------------------------------------

def attention(layer: Dict[str, Any], spec: ModelSpec, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[KVCache]
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, T, D) post-layernorm -> (attn_out (B, T, D), cache)."""
    from ..ops import flash, kernels

    B, T, _ = x.shape
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if "qkv_proj" in layer:
        qkv = layer["qkv_proj"].apply(x)
        q = qkv[..., : H * hd].reshape(B, T, H, hd)
        k = qkv[..., H * hd: (H + KV) * hd].reshape(B, T, KV, hd)
        v = qkv[..., (H + KV) * hd:].reshape(B, T, KV, hd)
    else:
        q = layer["q_proj"].apply(x).reshape(B, T, H, hd)
        k = layer["k_proj"].apply(x).reshape(B, T, KV, hd)
        v = layer["v_proj"].apply(x).reshape(B, T, KV, hd)

    if spec.qk_norm:
        q = rms_norm(q, layer["q_norm"], spec.rms_norm_eps)
        k = rms_norm(k, layer["k_norm"], spec.rms_norm_eps)
    cos, sin = rotary_cos_sin(positions, hd, spec.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    rep = H // KV
    sm_scale = 1.0 / math.sqrt(hd)
    q4 = q[:, 0].reshape(B, KV, rep, hd) if T == 1 else None
    if (cache is not None and T == 1
            and kernels.decode_reason(q4, cache.k, cache.v) is None):
        # decode fast path: the kernel writes the new row into the cache in
        # place (assumes positions == cache.length, the decode invariant)
        ctx4 = kernels.decode_attention(q4, k[:, 0], v[:, 0], cache.k, cache.v,
                                        cache.length, sm_scale)
        cache.length += 1
        return layer["o_proj"].apply(ctx4.reshape(B, 1, H * hd)), cache

    k_att, v_att, mask, cache = _cache_and_mask(cache, k, v, positions, x.dtype)
    if cache is None and T > 1:
        # the no-cache forward (perplexity, calibration): blockwise flash
        # attention keeps memory linear in T, where the JAX package's tiling
        # takes the shape; the einsum below for the rest
        qh = q.transpose(1, 2)
        if flash.flash_reason(qh, k_att, v_att) is None:
            ctx = flash.flash_attention(qh, k_att, v_att, sm_scale)
            return layer["o_proj"].apply(ctx.transpose(1, 2).reshape(B, T, H * hd)), None
    # GQA without repeating KV: fold the head group into the query side
    qg = q.reshape(B, T, KV, rep, hd)
    scores = torch.einsum("btkrd,bksd->bkrts", qg.float(), k_att.float()) * sm_scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkrts,bksd->btkrd", probs.float(), v_att.float()).to(x.dtype)
    return layer["o_proj"].apply(ctx.reshape(B, T, H * hd)), cache


def dense_mlp(mlp: Dict[str, QuantLinear], x: torch.Tensor) -> torch.Tensor:
    if "gateup_proj" in mlp:
        g, u = torch.chunk(mlp["gateup_proj"].apply(x), 2, dim=-1)
    else:
        g = mlp["gate_proj"].apply(x)
        u = mlp["up_proj"].apply(x)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return mlp["down_proj"].apply(h)


# ---------------------------------------------------------------------------
# layer / model forward
# ---------------------------------------------------------------------------

def apply_layer(layer: Dict[str, Any], spec: ModelSpec, layer_idx: int,
                x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[KVCache] = None, moe_all_experts: bool = False
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One decoder block. ``moe_all_experts`` sends an MoE layer's tokens
    through the loop over every expert even when few."""
    _no_mla(spec)
    h = rms_norm(x, layer["input_layernorm"], spec.rms_norm_eps)
    attn_out, cache = attention(layer, spec, h, positions, cache)
    x = x + attn_out
    h = rms_norm(x, layer["post_attention_layernorm"], spec.rms_norm_eps)
    if spec.layer_is_moe(layer_idx):
        return x + moe_forward(layer["moe"], spec, h, all_experts=moe_all_experts), cache
    return x + dense_mlp(layer["mlp"], h), cache


def embed(params: Dict[str, Any], input_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["embed"].to(dtype)[input_ids.long()]


def logits_head(params: Dict[str, Any], spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    head = params.get("lm_head")
    if head is not None:
        out = head.apply(x)
        orig_n = head.meta_dict.get("orig_n")  # vocab-padded head: slice
        return out if orig_n is None else out[..., :orig_n]
    # tied embeddings: f32 accumulation, then the activation dtype
    return matmul_f32acc(x, params["embed"].to(x.dtype).t())


def forward(params: Dict[str, Any], spec: ModelSpec, input_ids: torch.Tensor,
            caches: Optional[List[KVCache]] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
    """(B, T) ids -> (B, T, vocab) logits; caches are advanced in place."""
    B, T = input_ids.shape
    dev = input_ids.device
    if positions is None:
        if caches is not None:
            positions = caches[0].length.long()[:, None] + torch.arange(T, device=dev)[None, :]
        else:
            positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    x = embed(params, input_ids)
    for i, layer in enumerate(params["layers"]):
        x, _ = apply_layer(layer, spec, i, x, positions,
                           caches[i] if caches is not None else None)
    return logits_head(params, spec, x), caches


# ---------------------------------------------------------------------------
# serving-time transforms
# ---------------------------------------------------------------------------

def fuse_for_decode(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse same-input projections (q/k/v -> qkv_proj, gate/up ->
    gateup_proj) into single QuantLinears: 4 matmul launches per layer
    instead of 7. Parts of different kinds or layouts stay unfused; MoE
    layers keep their expert stacks (``moe_w8pc_layout`` fuses those)."""
    _no_mla(spec)
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        lyr = dict(layer)
        if "q_proj" in lyr:
            try:
                lyr["qkv_proj"] = concat_linears([lyr["q_proj"], lyr["k_proj"], lyr["v_proj"]])
                del lyr["q_proj"], lyr["k_proj"], lyr["v_proj"]
            except ValueError:
                pass
        if "mlp" in lyr and "gate_proj" in lyr["mlp"]:
            mlp = dict(lyr["mlp"])
            try:
                mlp["gateup_proj"] = concat_linears([mlp["gate_proj"], mlp["up_proj"]])
                del mlp["gate_proj"], mlp["up_proj"]
                lyr["mlp"] = mlp
            except ValueError:
                pass
        layers.append(lyr)
    out["layers"] = layers
    return out


def quantize_lm_head(spec: ModelSpec, params: Dict[str, Any],
                     num_bits: int = 8) -> Dict[str, Any]:
    """Quantize the logits head (per-channel symmetric int8 by default).

    The vocab axis is padded to a multiple of 1536 when that adds under 5%,
    as the JAX package does: padded columns have scale 0 and are sliced off
    in :func:`logits_head` through the explicit ``orig_n`` meta."""
    from ..core.numerics import quantize
    from ..core.scheme import QuantizationArgs, QuantStrategy, QuantType
    from ..ops.linear import from_quantized

    bias = None
    if params.get("lm_head") is not None:
        w_vd = params["lm_head"].dequantize(torch.float32).t()  # (V, D)
        bias = params["lm_head"].bias
    else:
        w_vd = params["embed"].float()
    args = QuantizationArgs(num_bits=num_bits, type=QuantType.INT,
                            symmetric=True, strategy=QuantStrategy.CHANNEL)
    lin = from_quantized(quantize(w_vd, args), args, bias=bias)
    del w_vd
    V = lin.meta_dict["n"]
    pad = (-V) % 1536
    if pad and pad / V < 0.05:
        F = torch.nn.functional
        lin = QuantLinear(
            kind=lin.kind,
            weight=F.pad(lin.weight, (0, pad)),
            scale=F.pad(lin.scale, (0, pad)),
            bias=None if lin.bias is None else F.pad(lin.bias, (0, pad)),
            meta=tuple(("n", V + pad) if k_ == "n" else (k_, v_) for k_, v_ in lin.meta)
            + (("orig_n", V),))
    out = dict(params)
    out["lm_head"] = lin
    return out


def tree_to(tree: Any, device: torch.device) -> Any:
    """The params tree with every tensor on ``device`` (no copy where it
    already is)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, (QuantLinear, ExpertLinears, torch.Tensor)):
        return tree.to(device)
    return tree


# ---------------------------------------------------------------------------
# initialization (random weights: tests, dry runs)
# ---------------------------------------------------------------------------

def init_params(spec: ModelSpec, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random dense (bf16) params made on ``device`` from a seeded
    ``torch.Generator`` (its numbers differ from ``jax.random``'s for the
    same seed). MoE layers get an f32 router and bf16 expert stacks."""
    _no_mla(spec)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, Ff = spec.hidden_size, spec.intermediate_size

    def rand_linear(n: int, k: int, bias: bool = False, dtype=torch.bfloat16) -> QuantLinear:
        w = torch.randn((n, k), generator=gen, device=dev) * 0.02
        b = torch.zeros((n,), device=dev) if bias else None
        return dense_linear(w, bias=b, dtype=dtype)

    def experts(n: int, k: int) -> ExpertLinears:
        return ExpertLinears.stack([rand_linear(n, k) for _ in range(spec.num_experts)])

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    layers: List[Dict[str, Any]] = []
    for i in range(spec.num_layers):
        layer: Dict[str, Any] = {
            "input_layernorm": ones(D),
            "post_attention_layernorm": ones(D),
            "q_proj": rand_linear(spec.q_dim, D, spec.attention_bias),
            "k_proj": rand_linear(spec.kv_dim, D, spec.attention_bias),
            "v_proj": rand_linear(spec.kv_dim, D, spec.attention_bias),
            "o_proj": rand_linear(D, spec.q_dim),
        }
        if spec.layer_is_moe(i):
            E, Fe = spec.num_experts, spec.moe_intermediate_size
            moe: Dict[str, Any] = {
                "router": rand_linear(E, D, dtype=torch.float32),
                "gate_proj": experts(Fe, D), "up_proj": experts(Fe, D),
                "down_proj": experts(D, Fe)}
            if spec.scoring_func == "sigmoid":
                moe["e_score_correction_bias"] = torch.zeros((E,), device=dev)
            if spec.num_shared_experts:
                Fs = Fe * spec.num_shared_experts
                moe["shared_experts"] = {"gate_proj": rand_linear(Fs, D),
                                         "up_proj": rand_linear(Fs, D),
                                         "down_proj": rand_linear(D, Fs)}
            layer["moe"] = moe
        else:
            layer["mlp"] = {
                "gate_proj": rand_linear(Ff, D, spec.mlp_bias),
                "up_proj": rand_linear(Ff, D, spec.mlp_bias),
                "down_proj": rand_linear(D, Ff, spec.mlp_bias),
            }
        if spec.qk_norm:
            layer["q_norm"] = ones(spec.head_dim)
            layer["k_norm"] = ones(spec.head_dim)
        layers.append(layer)
    embed_w = (torch.randn((spec.vocab_size, D), generator=gen, device=dev)
               .to(torch.bfloat16) * 0.02)
    return {
        "embed": embed_w,
        "layers": layers,
        "final_norm": ones(D),
        "lm_head": None if spec.tie_word_embeddings else rand_linear(spec.vocab_size, D),
    }
