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
decode kernels write into the caller's buffers and advance ``length``.
Clone a cache (:meth:`KVCache.clone`) to replay a decode from one start.
A forward without a cache attends through the flash kernel
(:mod:`~quantizers_tpu_torch.ops.flash`) where the JAX package does.

``apply_layer(..., capture=dict)`` fills the dict with each linear's input
(keyed by projection name), the post-rope K and V an FP8 KV cache would
store (``k_cache`` / ``v_cache``) and the MoE block's routing inputs, under
the JAX package's keys: the activation feed of the calibration engine
(:mod:`~quantizers_tpu_torch.oneshot`). Keys whose inputs are one tensor
hold the same tensor object (q/k/v, gate/up).

MLA models (DeepSeek-V2/V3, GLM-Flash) keep the latent cache of the
absorbed form: one shared (c_kv, rope-k) row per token; their one-token
decode step runs the MLA decode kernel, their cached prefill the absorbed
einsum, and their no-cache forward the expanded heads through the flash
kernel, each where the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops._launch import records_grad
from ..ops.dispatch import matmul_f32acc
from ..ops.linear import QuantLinear, _is_shard_wrapper, concat_linears, dense_linear
from .config import ModelSpec
from .moe import ExpertLinears, moe_forward

#: the largest finite float8_e4m3fn value, where the fp8 KV cache saturates
E4M3_MAX = 448.0

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


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-MLA rope: channels stored interleaved (even/odd pairs); the
    output is de-interleaved, alike for q and k, as in the JAX package."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _einsum_f32acc(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of bf16 operands with f32 sums, in ``a``'s dtype (on the
    card in bf16, whose products cuBLAS sums in f32; on the CPU widened to
    f32 first), like :func:`~quantizers_tpu_torch.ops.dispatch.matmul_f32acc`."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.einsum(eq, a16, b16).to(a.dtype)
    return torch.einsum(eq, a16.float(), b16.float()).to(a.dtype)


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache, head-major ``(B, n_kv, S_max, head_dim)``, with
    per-row fill lengths ``length`` (B,) int32. Updated in place. An MLA
    model's cache is its latent cache (``ModelSpec.kv_cache_dims``).

    ``k_scale`` / ``v_scale`` (0-d f32) mark the FP8 KV cache: k and v are
    stored as float8_e4m3fn, divided by their scale on the way in and
    multiplied by it on the way out.

    Right-padded prefill writes junk at slots ``[len_row, T_pad)``; every
    later decode step writes its token at exactly ``length`` before
    attention admits that position, so junk is overwritten before it is
    visible."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def init(cls, spec: ModelSpec, batch: int, max_len: int, device: DeviceLike = None,
             fp8: bool = False, k_scale: float = 1.0, v_scale: float = 1.0
             ) -> List["KVCache"]:
        """Zeroed caches, one per layer: bf16, or float8_e4m3fn with the
        given scales (``fp8``)."""
        dev = resolve_device(device)
        (hk, dk), (hv, dv) = spec.kv_cache_dims()
        dtype = torch.float8_e4m3fn if fp8 else torch.bfloat16

        def scale(v: float) -> Optional[torch.Tensor]:
            return torch.tensor(v, dtype=torch.float32, device=dev) if fp8 else None

        return [cls(k=torch.zeros((batch, hk, max_len, dk), dtype=dtype, device=dev),
                    v=torch.zeros((batch, hv, max_len, dv), dtype=dtype, device=dev),
                    length=torch.zeros((batch,), dtype=torch.int32, device=dev),
                    k_scale=scale(k_scale), v_scale=scale(v_scale))
                for _ in range(spec.num_layers)]

    def clone(self) -> "KVCache":
        return dataclasses.replace(self, k=self.k.clone(), v=self.v.clone(),
                                   length=self.length.clone())


def _store(cache_arr: torch.Tensor, new: torch.Tensor, offsets: torch.Tensor,
           scale: Optional[torch.Tensor] = None) -> None:
    """Write new (B, T, KV, hd) into the head-major cache (B, KV, S, hd) at
    per-row offsets, in place (an fp8 cache takes ``new / scale``, saturated
    to the E4M3 range: values past +-448, infinities included, store as
    +-448, and NaN stays NaN). Like ``dynamic_update_slice``, a start that
    would run past the end is moved back so the T rows fit."""
    B, T = new.shape[:2]
    S = cache_arr.shape[2]
    start = offsets.long().clamp(min=0, max=S - T)
    pos = start[:, None] + torch.arange(T, device=new.device)[None, :]  # (B, T)
    rows = torch.arange(B, device=new.device)[:, None]
    if scale is not None:
        new = new.float() / scale
    if cache_arr.dtype == torch.float8_e4m3fn:
        # an explicit rule: the cast's own handling of out-of-range values
        # is not the same on every device
        new = new.float().clamp(-E4M3_MAX, E4M3_MAX)
    cache_arr[rows, :, pos] = new.to(cache_arr.dtype)


def _read(cache_arr: torch.Tensor, scale: Optional[torch.Tensor], dtype) -> torch.Tensor:
    if scale is None:
        return cache_arr if cache_arr.dtype == dtype else cache_arr.to(dtype)
    return (cache_arr.float() * scale).to(dtype)


def _cache_and_mask(cache: Optional[KVCache], k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[KVCache]]:
    """Append new k/v (B, T, KV, hd) to the cache in place and build the
    causal mask over the key axis. Returns ``(k_att, v_att, mask (B|1, T, S),
    cache)`` with k_att/v_att head-major (B, KV, S, hd)."""
    T = k.shape[1]
    if cache is not None:
        _store(cache.k, k, cache.length, cache.k_scale)
        _store(cache.v, v, cache.length, cache.v_scale)
        cache.length += T
        k_att, v_att = _read(cache.k, cache.k_scale, dtype), _read(cache.v, cache.v_scale, dtype)
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
              positions: torch.Tensor, cache: Optional[KVCache],
              capture: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, T, D) post-layernorm -> (attn_out (B, T, D), cache).

    Under tensor parallelism ``spec`` is the rank's own
    (:func:`~quantizers_tpu_torch.parallel.mesh.local_spec`): its heads and
    KV heads, which its q/k/v shards and its cache hold, and o_proj is a
    row-parallel shard whose ``apply`` sums the ranks' outputs."""
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
    if capture is not None:
        # post-rope K and V: what an FP8 KV cache would store
        capture["k_cache"] = k
        capture["v_cache"] = v

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
        ctx = ctx4.reshape(B, 1, H * hd)
        if capture is not None:
            capture["o_proj"] = ctx
        return layer["o_proj"].apply(ctx), cache

    k_att, v_att, mask, cache = _cache_and_mask(cache, k, v, positions, x.dtype)
    if cache is None and T > 1:
        # the no-cache forward (perplexity, calibration): blockwise flash
        # attention keeps memory linear in T, where the JAX package's tiling
        # takes the shape; the einsum below for the rest, and wherever
        # autograd records (fit_lm): the kernel has no backward, nor has the
        # JAX package's, whose fit_lm runs only where the einsum does
        qh = q.transpose(1, 2)
        if not records_grad(qh, k_att, v_att) and flash.flash_reason(qh, k_att, v_att) is None:
            ctx = flash.flash_attention(qh, k_att, v_att, sm_scale).transpose(1, 2)
            ctx = ctx.reshape(B, T, H * hd)
            if capture is not None:
                capture["o_proj"] = ctx
            return layer["o_proj"].apply(ctx), None
    # GQA without repeating KV: fold the head group into the query side
    qg = q.reshape(B, T, KV, rep, hd)
    scores = torch.einsum("btkrd,bksd->bkrts", qg.float(), k_att.float()) * sm_scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkrts,bksd->btkrd", probs.float(), v_att.float()).to(x.dtype)
    ctx = ctx.reshape(B, T, H * hd)
    if capture is not None:
        capture["o_proj"] = ctx
    return layer["o_proj"].apply(ctx), cache


def mla_attention(layer: Dict[str, Any], spec: ModelSpec, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[KVCache],
                  capture: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Multi-head Latent Attention (DeepSeek-V2/V3, GLM-Flash), x (B, T, D)
    post-layernorm -> (attn_out (B, T, D), cache).

    Without a cache the heads are expanded (kv_b_proj) and attend through
    the flash kernel, the 192-wide qk head padded with zeros to 256, where
    the JAX package's flash takes the shape; else the einsum. With a cache,
    attention runs in the latent space (the absorbed form): scores_h =
    (W_uk_h^T q_nope_h) . c + q_pe_h . k_pe, ctx_h = W_uv_h (p . C); a
    one-token step goes through the MLA decode kernel, which writes the new
    latent row in place, and other steps (prefill, an fp8 cache) through
    the same math as einsums over the stored prefix.

    ``capture`` takes the inputs of q_b_proj, kv_b_proj and o_proj and, on
    the no-cache path, what the latent cache stores: ``k_cache`` the latent
    c_kv, ``v_cache`` the shared post-rope k_pe row (B, T, 1, dr)."""
    from ..ops import flash, kernels

    B, T, _ = x.shape
    H = spec.num_heads
    dn, dr, dv = spec.qk_nope_head_dim, spec.qk_rope_head_dim, spec.v_head_dim
    dq, r, eps = dn + dr, spec.kv_lora_rank, spec.rms_norm_eps
    if spec.q_lora_rank:
        cq = rms_norm(layer["q_a_proj"].apply(x), layer["q_a_layernorm"], eps)
        if capture is not None:
            capture["q_b_proj"] = cq
        q = layer["q_b_proj"].apply(cq)
    else:
        q = layer["q_proj"].apply(x)
    q = q.reshape(B, T, H, dq)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = layer["kv_a_proj_with_mqa"].apply(x)  # (B, T, r + dr)
    c_kv = rms_norm(ckv[..., :r], layer["kv_a_layernorm"], eps)
    if capture is not None:
        capture["kv_b_proj"] = c_kv
    cos, sin = rotary_cos_sin(positions, dr, spec.rope_theta)
    q_pe = apply_rope_interleaved(q_pe, cos, sin)
    k_pe = apply_rope_interleaved(ckv[..., r:][:, :, None, :], cos, sin)  # (B, T, 1, dr)
    sm_scale = 1.0 / math.sqrt(dq)

    if cache is None:
        kv = layer["kv_b_proj"].apply(c_kv).reshape(B, T, H, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, T, H, dr)], dim=-1)
        if capture is not None:
            capture["k_cache"] = c_kv
            capture["v_cache"] = k_pe
        if T > 1:
            pad = -(-dq // 128) * 128 - dq  # zero channels add nothing to a score
            qp = F.pad(q_full.transpose(1, 2), (0, pad))
            kp = F.pad(k.transpose(1, 2), (0, pad))
            vp = v.transpose(1, 2)
            if not records_grad(qp, kp, vp) and flash.flash_reason(qp, kp, vp) is None:
                ctx = flash.flash_attention(qp, kp, vp, sm_scale).transpose(1, 2)
                ctx = ctx.reshape(B, T, H * dv)
                if capture is not None:
                    capture["o_proj"] = ctx
                return layer["o_proj"].apply(ctx), None
        idx = torch.arange(T, device=x.device)
        mask = idx[:, None] >= idx[None, :]  # (T, T) causal
        scores = torch.einsum("bthd,bshd->bhts", q_full.float(), k.float()) * sm_scale
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(x.dtype)
        ctx = ctx.reshape(B, T, H * dv)
        if capture is not None:
            capture["o_proj"] = ctx
        return layer["o_proj"].apply(ctx), None

    # the cached path: latent rows, absorbed attention
    w_uk_t, w_uv = _mla_absorb_weights(layer, spec, x.dtype)
    rope_pad = cache.v.shape[3]
    pe_row = F.pad(k_pe, (0, rope_pad - dr))  # (B, T, 1, rope_pad)
    q_abs = _einsum_f32acc("bthd,hdr->bthr", q_nope, w_uk_t)
    if T == 1:
        qa, qp = q_abs[:, 0], F.pad(q_pe[:, 0], (0, rope_pad - dr))
        if kernels.mla_decode_reason(qa, qp, cache.k, cache.v) is None:
            # the kernel writes the new latent row in place (assumes
            # positions == cache.length, the decode invariant)
            ctx_lat = kernels.mla_decode_attention(qa, qp, c_kv[:, 0], pe_row[:, 0, 0],
                                                   cache.k, cache.v, cache.length, sm_scale)
            cache.length += 1
            ctx = _einsum_f32acc("bhr,hrv->bhv", ctx_lat, w_uv).reshape(B, 1, H * dv)
            return layer["o_proj"].apply(ctx), cache

    _store(cache.k, c_kv[:, :, None, :], cache.length, cache.k_scale)
    _store(cache.v, pe_row, cache.length, cache.v_scale)
    cache.length += T
    c_read = _read(cache.k, cache.k_scale, x.dtype)[:, 0]  # (B, S, r)
    p_read = _read(cache.v, cache.v_scale, x.dtype)[:, 0, :, :dr]
    kv_pos = torch.arange(c_read.shape[1], device=x.device)
    mask = kv_pos[None, None, :] <= positions[:, :, None]  # (B, T, S)
    scores = (torch.einsum("bthr,bsr->bhts", q_abs.float(), c_read.float())
              + torch.einsum("bthd,bsd->bhts", q_pe.float(), p_read.float())) * sm_scale
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhts,bsr->bthr", probs.float(), c_read.float()).to(x.dtype)
    ctx = _einsum_f32acc("bthr,hrv->bthv", ctx_lat, w_uv).reshape(B, T, H * dv)
    return layer["o_proj"].apply(ctx), cache


def mla_absorb_layout(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, Any]:
    """Add the absorbed-decode weights (``mla_absorb``: ``w_uk_t``
    (H, dn, r) and ``w_uv`` (H, r, dv), bf16) to every MLA layer that lacks
    them, so that no step dequantizes kv_b_proj again. A no-op for other
    specs and for params that have them."""
    if not spec.is_mla:
        return params
    out = dict(params)
    layers = []
    for lyr in params["layers"]:
        if "kv_b_proj" in lyr and "mla_absorb" not in lyr:
            lyr = dict(lyr)
            w_uk_t, w_uv = _mla_absorb_weights(lyr, spec, torch.bfloat16)
            lyr["mla_absorb"] = {"w_uk_t": w_uk_t, "w_uv": w_uv}
        layers.append(lyr)
    out["layers"] = layers
    return out


def _mla_absorb_weights(layer: Dict[str, Any], spec: ModelSpec, dtype
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_uk^T (H, dn, r), W_uv (H, r, dv)) from ``mla_absorb`` where the
    layout put them, else derived from kv_b_proj."""
    ab = layer.get("mla_absorb")
    if ab is not None:
        return ab["w_uk_t"].to(dtype), ab["w_uv"].to(dtype)
    dn = spec.qk_nope_head_dim
    dv = spec.v_head_dim or spec.head_dim
    w = layer["kv_b_proj"].dequantize(dtype)  # (r, H * (dn + dv))
    w = w.reshape(w.shape[0], spec.num_heads, dn + dv)
    return w[..., :dn].permute(1, 2, 0).contiguous(), w[..., dn:].permute(1, 0, 2).contiguous()


def dense_mlp(mlp: Dict[str, QuantLinear], x: torch.Tensor,
              capture: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    if "gateup_proj" in mlp:
        g, u = torch.chunk(mlp["gateup_proj"].apply(x), 2, dim=-1)
    else:
        g = mlp["gate_proj"].apply(x)
        u = mlp["up_proj"].apply(x)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    if capture is not None:
        capture["down_proj"] = h
    return mlp["down_proj"].apply(h)


# ---------------------------------------------------------------------------
# layer / model forward
# ---------------------------------------------------------------------------

def apply_layer(layer: Dict[str, Any], spec: ModelSpec, layer_idx: int,
                x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[KVCache] = None, moe_all_experts: bool = False,
                capture: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One decoder block. ``moe_all_experts`` sends an MoE layer's tokens
    through the loop over every expert even when few. ``capture``, when a
    dict, is filled with the inputs of each linear (keyed by projection
    name): the activation feed of the calibration observers."""
    h = rms_norm(x, layer["input_layernorm"], spec.rms_norm_eps)
    if capture is not None:
        keys = (("q_a_proj" if spec.q_lora_rank else "q_proj", "kv_a_proj_with_mqa")
                if spec.is_mla else ("q_proj", "k_proj", "v_proj"))
        capture.update(dict.fromkeys(keys, h))
    attend = mla_attention if spec.is_mla else attention
    attn_out, cache = attend(layer, spec, h, positions, cache, capture)
    x = x + attn_out
    h = rms_norm(x, layer["post_attention_layernorm"], spec.rms_norm_eps)
    if spec.layer_is_moe(layer_idx):
        if capture is not None:
            capture["moe_in"] = h
        return x + moe_forward(layer["moe"], spec, h, all_experts=moe_all_experts,
                               capture=capture), cache
    if capture is not None:
        capture.update(dict.fromkeys(("gate_proj", "up_proj"), h))
    return x + dense_mlp(layer["mlp"], h, capture), cache


def embed(params: Dict[str, Any], input_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["embed"].to(dtype)[input_ids.long()]


def logits_head(params: Dict[str, Any], spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the logits. A column-parallel head (a rank's
    :class:`~quantizers_tpu_torch.parallel.collectives.ColumnGather`)
    gathers its ranks' columns; a tied or replicated head computes them
    all on every rank, from the same hidden state."""
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
            positions: Optional[torch.Tensor] = None,
            moe_all_experts: bool = False
            ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
    """(B, T) ids -> (B, T, vocab) logits; caches are advanced in place.
    ``moe_all_experts`` runs every MoE layer through its loop over all
    experts (:func:`apply_layer`)."""
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
                           caches[i] if caches is not None else None, moe_all_experts)
    return logits_head(params, spec, x), caches


# ---------------------------------------------------------------------------
# serving-time transforms
# ---------------------------------------------------------------------------

def fuse_for_decode(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse same-input projections (q/k/v -> qkv_proj, gate/up ->
    gateup_proj) into single QuantLinears: 4 matmul launches per layer
    instead of 7. Parts of different kinds or layouts stay unfused; MoE
    layers keep their expert stacks (``moe_w8pc_layout`` fuses those). MLA
    layers keep their attention projections and gain the absorbed-decode
    weights (:func:`mla_absorb_layout`)."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        lyr = dict(layer)
        if "q_proj" in lyr and not spec.is_mla:
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
    return mla_absorb_layout(spec, out)


def quantize_lm_head(spec: ModelSpec, params: Dict[str, Any],
                     num_bits: int = 8) -> Dict[str, Any]:
    """Quantize the logits head (per-channel symmetric int8 by default).

    The vocab axis is padded to a multiple of 1536 when that adds under 5%,
    as the JAX package does: padded columns have scale 0 and are sliced off
    in :func:`logits_head` through the explicit ``orig_n`` meta."""
    from ..core.numerics import quantize
    from ..core.scheme import QuantizationArgs, QuantStrategy, QuantType
    from ..ops.linear import from_quantized

    head = params.get("lm_head")
    if _is_shard_wrapper(head):
        # a rank's columns of a column-parallel head: per-channel scales
        # quantize each column on its own, so the rank quantizes its shard
        inner = quantize_lm_head(spec, dict(params, lm_head=head.shard), num_bits)["lm_head"]
        return dict(params, lm_head=head.with_shard(inner))
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
    if isinstance(tree, (QuantLinear, ExpertLinears, torch.Tensor)) or _is_shard_wrapper(tree):
        return tree.to(device)
    return tree


# ---------------------------------------------------------------------------
# initialization (random weights: tests, dry runs)
# ---------------------------------------------------------------------------

def init_params(spec: ModelSpec, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random dense (bf16) params made on ``device`` from a seeded
    ``torch.Generator`` (its numbers differ from ``jax.random``'s for the
    same seed). MoE layers get an f32 router and bf16 expert stacks; MLA
    layers the low-rank attention projections."""
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
        }
        if spec.is_mla:
            H, dq = spec.num_heads, spec.qk_head_dim
            if spec.q_lora_rank:
                layer["q_a_proj"] = rand_linear(spec.q_lora_rank, D)
                layer["q_a_layernorm"] = ones(spec.q_lora_rank)
                layer["q_b_proj"] = rand_linear(H * dq, spec.q_lora_rank)
            else:
                layer["q_proj"] = rand_linear(H * dq, D)
            layer["kv_a_proj_with_mqa"] = rand_linear(spec.kv_lora_rank + spec.qk_rope_head_dim, D)
            layer["kv_a_layernorm"] = ones(spec.kv_lora_rank)
            layer["kv_b_proj"] = rand_linear(H * (spec.qk_nope_head_dim + spec.v_head_dim),
                                             spec.kv_lora_rank)
            layer["o_proj"] = rand_linear(D, H * spec.v_head_dim)
        else:
            layer.update({
                "q_proj": rand_linear(spec.q_dim, D, spec.attention_bias),
                "k_proj": rand_linear(spec.kv_dim, D, spec.attention_bias),
                "v_proj": rand_linear(spec.kv_dim, D, spec.attention_bias),
                "o_proj": rand_linear(D, spec.q_dim),
            })
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
