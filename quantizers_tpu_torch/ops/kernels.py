"""The serving path's CUDA kernels: wrappers, plain versions, launch counts.

Each wrapper checks what its kernel takes and raises
:class:`KernelUnsupported` on anything else, before any launch. Given CPU
tensors it computes the kernel's plain PyTorch version; given CUDA tensors
it launches the kernel (``csrc/*.cu``, built by :mod:`._build`) on the
current stream and raises if the launch fails. It adds one to its
``launches`` count where it launches, and nowhere else.

* :func:`w4_matmul` replaces ``quantizers_tpu/ops/kernels.py``
  ``_w4_matmul_2d`` and ``_w4i_matmul_2d`` (W4A16, group scales);
* :func:`w8_matmul` replaces ``_w8_matmul_2d`` (int8, channel or group,
  bf16 or f32 scales);
* :func:`decode_attention` replaces ``_decode_attention_call`` (one-token
  GQA attention with the new K/V row written into the cache in place);
* :func:`nvfp4_matmul` replaces ``_nvfp4_matmul_2d`` (packed E2M1 codes)
  and hands the int8-doubled layout to :func:`nvfp4_i8_matmul`, which
  replaces ``_nvfp4_i8_matmul_2d``;
* :func:`moe_slot_ffn` replaces ``_moe_slot_ffn_call`` (the gated FFN of
  routed expert slots over packed w4, packed E2M1 or int8-doubled E2M1
  stacks);
* :func:`moe_slot_gu_ffn` replaces ``_moe_slot_gu_call`` (the same over
  the fused int8 per-channel gate|up layout);
* :func:`fp8_matmul` replaces ``_fp8_matmul_2d`` (FP8 E4M3 weights with
  128 x 128 block scales, bf16 activations);
* :func:`mla_decode_attention` replaces ``_mla_decode_call`` (absorbed-MLA
  one-token attention over the latent cache, appended in place);
* :func:`~quantizers_tpu_torch.ops.flash.flash_attention` (module
  :mod:`.flash`) replaces ``quantizers_tpu/ops/flash.py`` ``_flash_call``
  (blockwise attention of the no-cache forward).

Importing this module needs neither ``nvcc`` nor a card: the library is
built at the first launch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._launch import KernelUnsupported, _count, _stream
from .flash import flash_attention
from .linear import QuantLinear, _unpack_fp4, _unpack_nibbles

#: head dim and largest query-group size the decode-attention kernel is built for
DECODE_HEAD_DIM = 128
DECODE_MAX_REP = 8
#: the largest latent width, padded rope width and cache length the MLA
#: decode kernel is built for (csrc/mla_decode_attention.cu)
MLA_MAX_RANK, MLA_MAX_ROPE, MLA_MAX_SLOTS = 1024, 256, 8192
#: the FP8 block the fp8 kernel takes (rows of K by columns of N)
FP8_BLOCK = 128


def _flatten_x(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, k).to(torch.bfloat16).contiguous(), lead


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


# ---------------------------------------------------------------------------
# W4A16: packed uint8 (K/2, N) split-half, value + 8; bf16 scales (K/g, N)
# ---------------------------------------------------------------------------

def _w4_reason(lin: QuantLinear) -> Optional[str]:
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md["group_size"])
    if lin.zero_point is not None:
        return "asymmetric w4 goes through the reference path"
    if k % (2 * g) or n % 128 or g % 2:
        return f"w4 kernel needs 2g|K and 128|N (k={k}, n={n}, g={g})"
    if (k // 2) % (8 * g):
        # the JAX kernel's K tiles are multiples of 8g packed rows
        return f"w4 kernel needs 8g | K/2 (k={k}, g={g})"
    if lin.weight.dtype != torch.uint8 or lin.scale.dtype != torch.bfloat16:
        return "w4 kernel takes packed uint8 weights with bf16 scales"
    return None


def w4_matmul_plain(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    g: int) -> torch.Tensor:
    """The w4 kernel's arithmetic in PyTorch: (code - 8) * scale in f32,
    f32 products and sums, bf16 out. x2 (M, K) -> (M, N)."""
    w = _unpack_nibbles(packed).float() * scale.float().repeat_interleave(g, dim=0)
    return (x2.float() @ w).to(torch.bfloat16)


@_count
def w4_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for a symmetric packed w4 linear -> (..., N)."""
    reason = _w4_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md["group_size"])
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = w4_matmul_plain(x2, lin.weight, lin.scale, g)
    elif x2.is_cuda:
        out = _launch_matmul("qtt_w4_matmul", w4_matmul, x2, lin, g)
    else:
        raise ValueError(f"w4_matmul: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


# ---------------------------------------------------------------------------
# W8: int8 (K, N); bf16 scales per channel (1, N) or per group (K/g, N)
# ---------------------------------------------------------------------------

def _w8_reason(lin: QuantLinear) -> Optional[str]:
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    g = md.get("group_size")
    if lin.zero_point is not None:
        return "asymmetric w8 goes through the reference path"
    if n % 128 or k % 256:
        return f"w8 kernel needs 128|N, 256|K (k={k}, n={n})"
    if g:
        quantum = max(8 * int(g), 256)
        if k % quantum or quantum % int(g):
            return f"w8 kernel: group {g} does not tile K={k}"
    if lin.weight.dtype != torch.int8 or lin.scale.dtype not in (torch.bfloat16, torch.float32):
        return "w8 kernel takes int8 weights with bf16 or f32 scales"
    return None


def w8_matmul_plain(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                    g: Optional[int]) -> torch.Tensor:
    """The w8 kernel's arithmetic in PyTorch: f32 products and sums, bf16 out."""
    s = scale.float()
    if g:
        s = s.repeat_interleave(int(g), dim=0)
    return (x2.float() @ (w8.float() * s)).to(torch.bfloat16)


@_count
def w8_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for a symmetric int8 linear -> (..., N)."""
    reason = _w8_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    g = md.get("group_size")
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = w8_matmul_plain(x2, lin.weight, lin.scale, g)
    elif x2.is_cuda:
        # a per-channel scale is one group spanning all of K
        entry = "qtt_w8_matmul_f32s" if lin.scale.dtype == torch.float32 else "qtt_w8_matmul"
        out = _launch_matmul(entry, w8_matmul, x2, lin, int(g) if g else k)
    else:
        raise ValueError(f"w8_matmul: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


def _launch_matmul(entry: str, wrapper: Callable, x2: torch.Tensor, lin: QuantLinear,
                   g: int) -> torch.Tensor:
    _check_cuda(entry, x2, lin.weight, lin.scale)
    lib = _build.load()
    m, k = x2.shape
    n = lin.weight.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = getattr(lib, entry)(x2.data_ptr(), lin.weight.data_ptr(), lin.scale.data_ptr(),
                              out.data_ptr(), m, k, n, g, _stream(x2.device))
    _build.check(err, entry)
    wrapper.launches += 1
    return out


# ---------------------------------------------------------------------------
# NVFP4: packed E2M1 uint8 (K/2, N) or int8-doubled (K, N); bf16 effective
# group scales (K/g, N), halved in the int8 layout
# ---------------------------------------------------------------------------

def _nvfp4_reason(lin: QuantLinear) -> Optional[str]:
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md.get("group_size", 16))
    if lin.zero_point is not None:
        return "asymmetric nvfp4 goes through the reference path"
    if k % (2 * g) or n % 128:
        return f"nvfp4 kernel needs 2g|K and 128|N (k={k}, n={n})"
    if lin.scale.dtype != torch.bfloat16:
        return "nvfp4 kernel takes bf16 scales"
    if lin.weight.dtype == torch.uint8:
        if (k // 2) % (8 * g):  # the JAX kernel's K tiles are multiples of 8g packed rows
            return f"nvfp4 kernel needs 8g | K/2 (k={k}, g={g})"
    elif lin.weight.dtype == torch.int8:
        if k % (8 * g):
            return f"nvfp4 int8 kernel needs 8g | K (k={k}, g={g})"
    else:
        return "nvfp4 kernel takes packed uint8 or int8-doubled weights"
    return None


def nvfp4_matmul_plain(x2: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                       g: int) -> torch.Tensor:
    """The NVFP4 kernels' arithmetic in PyTorch: value * scale in f32 (exact),
    rounded to bf16 once, f32 products and sums, bf16 out. x2 (M, K) -> (M, N)."""
    vals = weight.float() if weight.dtype == torch.int8 else _unpack_fp4(weight)
    w = (vals * scale.float().repeat_interleave(g, dim=0)).to(torch.bfloat16)
    return (x2.float() @ w.float()).to(torch.bfloat16)


def _nvfp4_call(x: torch.Tensor, lin: QuantLinear, entry: str, wrapper: Callable) -> torch.Tensor:
    reason = _nvfp4_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md.get("group_size", 16))
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = nvfp4_matmul_plain(x2, lin.weight, lin.scale, g)
    elif x2.is_cuda:
        out = _launch_matmul(entry, wrapper, x2, lin, g)
    else:
        raise ValueError(f"{wrapper.__name__}: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


@_count
def nvfp4_i8_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for an NVFP4 linear in the int8-doubled layout."""
    if lin.weight.dtype != torch.int8:
        raise KernelUnsupported("nvfp4_i8_matmul takes the int8-doubled layout")
    return _nvfp4_call(x, lin, "qtt_nvfp4_i8_matmul", nvfp4_i8_matmul)


@_count
def nvfp4_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for an NVFP4 linear -> (..., N): packed codes here,
    the int8-doubled layout through :func:`nvfp4_i8_matmul`."""
    if lin.weight.dtype == torch.int8:
        return nvfp4_i8_matmul(x, lin)
    return _nvfp4_call(x, lin, "qtt_nvfp4_matmul", nvfp4_matmul)


# ---------------------------------------------------------------------------
# FP8 block: float8_e4m3fn (K, N); f32 scales (K/128, N/128)
# ---------------------------------------------------------------------------

def _fp8_reason(lin: QuantLinear) -> Optional[str]:
    """Why :func:`fp8_matmul` cannot take ``lin`` (None if it can).

    The conditions of the JAX package's ``fp8_matmul`` as its tests run it
    (interpret mode): the block strategy, 128 x 128 blocks, 128 | K and
    128 | N. Its compiled-TPU refusal (``kernels.py:525-532``: no fused
    formulation beat XLA's dequantize-then-matmul on a v5e) is a fact of
    that chip, not of the function, and is not mirrored. Other fp8
    strategies (channel, group, tensor) take the reference path, as there.
    The payload must be float8_e4m3fn with the f32 (K/128, N/128) grid."""
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    if md.get("strategy") != "block":
        return "fp8 kernel covers the block strategy only"
    if (int(md["block_k"]) != FP8_BLOCK or int(md["block_n"]) != FP8_BLOCK
            or k % FP8_BLOCK or n % FP8_BLOCK):
        return f"fp8 kernel needs 128x128 blocks and 128|K,N (k={k}, n={n})"
    if (lin.weight.dtype != torch.float8_e4m3fn or lin.scale.dtype != torch.float32
            or tuple(lin.scale.shape) != (k // FP8_BLOCK, n // FP8_BLOCK)):
        return "fp8 kernel takes float8_e4m3fn weights with an f32 (K/128, N/128) scale grid"
    return None


def fp8_matmul_plain(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The fp8 kernel's arithmetic in PyTorch: each weight times its
    block's scale in f32, rounded to bf16, f32 products and sums, bf16 out.
    x2 (M, K) -> (M, N)."""
    up = scale.float().repeat_interleave(FP8_BLOCK, dim=0).repeat_interleave(FP8_BLOCK, dim=1)
    w = (w8.float() * up).to(torch.bfloat16)
    return (x2.float() @ w.float()).to(torch.bfloat16)


@_count
def fp8_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for an FP8 block-scaled linear -> (..., N)."""
    reason = _fp8_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    k, n = lin.in_features, lin.out_features
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = fp8_matmul_plain(x2, lin.weight, lin.scale)
    elif x2.is_cuda:
        _check_cuda("fp8_matmul", x2, lin.weight, lin.scale)
        lib = _build.load()
        m = x2.shape[0]
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
        err = lib.qtt_fp8_matmul(x2.data_ptr(), lin.weight.data_ptr(), lin.scale.data_ptr(),
                                 out.data_ptr(), m, k, n, _stream(x2.device))
        _build.check(err, "fp8_matmul")
        fp8_matmul.launches += 1
    else:
        raise ValueError(f"fp8_matmul: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


KERNELS: Dict[str, Callable] = {"w4": w4_matmul, "w8": w8_matmul, "nvfp4": nvfp4_matmul,
                                "fp8": fp8_matmul}
_REASONS: Dict[str, Callable] = {"w4": _w4_reason, "w8": _w8_reason, "nvfp4": _nvfp4_reason,
                                 "fp8": _fp8_reason}


def supports(lin: QuantLinear) -> bool:
    """Does ``lin`` have a kernel that takes its layout and shape?"""
    reason = _REASONS.get(lin.kind)
    return reason is not None and reason(lin) is None


# ---------------------------------------------------------------------------
# Decode attention with in-place KV-cache update
# ---------------------------------------------------------------------------

def decode_reason(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor
                   ) -> Optional[str]:
    if cache_k.dtype != q.dtype or cache_v.dtype != q.dtype or q.dtype != torch.bfloat16:
        return "decode_attention takes a bf16 cache and bf16 queries"
    dk, dv = q.shape[-1], cache_v.shape[-1]
    if dk % 128 or dv % 128:
        return "decode_attention needs 128|head_dim"
    if dk != DECODE_HEAD_DIM or dv != DECODE_HEAD_DIM:
        return f"the decode_attention kernel is built for head_dim {DECODE_HEAD_DIM}"
    if q.shape[2] > DECODE_MAX_REP:
        return f"decode_attention takes at most {DECODE_MAX_REP} query heads per KV head"
    if cache_k.shape[2] % 8:
        return "decode_attention needs 8|S"
    return None


def decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths, sm_scale):
    """The decode-attention kernel's function in PyTorch, with f32 scores
    and sums: writes the new row at ``min(length, S-1)`` in place, attends
    positions <= that row, and keeps masked positions out of every product."""
    B, KV, rep, hd = q.shape
    S = cache_k.shape[2]
    L = lengths.clamp(max=S - 1).long()
    rows = torch.arange(B, device=q.device)
    cache_k[rows, :, L] = new_k.to(cache_k.dtype)
    cache_v[rows, :, L] = new_v.to(cache_v.dtype)
    valid = torch.arange(S, device=q.device)[None, :] <= L[:, None]  # (B, S)
    kf = torch.where(valid[:, None, :, None], cache_k.float(), 0.0)
    vf = torch.where(valid[:, None, :, None], cache_v.float(), 0.0)
    scores = torch.einsum("bkrd,bksd->bkrs", q.float(), kf) * sm_scale
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    # the probabilities are rounded to the activation dtype before the value
    # product, as in the JAX package's Pallas kernel; the CUDA kernel keeps
    # them in f32 (at most 2^-9 of each term apart)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return torch.einsum("bkrs,bksd->bkrd", probs, vf).to(q.dtype)


@_count
def decode_attention(q: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """One-token GQA attention over a head-major cache, written in place.

    q (B, KV, rep, hd); new_k/new_v (B, KV, hd); cache_k/cache_v
    (B, KV, S, hd), updated in place at row ``min(lengths[b], S-1)``;
    lengths (B,) int32. Returns ctx (B, KV, rep, hd). The caller advances
    ``lengths``."""
    reason = decode_reason(q, cache_k, cache_v)
    if reason:
        raise KernelUnsupported(reason)
    if q.device.type == "cpu":
        return decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, KV, rep, hd = q.shape
    S = cache_k.shape[2]
    q = q.contiguous()
    new_k = new_k.to(cache_k.dtype).contiguous()
    new_v = new_v.to(cache_v.dtype).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_cuda("decode_attention", q, new_k, new_v, cache_k, cache_v, lengths)
    lib = _build.load()
    ctx = torch.empty_like(q)
    err = lib.qtt_decode_attention(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), lengths.data_ptr(), ctx.data_ptr(), B, KV, rep, S, hd,
        float(sm_scale), _stream(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return ctx


# ---------------------------------------------------------------------------
# Absorbed-MLA decode attention over the latent cache, appended in place
# ---------------------------------------------------------------------------

def mla_decode_reason(q_abs: torch.Tensor, q_pe: torch.Tensor, cache_c: torch.Tensor,
                      cache_p: torch.Tensor) -> Optional[str]:
    """Why :func:`mla_decode_attention` cannot take these tensors (None if
    it can): the JAX kernel's conditions (a cache of the queries' dtype, so
    that an fp8 latent cache takes the plain attention path; 128 | r and
    128 | rope_pad; 8 | S), bf16, and the widths the CUDA kernel is built
    for."""
    if cache_c.dtype != q_abs.dtype or cache_p.dtype != q_abs.dtype:
        return "mixed-dtype latent cache goes through the plain attention path"
    r, dp, S = q_abs.shape[-1], q_pe.shape[-1], cache_c.shape[2]
    if r % 128 or dp % 128:
        return "mla decode kernel needs 128|r and 128|rope_pad"
    if S % 8:
        return "mla decode kernel needs 8|S"
    if q_abs.dtype != torch.bfloat16 or q_pe.dtype != torch.bfloat16:
        return "mla decode kernel takes bf16 queries and caches"
    if r > MLA_MAX_RANK or dp > MLA_MAX_ROPE or S > MLA_MAX_SLOTS:
        return (f"the mla decode kernel is built for r <= {MLA_MAX_RANK}, rope_pad <= "
                f"{MLA_MAX_ROPE}, S <= {MLA_MAX_SLOTS}")
    return None


def mla_decode_attention_plain(q_abs, q_pe, new_c, new_p, cache_c, cache_p, lengths,
                               sm_scale):
    """The MLA decode kernel's function in PyTorch: writes the new latent
    and rope rows at ``min(length, S-1)`` in place, scores every head
    against positions <= that row as (q_abs . C + q_pe . P) * sm_scale with
    f32 sums, takes an f32 softmax rounded to bf16 (as the JAX package's
    kernel does), and returns ctx_lat = p . C with f32 sums, in bf16.
    Masked positions stay out of every product."""
    B, H, r = q_abs.shape
    S = cache_c.shape[2]
    L = lengths.long().clamp(min=0, max=S - 1)
    rows = torch.arange(B, device=q_abs.device)
    cache_c[rows, 0, L] = new_c.to(cache_c.dtype)
    cache_p[rows, 0, L] = new_p.to(cache_p.dtype)
    valid = torch.arange(S, device=q_abs.device)[None, :] <= L[:, None]  # (B, S)
    C = torch.where(valid[:, :, None], cache_c[:, 0].float(), 0.0)
    P = torch.where(valid[:, :, None], cache_p[:, 0].float(), 0.0)
    scores = (torch.einsum("bhr,bsr->bhs", q_abs.float(), C)
              + torch.einsum("bhd,bsd->bhs", q_pe.float(), P)) * sm_scale
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhs,bsr->bhr", probs, C).to(q_abs.dtype)


@_count
def mla_decode_attention(q_abs: torch.Tensor, q_pe: torch.Tensor, new_c: torch.Tensor,
                         new_p: torch.Tensor, cache_c: torch.Tensor, cache_p: torch.Tensor,
                         lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Absorbed one-token MLA attention over the latent cache, written in
    place.

    q_abs (B, H, r); q_pe (B, H, rope_pad); new_c (B, r); new_p
    (B, rope_pad); cache_c (B, 1, S, r) and cache_p (B, 1, S, rope_pad),
    updated in place at row ``min(lengths[b], S-1)``; lengths (B,) int32.
    Returns ctx_lat (B, H, r). The caller advances ``lengths``."""
    reason = mla_decode_reason(q_abs, q_pe, cache_c, cache_p)
    if reason:
        raise KernelUnsupported(reason)
    if q_abs.device.type == "cpu":
        return mla_decode_attention_plain(q_abs, q_pe, new_c, new_p, cache_c, cache_p,
                                          lengths, sm_scale)
    if not q_abs.is_cuda:
        raise ValueError(f"mla_decode_attention: no kernel for device {q_abs.device}")
    B, H, r = q_abs.shape
    dp, S = q_pe.shape[2], cache_c.shape[2]
    q_abs, q_pe = q_abs.contiguous(), q_pe.contiguous()
    new_c = new_c.to(cache_c.dtype).contiguous()
    new_p = new_p.to(cache_p.dtype).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_cuda("mla_decode_attention", q_abs, q_pe, new_c, new_p, cache_c, cache_p, lengths)
    lib = _build.load()
    ctx = torch.empty_like(q_abs)
    err = lib.qtt_mla_decode_attention(
        q_abs.data_ptr(), q_pe.data_ptr(), new_c.data_ptr(), new_p.data_ptr(),
        cache_c.data_ptr(), cache_p.data_ptr(), lengths.data_ptr(), ctx.data_ptr(),
        B, H, r, dp, S, float(sm_scale), _stream(q_abs.device))
    _build.check(err, "mla_decode_attention")
    mla_decode_attention.launches += 1
    return ctx


# ---------------------------------------------------------------------------
# MoE slot FFN: the gated FFN of S (token, expert) slots over expert stacks
# ---------------------------------------------------------------------------

#: payload codes of csrc/moe_slot_ffn.cu
_SLOT_PAYLOAD = {("w4", torch.uint8): 0, ("nvfp4", torch.uint8): 1, ("nvfp4", torch.int8): 2}


def moe_slot_ffn_reason(x: torch.Tensor, gate_el, up_el, down_el) -> Optional[str]:
    """Why :func:`moe_slot_ffn` cannot take these slots (None if it can):
    the JAX kernel's conditions (kind w4 or nvfp4, symmetric, 8|S, 128|D
    and 128|F), plus one payload layout for the three stacks, bf16 scales
    and groups that divide D and F."""
    kind = gate_el.kind
    if kind not in ("w4", "nvfp4"):
        return f"moe_slot_ffn supports w4/nvfp4, got {kind}"
    els = (gate_el, up_el, down_el)
    if any(el.zero_point is not None for el in els):
        return "asymmetric experts go through the gather reference"
    S, D = x.shape
    gm, dm = gate_el.meta_dict, down_el.meta_dict
    Fe = int(gm["n"])
    if S % 8 or D % 128 or int(dm["k"]) % 128:
        return "moe_slot_ffn needs 8|S and 128|D,Fe"
    if (int(gm["k"]) != D or int(dm["k"]) != Fe or int(dm["n"]) != D
            or up_el.meta != gate_el.meta or down_el.kind != kind or up_el.kind != kind):
        return "moe_slot_ffn: gate/up (E, D, F) and down (E, F, D) stacks of one kind"
    payload = {_SLOT_PAYLOAD.get((kind, el.weight.dtype)) for el in els}
    if len(payload) != 1 or None in payload:
        return "moe_slot_ffn takes packed w4, packed nvfp4 or int8-doubled nvfp4 stacks"
    if any(el.scale is None or el.scale.dtype != torch.bfloat16 for el in els):
        return "moe_slot_ffn takes bf16 group scales"
    g = int(gm.get("group_size", 16 if kind == "nvfp4" else 32))
    if D % g or Fe % g or int(dm.get("group_size", g)) != g:
        return f"moe_slot_ffn needs the group ({g}) to divide D and F"
    return None


def moe_slot_ffn_plain(x: torch.Tensor, idx: torch.Tensor, gate_el, up_el,
                       down_el) -> torch.Tensor:
    """The slot kernel's arithmetic in PyTorch: each gathered weight is
    value * scale rounded to bf16, f32 products and sums,
    a = bf16(silu(g) * u), y = a @ down in f32. x (S, D) -> (S, D) f32."""
    from ..models.moe import _slot_dequant

    xs = x.to(torch.bfloat16).float()[:, None, :]
    g = torch.bmm(xs, _slot_dequant(gate_el, idx).float())[:, 0]
    u = torch.bmm(xs, _slot_dequant(up_el, idx).float())[:, 0]
    a = (F.silu(g) * u).to(torch.bfloat16).float()[:, None, :]
    return torch.bmm(a, _slot_dequant(down_el, idx).float())[:, 0]


@_count
def moe_slot_ffn(x: torch.Tensor, idx: torch.Tensor, gate_el, up_el, down_el) -> torch.Tensor:
    """Gated FFN of ``S`` expert slots: x (S, D) (a token row per slot),
    idx (S,) expert ids; gate/up (E, D, F) and down (E, F, D) stacks.
    Returns (S, D) f32, not yet combined."""
    reason = moe_slot_ffn_reason(x, gate_el, up_el, down_el)
    if reason:
        raise KernelUnsupported(reason)
    if x.device.type == "cpu":
        return moe_slot_ffn_plain(x, idx, gate_el, up_el, down_el)
    if not x.is_cuda:
        raise ValueError(f"moe_slot_ffn: no kernel for device {x.device}")
    S, D = x.shape
    Fe = int(gate_el.meta_dict["n"])
    g = int(gate_el.meta_dict.get("group_size", 16 if gate_el.kind == "nvfp4" else 32))
    xb = x.to(torch.bfloat16).contiguous()
    ids = idx.to(torch.int32).contiguous()
    ts = [gate_el.weight, gate_el.scale, up_el.weight, up_el.scale, down_el.weight,
          down_el.scale]
    _check_cuda("moe_slot_ffn", xb, ids, *ts)
    lib = _build.load()
    a_ws = torch.empty((S, Fe), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((S, D), dtype=torch.float32, device=x.device)
    payload = _SLOT_PAYLOAD[(gate_el.kind, gate_el.weight.dtype)]
    err = lib.qtt_moe_slot_ffn(payload, xb.data_ptr(), ids.data_ptr(),
                               *(t.data_ptr() for t in ts), a_ws.data_ptr(), out.data_ptr(),
                               S, D, Fe, gate_el.num_experts, g, _stream(x.device))
    _build.check(err, "moe_slot_ffn")
    moe_slot_ffn.launches += 1
    return out


def moe_slot_gu_reason(x: torch.Tensor, gu_el, down_el) -> Optional[str]:
    """Why :func:`moe_slot_gu_ffn` cannot take these slots (None if it
    can): the JAX kernel's conditions without its VMEM limit (kind w8,
    per-channel, symmetric, 8|S, 128|D, 256|2F, down K = F), int8 payloads
    and scales of one row per expert."""
    if gu_el.kind != "w8" or down_el.kind != "w8":
        return "moe_slot_gu_ffn needs the w8pc layout"
    if gu_el.meta_dict.get("group_size") or down_el.meta_dict.get("group_size"):
        return "moe_slot_gu_ffn needs per-channel scales"
    if gu_el.zero_point is not None or down_el.zero_point is not None:
        return "asymmetric experts go through the gather reference"
    S, D = x.shape
    Fe2 = int(gu_el.meta_dict["n"])
    if S % 8 or D % 128 or Fe2 % 256 or int(down_el.meta_dict["k"]) != Fe2 // 2:
        return "moe_slot_gu_ffn geometry mismatch"
    if int(gu_el.meta_dict["k"]) != D or int(down_el.meta_dict["n"]) != D:
        return "moe_slot_gu_ffn: gate|up (E, D, 2F) and down (E, F, D) stacks"
    if gu_el.weight.dtype != torch.int8 or down_el.weight.dtype != torch.int8:
        return "moe_slot_gu_ffn takes int8 stacks"
    if gu_el.scale.shape[-2] != 1 or down_el.scale.shape[-2] != 1:
        return "moe_slot_gu_ffn takes (E, 1, N) per-channel scales"
    return None


def moe_slot_gu_ffn_plain(x: torch.Tensor, idx: torch.Tensor, gu_el, down_el) -> torch.Tensor:
    """The fused slot kernel's arithmetic in PyTorch: int8 values (exact in
    bf16) times bf16 x summed in f32, the per-channel f32 scales applied to
    the sums, a = bf16(silu(g) * u). x (S, D) -> (S, D) f32."""
    i = idx.long()
    S = x.shape[0]
    xs = x.to(torch.bfloat16).float()[:, None, :]
    guv = torch.bmm(xs, gu_el.weight[i].float())[:, 0] * gu_el.scale[i].float().reshape(S, -1)
    Fe = guv.shape[-1] // 2
    a = (F.silu(guv[:, :Fe]) * guv[:, Fe:]).to(torch.bfloat16).float()[:, None, :]
    return (torch.bmm(a, down_el.weight[i].float())[:, 0]
            * down_el.scale[i].float().reshape(S, -1))


@_count
def moe_slot_gu_ffn(x: torch.Tensor, idx: torch.Tensor, gu_el, down_el) -> torch.Tensor:
    """Gated FFN of ``S`` expert slots over the fused w8pc layout: gate|up
    int8 (E, D, 2F) with f32 scales (E, 1, 2F), down int8 (E, F, D) with
    (E, 1, D). Returns (S, D) f32, not yet combined."""
    reason = moe_slot_gu_reason(x, gu_el, down_el)
    if reason:
        raise KernelUnsupported(reason)
    if x.device.type == "cpu":
        return moe_slot_gu_ffn_plain(x, idx, gu_el, down_el)
    if not x.is_cuda:
        raise ValueError(f"moe_slot_gu_ffn: no kernel for device {x.device}")
    S, D = x.shape
    Fe = int(gu_el.meta_dict["n"]) // 2
    xb = x.to(torch.bfloat16).contiguous()
    ids = idx.to(torch.int32).contiguous()
    # the scales may be bf16: widening them is exact
    ts = [gu_el.weight, gu_el.scale.float().contiguous(), down_el.weight,
          down_el.scale.float().contiguous()]
    _check_cuda("moe_slot_gu_ffn", xb, ids, *ts)
    lib = _build.load()
    a_ws = torch.empty((S, Fe), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((S, D), dtype=torch.float32, device=x.device)
    err = lib.qtt_moe_slot_gu_ffn(xb.data_ptr(), ids.data_ptr(), *(t.data_ptr() for t in ts),
                                  a_ws.data_ptr(), out.data_ptr(), S, D, Fe,
                                  gu_el.num_experts, _stream(x.device))
    _build.check(err, "moe_slot_gu_ffn")
    moe_slot_gu_ffn.launches += 1
    return out


ALL_KERNELS = (w4_matmul, w8_matmul, decode_attention, nvfp4_matmul, nvfp4_i8_matmul,
               moe_slot_ffn, moe_slot_gu_ffn, flash_attention, fp8_matmul,
               mla_decode_attention)


def reset_launch_counts() -> None:
    for fn in ALL_KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in ALL_KERNELS}
