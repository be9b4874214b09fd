"""The serving path's CUDA kernels: wrappers, plain versions, launch counts.

Each wrapper checks what its kernel takes and raises
:class:`KernelUnsupported` on anything else, before any launch. Given CPU
tensors it computes the kernel's plain PyTorch version; given CUDA tensors
it launches the kernel (``csrc/*.cu``, built by :mod:`._build`) on the
current stream and raises if the launch fails. It adds one to its
``launches`` count where it launches, and nowhere else.

* :func:`w4_matmul` replaces ``quantizers_tpu/ops/kernels.py``
  ``_w4_matmul_2d`` and ``_w4i_matmul_2d`` (W4A16, group scales);
* :func:`w8_matmul` replaces ``_w8_matmul_2d`` (int8, channel or group);
* :func:`decode_attention` replaces ``_decode_attention_call`` (one-token
  GQA attention with the new K/V row written into the cache in place).

Importing this module needs neither ``nvcc`` nor a card: the library is
built at the first launch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from . import _build
from .linear import QuantLinear, _unpack_nibbles


class KernelUnsupported(Exception):
    """A layout or shape that the kernel does not take; the dispatcher
    checks :func:`supports` first and routes such layers to the reference
    path."""


#: head dim and largest query-group size the decode-attention kernel is built for
DECODE_HEAD_DIM = 128
DECODE_MAX_REP = 8


def _count(fn: Callable) -> Callable:
    fn.launches = 0
    return fn


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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
    if lin.weight.dtype != torch.int8 or lin.scale.dtype != torch.bfloat16:
        return "w8 kernel takes int8 weights with bf16 scales"
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
        out = _launch_matmul("qtt_w8_matmul", w8_matmul, x2, lin, int(g) if g else k)
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


KERNELS: Dict[str, Callable] = {"w4": w4_matmul, "w8": w8_matmul}
_REASONS: Dict[str, Callable] = {"w4": _w4_reason, "w8": _w8_reason}


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


ALL_KERNELS = (w4_matmul, w8_matmul, decode_attention)


def reset_launch_counts() -> None:
    for fn in ALL_KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in ALL_KERNELS}
