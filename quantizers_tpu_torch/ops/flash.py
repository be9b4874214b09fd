"""Blockwise (flash) attention for the no-cache forward: kernel K4.

Counterpart of ``quantizers_tpu/ops/flash.py``. :func:`flash_attention`
replaces its Pallas kernel (``_flash_kernel`` / ``_flash_call``) with
``csrc/flash_attention.cu``; :func:`flash_attention_plain` is the same
function in PyTorch, which the wrapper computes for CPU tensors. The
layout is the JAX package's: q (B, H, T, d), k (B, KV, S, d), v (B, KV, S,
dv) -> (B, H, T, dv), with query head h reading KV head h // (H / KV).

:func:`flash_reason` says why the JAX package would refuse a shape
(``KernelUnsupported``), condition for condition, so that the port takes
the flash branch exactly where the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._launch import KernelUnsupported, _count, _stream, refuse_grad

_NEG_INF = -1e30
#: (d, dv) pairs the CUDA kernel is instantiated for: the dense path, and
#: MLA's padded qk head over a 128-wide v head
KERNEL_HEAD_DIMS = ((128, 128), (256, 128))


def flash_reason(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int = 256, block_k: int = 256) -> Optional[str]:
    """Why the JAX package's ``flash_attention`` raises ``KernelUnsupported``
    for these shapes (None if it does not)."""
    H, T, d = q.shape[1], q.shape[2], q.shape[3]
    KV, S = k.shape[1], k.shape[2]
    if H % KV:
        return f"flash: KV heads {KV} must divide H {H}"
    bq, bk = min(block_q, T), min(block_k, S)
    if T % bq or S % bk or bq % 8 or bk % 8:
        return f"flash: need bq|T ({bq},{T}), bk|S ({bk},{S}), 8|bq, 8|bk"
    if d % 128:
        return f"flash: head dim {d} needs 128|d"
    if v.shape[3] % 128:
        return f"flash: v head dim {v.shape[3]} needs 128|dv"
    return None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                          causal: bool = True, block_q: int = 256,
                          block_k: int = 256) -> torch.Tensor:
    """The TPU kernel's online softmax in PyTorch, over key blocks of
    ``min(block_k, S)``: s = (f32 sums of the products) * sm_scale, masked
    entries -1e30, p = exp(s - m_new) in f32, l summed over the f32 p, the
    value product over bf16(p), out = acc / max(l, 1e-30) in q's dtype.

    Every query row is carried through every key block: a block that the
    TPU kernel skips as above the diagonal is all -1e30 here, which leaves
    m, l and acc exactly as they were. Raises
    :class:`~quantizers_tpu_torch.ops.kernels.KernelUnsupported` where the
    JAX package does for these blocks (:func:`flash_reason`), which is all
    that ``block_q`` enters."""
    reason = flash_reason(q, k, v, block_q, block_k)
    if reason:
        raise KernelUnsupported(reason)
    B, H, T, d = q.shape
    KV, S, dv = k.shape[1], k.shape[2], v.shape[3]
    rep = H // KV
    bk = min(block_k, S)
    qf = q.reshape(B, KV, rep, T, d).float()
    rows = torch.arange(T, device=q.device)[:, None]
    m = torch.full((B, KV, rep, T, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, rep, T, dv), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):
        kb, vb = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk]
        s = torch.einsum("bkrtd,bksd->bkrts", qf, kb) * sm_scale
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
            s = s.masked_fill(cols > rows, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkrts,bksd->bkrtd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(B, H, T, dv)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: a contiguous last dim, 16-byte aligned
    rows (strides of whole 8-element chunks, none 0: the kernel's TMA copies
    take no expanded view) at a 16-byte aligned base; a view is kept where
    it is, anything else copied."""
    aligned = (t.stride(-1) == 1 and all(s % 8 == 0 and s > 0 for s in t.stride()[:-1])
               and t.data_ptr() % 16 == 0)
    return t if aligned else t.clone(memory_format=torch.contiguous_format)


@_count
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                    causal: bool = True) -> torch.Tensor:
    """Blockwise attention, head-major: q (B, H, T, d), k (B, KV, S, d),
    v (B, KV, S, dv) -> (B, H, T, dv).

    Raises :class:`~quantizers_tpu_torch.ops.kernels.KernelUnsupported`
    where :func:`flash_reason` does, and, for CUDA tensors, for a (d, dv)
    the kernel is not built for. On the card the inputs are read through
    their strides (the transformer passes ``transpose(1, 2)`` views), and the
    output is a (B, H, T, dv) view of a (B, T, H, dv) buffer, so that the
    caller's ``transpose(1, 2).reshape(B, T, H * dv)`` copies nothing.
    Raises ``RuntimeError`` where autograd records through q, k or v (the
    kernel has no backward), on every device."""
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, causal)
    reason = flash_reason(q, k, v)
    if reason:
        raise KernelUnsupported(reason)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, H, T, d = q.shape
    KV, S, dv = k.shape[1], k.shape[2], v.shape[3]
    if (d, dv) not in KERNEL_HEAD_DIMS:
        raise KernelUnsupported(f"the flash kernel is built for (d, dv) in {KERNEL_HEAD_DIMS}, "
                                f"not ({d}, {dv})")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes bf16 q, k and v")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, {k.device}, {v.device}")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((B, T, H, dv), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.load()
    err = lib.qtt_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  *strides, B, H, KV, T, S, d, dv, float(sm_scale), int(causal),
                                  _stream(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out
