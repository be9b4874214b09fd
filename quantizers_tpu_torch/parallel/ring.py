"""Ring (context-parallel) attention over a mesh axis.

Counterpart of ``quantizers_tpu/parallel/ring.py``. The sequence axis is
split over a ``cp`` axis: each rank keeps its query block and the K/V
blocks travel around the ring, one hop a step (``batch_isend_irecv``; the
next hop is in flight while a block is folded). Every hop folds one block
into the running online-softmax state (max ``m``, normaliser ``l``,
unnormalised accumulator ``acc``, all f32): the flash kernel's recurrence,
so a rank's memory holds one (T_local, T_local) score tile whatever the
global length.

Causality is by global position: the block a rank holds at step ``i``
came from rank ``(me - i) mod P``, so its keys sit at ``src * T_local +
col`` and the mask admits ``q_pos >= k_pos``.

The JAX ring is ``jnp``, not Pallas, so the fold here is PyTorch
operations, not a kernel of its own. Under ``gloo`` the hop stages CUDA
blocks through pinned host memory (:mod:`.collectives`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import AxisGroup

_NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: float, group: Optional[AxisGroup],
                         causal: bool = True) -> torch.Tensor:
    """A rank's part of the ring: its blocks q (B, H, Tl, d), k (B, KV, Tl,
    d), v (B, KV, Tl, dv) of a sequence split in rank order over
    ``group`` (None: one rank) -> its (B, H, Tl, dv) context in q's dtype.
    The GQA group is folded into the queries, so K/V blocks are never
    repeated."""
    P_ = 1 if group is None else group.size
    me = 0 if group is None else group.index
    B, H, Tl, d = q.shape
    KV, dv = k.shape[1], v.shape[3]
    rep = H // KV
    qg = q.reshape(B, KV, rep, Tl, d).float()
    m = torch.full((B, KV, rep, Tl, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, rep, Tl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, rep, Tl, dv), dtype=torch.float32, device=q.device)
    rows = torch.arange(Tl, device=q.device)
    k_blk, v_blk = k, v
    for i in range(P_):
        hop = group.ring_shift([k_blk, v_blk]) if i + 1 < P_ else None
        src = (me - i) % P_
        s = torch.einsum("bgrtd,bgsd->bgrts", qg, k_blk.float()) * sm_scale
        if causal:
            q_pos = me * Tl + rows[:, None]
            k_pos = src * Tl + rows[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bgrts,bgsd->bgrtd", p, v_blk.float())
        m = m_new
        if hop is not None:
            k_blk, v_blk = hop.wait()
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Tl, dv).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float, mesh, axis: str = "cp",
                   causal: bool = True) -> torch.Tensor:
    """Context-parallel attention of whole q/k/v (B, H|KV, T, d): each rank
    takes its block of T on ``axis``, runs the ring, and the blocks are
    gathered, so every rank returns the whole (B, H, T, dv) output. T must
    divide by the axis size; heads are not split (split H outside to
    compose with tp)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}")
    n = mesh.size(axis)
    T = q.shape[2]
    if T % n:
        raise ValueError(f"{axis} size {n} must divide the sequence length T={T}")
    group = mesh.group(axis)
    if group is None:
        return ring_attention_local(q, k, v, sm_scale, None, causal)
    Tl = T // n
    sl = slice(group.index * Tl, (group.index + 1) * Tl)
    out = ring_attention_local(q[:, :, sl].contiguous(), k[:, :, sl].contiguous(),
                               v[:, :, sl].contiguous(), sm_scale, group, causal)
    return group.all_gather_last(out.transpose(2, 3)).transpose(2, 3).contiguous()
