"""The collectives of the port's tensor, expert and context parallelism.

GSPMD inserts these in the JAX package; here they are explicit and few:

* :class:`AxisGroup`: one mesh axis's process group as a rank sees it, with
  the three collectives the model needs: partial sums all-reduced in f32
  and cast back (:meth:`AxisGroup.all_reduce_f32`), column shards
  all-gathered along the last dimension (:meth:`AxisGroup.all_gather_last`),
  and one hop of a ring (:meth:`AxisGroup.ring_shift`);
* :class:`RowParallel`: the shard of a row-parallel linear (o_proj,
  down_proj): its partial output all-reduced over the axis, then the bias,
  added once;
* :class:`ColumnGather`: the shard of a column-parallel logits head, its
  logits all-gathered, so that every rank holds the same full row.

The wrappers hold a plain :class:`~quantizers_tpu_torch.ops.linear.QuantLinear`
shard, so that the kernels (which take raw pointers) see an ordinary
linear at the shard's shape; the serving transforms apply themselves to
the shard through ``with_shard``.

**Gloo and CUDA tensors.** NCCL refuses two ranks on one card, so such a
run takes the ``gloo`` backend. Gloo all-reduces and all-gathers CUDA
tensors itself; its point-to-point send and receive take host tensors
only, so under gloo the ring's hop copies each CUDA block to pinned host
memory, sends it, and copies what it receives back to the card. That copy
is the only host staging, and only under gloo; under NCCL nothing is
staged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


#: per collective: [calls, host seconds] in this process since
#: :func:`reset_stats`. Under gloo a call returns when its result is in
#: place, so its seconds are the collective's (waiting for the slowest rank
#: included); under NCCL a call only enqueues the collective on the stream.
STATS: Dict[str, List[float]] = {}


def reset_stats() -> None:
    STATS.clear()


def stats() -> Dict[str, Dict[str, float]]:
    """{collective: {"calls": n, "seconds": s}} since :func:`reset_stats`."""
    return {k: {"calls": int(v[0]), "seconds": v[1]} for k, v in STATS.items()}


def _record(name: str, t0: float) -> None:
    entry = STATS.setdefault(name, [0, 0.0])
    entry[0] += 1
    entry[1] += time.perf_counter() - t0


@dataclasses.dataclass(eq=False)
class AxisGroup:
    """A mesh axis as this rank sees it: its name, its process group, its
    size, this rank's coordinate on it and the global ranks along it (by
    coordinate)."""

    name: str
    group: Any
    size: int
    index: int
    ranks: tuple

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def all_reduce_f32(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of each rank's ``t``, taken in f32 and cast
        back to ``t``'s dtype. Every rank gets the same bits."""
        y = t.to(torch.float32, copy=True).contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(y, group=self.group)
        _record("all_reduce", t0)
        return y.to(t.dtype)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the last dimension, in
        coordinate order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        t0 = time.perf_counter()
        dist.all_gather(parts, t, group=self.group)
        _record("all_gather", t0)
        return torch.cat(parts, dim=-1)

    def ring_shift(self, tensors: Sequence[torch.Tensor]) -> "RingHop":
        """Start one hop of the ring: each of ``tensors`` goes to the next
        rank on the axis, and the previous rank's come back through
        :meth:`RingHop.wait`. Under gloo, CUDA tensors are staged through
        pinned host memory (module docstring)."""
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        stage = self.backend == "gloo" and any(t.is_cuda for t in tensors)
        t0 = time.perf_counter()
        if stage:
            send = [t.to("cpu", copy=True).pin_memory() if torch.cuda.is_available()
                    else t.to("cpu", copy=True) for t in tensors]
        else:
            send = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in recv]
        reqs = dist.batch_isend_irecv(ops)
        _record("ring_hop", t0)
        return RingHop(reqs, recv, [t.device for t in tensors] if stage else None, send)


@dataclasses.dataclass(eq=False)
class RingHop:
    """One ring hop in flight (:meth:`AxisGroup.ring_shift`)."""

    reqs: List[Any]
    recv: List[torch.Tensor]
    devices: Optional[List[torch.device]]
    send: List[torch.Tensor]  # kept alive until the sends complete

    def wait(self) -> List[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        if self.devices is None:
            return self.recv
        return [t.to(d, non_blocking=True) for t, d in zip(self.recv, self.devices)]


@dataclasses.dataclass(eq=False)
class RowParallel:
    """A rank's shard of a row-parallel linear (its rows of K): ``apply``
    all-reduces the partial outputs over ``group`` in f32, casts them back
    and adds the bias, which the shard does not hold, once."""

    shard: Any
    group: AxisGroup
    bias: Optional[torch.Tensor] = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        y = self.group.all_reduce_f32(self.shard.apply(x))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    __call__ = apply

    def with_shard(self, shard: Any) -> "RowParallel":
        return dataclasses.replace(self, shard=shard)

    def to(self, device) -> "RowParallel":
        return dataclasses.replace(self, shard=self.shard.to(device),
                                   bias=None if self.bias is None else self.bias.to(device))


@dataclasses.dataclass(eq=False)
class ColumnGather:
    """A rank's shard of a column-parallel logits head: ``apply`` computes
    the rank's columns (sliced to the shard's own ``orig_n`` where a
    serving layout padded them) and all-gathers them, so every rank holds
    the whole row, bit for bit the same."""

    shard: Any
    group: AxisGroup

    @property
    def meta_dict(self) -> Dict[str, Any]:
        """The shard's meta without ``orig_n``: ``apply`` slices already."""
        return {k: v for k, v in self.shard.meta if k != "orig_n"}

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        y = self.shard.apply(x)
        orig_n = self.shard.meta_dict.get("orig_n")
        if orig_n is not None:
            y = y[..., :orig_n]
        return self.group.all_gather_last(y)

    __call__ = apply

    def with_shard(self, shard: Any) -> "ColumnGather":
        return dataclasses.replace(self, shard=shard)

    def to(self, device) -> "ColumnGather":
        return dataclasses.replace(self, shard=self.shard.to(device))
