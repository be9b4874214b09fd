"""What every kernel wrapper shares: the refusal it raises, its launch
count, the stream it launches on, and the 16-byte aligned base its inputs
need. A module of its own, so that :mod:`.kernels` and :mod:`.flash` both
import it and neither imports the other's internals."""

from __future__ import annotations

from typing import Callable

import torch


class KernelUnsupported(Exception):
    """A layout or shape that the kernel does not take; the dispatcher
    checks :func:`supports` first and routes such layers to the reference
    path."""


def _count(fn: Callable) -> Callable:
    fn.launches = 0
    return fn


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` where its base is 16-byte aligned, else a copy of it. The
    kernels copy their inputs 16 bytes at a time (cp.async, TMA, uint4
    reads) and refuse an unaligned base; ``.contiguous()`` would return a
    contiguous view at an unaligned base unchanged."""
    if t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)
