"""What every kernel wrapper shares: the refusals it raises, its launch
count, the stream it launches on, and the 16-byte aligned base its inputs
need. A module of its own, so that :mod:`.kernels` and :mod:`.flash` both
import it and neither imports the other's internals."""

from __future__ import annotations

from typing import Callable, Optional

import torch


class KernelUnsupported(Exception):
    """A layout or shape that the kernel does not take; the dispatcher
    checks :func:`supports` first and routes such layers to the reference
    path."""


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Would autograd record a graph through any of ``tensors`` (None
    skipped)?"""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd records through a kernel's input: the kernels
    have no backward (nor do the JAX package's Pallas kernels), so the
    output of a launch would silently carry no gradient to it. Called before
    the wrapper picks its device, so that the CPU's plain version, which is
    differentiable, refuses what the card's launch would."""
    if records_grad(*tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, and an input requires grad "
                           "(call it under torch.no_grad(); a trainer takes the plain path)")


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
