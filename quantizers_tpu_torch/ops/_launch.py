"""What every kernel wrapper shares: the refusal it raises, its launch
count, and the stream it launches on. A module of its own, so that
:mod:`.kernels` and :mod:`.flash` both import it and neither imports the
other's internals."""

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
