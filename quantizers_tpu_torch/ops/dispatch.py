"""Kernel dispatch: route a quantized matmul to a CUDA kernel or to the
dequantize-then-matmul reference path.

The routing is the JAX package's (``quantizers_tpu/ops/dispatch.py``): kind
w4, w8, nvfp4 or fp8, symmetric, a shape the kernel takes, and at most
``KERNEL_MAX_ROWS`` activation rows. It is decided from the shapes before
any launch. A CUDA tensor that qualifies goes to the kernel, and a build or
launch failure raises; a CPU tensor that qualifies goes to the kernel's
plain PyTorch version inside the same wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .linear import QuantLinear

#: Above this many rows the weight-only kernels lose to dequantize-once plus
#: a tensor-core matmul. The value is the crossover measured on a TPU v5e
#: (between 512 and 1024 rows for every Qwen3-4B shape); it has not been
#: measured on the H100 yet.
KERNEL_MAX_ROWS = 512


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with f32 accumulation, in ``a``'s dtype.

    On the card a bf16 ``torch.matmul`` accumulates in f32 on the tensor
    cores; on the CPU the operands are widened to f32 first, which gives the
    same exact products and f32 sums."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.matmul(a16, b16).to(a.dtype)
    return torch.matmul(a16.float(), b16.float()).to(a.dtype)


def reference_quant_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """Dequantize W^T to bf16 and multiply with f32 accumulation."""
    return matmul_f32acc(x, lin.dequantize(torch.bfloat16))


def _rows(x: torch.Tensor) -> int:
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return m


def quant_matmul(x: torch.Tensor, lin: QuantLinear,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (..., K) @ W^T -> (..., N).

    ``use_kernel=False`` forces the reference path (for W8A8 linears the
    A16 oracle, as in the JAX package); ``None`` routes as the JAX package
    does."""
    if use_kernel is not False and lin.meta_dict.get("act"):
        raise NotImplementedError(
            "W8A8 activation quantization is not ported yet: ROADMAP queue 1, item 13")
    if use_kernel is None:
        use_kernel = _rows(x) <= KERNEL_MAX_ROWS
    fn = kernels.KERNELS.get(lin.kind) if use_kernel else None
    if fn is not None and kernels.supports(lin):
        return fn(x, lin)
    return reference_quant_matmul(x, lin)
