"""Compute layer: quantized linears, CUDA kernels and their dispatch."""

from .linear import QuantLinear, concat_linears, dense_linear, from_quantized  # noqa: F401
from .dispatch import quant_matmul, reference_quant_matmul  # noqa: F401
