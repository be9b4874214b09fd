"""quantizers_tpu_torch — the PyTorch and CUDA port of ``quantizers_tpu``.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
This slice serves dense W4A16 Qwen3-style models on an NVIDIA H100: the
INT quantization numerics, quantized linears, the dense transformer, the
prefill and decode engine and the continuous batcher, with hand-written
CUDA kernels (``csrc/``) for the w4 and w8 weight-only matmuls and for
one-token decode attention. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``, where every kernel's plain PyTorch version
runs instead.

The package imports ``torch`` and never ``jax`` or ``quantizers_tpu``.
"""

__version__ = "0.1.0"
