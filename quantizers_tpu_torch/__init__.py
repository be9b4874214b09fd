"""quantizers_tpu_torch — the PyTorch and CUDA port of ``quantizers_tpu``.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
It serves dense W4A16 Qwen3-style models and NVFP4 models, dense or MoE
(Qwen3-30B-A3B with NVFP4 experts), on an NVIDIA H100: the INT and NVFP4
quantization numerics, quantized linears and expert stacks, the
transformer with its MoE block, the expert serving layouts, the prefill
and decode engine and the continuous batcher, with hand-written CUDA
kernels (``csrc/``) for the w4, w8 and NVFP4 weight-only matmuls, one-token
decode attention and the MoE slot FFNs. It reads and writes safetensors
and compressed-tensors checkpoints (``formats``, ``models.loader``),
scores perplexity through a flash-attention kernel, and has the
``eval_ppl``, ``serve`` and ``make_tiny_model`` CLIs. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, where every kernel's plain
PyTorch version runs instead.

The package imports ``torch`` and never ``jax`` or ``quantizers_tpu``.
"""

__version__ = "0.1.0"
