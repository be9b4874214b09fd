"""Command-line entry points of the port.

* ``python -m quantizers_tpu_torch.cli.eval_ppl`` — perplexity of a
  checkpoint over a text file (sliding windows)
* ``python -m quantizers_tpu_torch.cli.serve`` — continuous-batching
  generation from a checkpoint
* ``python -m quantizers_tpu_torch.cli.make_tiny_model`` — write a tiny
  local HF checkpoint for offline smoke runs

Each runs on the CUDA card unless ``--device cpu`` is given. The JAX package's quantization CLIs (``do_oneshot``,
``model_free``, ``recombine``, ``validate_config``) wait for their slices
(ROADMAP).
"""
