"""Command-line entry points of the port.

* ``python -m quantizers_tpu_torch.cli.do_oneshot`` — calibrated
  quantization of a local bf16 checkpoint (reference ``scripts/do_oneshot.py``;
  RTN, GPTQ, AWQ, SmoothQuant and AutoRound recipes)
* ``python -m quantizers_tpu_torch.cli.model_free`` — data-free PTQ of a
  local checkpoint, shard by shard (reference
  ``scripts/quant_GLM-4.7-Flash-FP8.py``)
* ``python -m quantizers_tpu_torch.cli.validate_config`` — quantization_config
  schema check (reference ``scripts/quant_config_debug.py``)
* ``python -m quantizers_tpu_torch.cli.recombine`` — mixed-precision weight
  surgery (reference ``scripts/recombine_weights_MiniMax-M2.1.py``)
* ``python -m quantizers_tpu_torch.cli.eval_ppl`` — perplexity of a
  checkpoint over a text file (sliding windows)
* ``python -m quantizers_tpu_torch.cli.serve`` — continuous-batching
  generation from a checkpoint
* ``python -m quantizers_tpu_torch.cli.make_tiny_model`` — write a tiny
  local HF checkpoint for offline smoke runs

``do_oneshot``, ``model_free``, ``eval_ppl``, ``serve`` and
``make_tiny_model`` run on the CUDA card unless ``--device cpu`` is given;
``validate_config`` and ``recombine`` read and copy files only.
"""
