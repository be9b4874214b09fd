"""Oneshot calibration and compression engine.

Counterpart of ``quantizers_tpu/oneshot`` (the reference's
``llmcompressor.oneshot``, call site ``scripts/do_oneshot.py:177-187``): a
layer-sequential calibration loop over the port's transformer, with
modifiers as weight / activation transforms. Ported: the engine and RTN
(``QuantizationModifier``), with static activation scales and FP8 KV-cache
scales. GPTQ, AWQ, SmoothQuant, AutoRound and the data-free
``model_free_ptq`` wait for ROADMAP queue 1, slices 7d-7f.
"""

from .engine import (  # noqa: F401
    OneshotResult,
    make_batches,
    oneshot,
    streaming_peak_bytes,
)
