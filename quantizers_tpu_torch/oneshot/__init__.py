"""Oneshot calibration and compression engine.

Counterpart of ``quantizers_tpu/oneshot`` (the reference's
``llmcompressor.oneshot``, call site ``scripts/do_oneshot.py:177-187``): a
layer-sequential calibration loop over the port's transformer, with
modifiers as weight / activation transforms. Ported: the engine, RTN
(``QuantizationModifier``) with static activation scales and FP8 KV-cache
scales, GPTQ (``GPTQModifier``, its column elimination on the K11 kernel),
AWQ (``AWQModifier``) and SmoothQuant (``SmoothQuantModifier``). AutoRound
and the data-free ``model_free_ptq`` wait for ROADMAP queue 1, slice 7f.
"""

from .awq import AWQModifier  # noqa: F401
from .engine import (  # noqa: F401
    OneshotResult,
    make_batches,
    oneshot,
    streaming_peak_bytes,
)
from .gptq import GPTQModifier, gptq_quantize  # noqa: F401
from .modifiers import LayerCtx, Modifier, RTNModifier  # noqa: F401
from .smoothquant import SmoothQuantModifier  # noqa: F401
