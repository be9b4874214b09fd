"""Oneshot calibration and compression engine.

Counterpart of ``quantizers_tpu/oneshot`` (the reference's
``llmcompressor.oneshot``, call site ``scripts/do_oneshot.py:177-187``): a
layer-sequential calibration loop over the port's transformer, with
modifiers as weight / activation transforms. The engine runs
RTN (``QuantizationModifier``) with static activation scales and FP8
KV-cache scales, GPTQ (``GPTQModifier``, its column elimination on the K11
kernel), AWQ (``AWQModifier``), SmoothQuant (``SmoothQuantModifier``) and
AutoRound (``AutoRoundModifier``, learned rounding on the weights' device);
``model_free_ptq`` quantizes a checkpoint shard by shard with no
calibration data.
"""

from .autoround import AutoRoundModifier, autoround_quantize  # noqa: F401
from .awq import AWQModifier  # noqa: F401
from .engine import (  # noqa: F401
    OneshotResult,
    make_batches,
    oneshot,
    streaming_peak_bytes,
)
from .gptq import GPTQModifier, gptq_quantize  # noqa: F401
from .model_free import model_free_ptq  # noqa: F401
from .modifiers import LayerCtx, Modifier, RTNModifier  # noqa: F401
from .smoothquant import SmoothQuantModifier  # noqa: F401
