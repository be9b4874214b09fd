"""Core quantization numerics: schemes and INT quant/dequant math."""

from .scheme import (  # noqa: F401
    ActOrder,
    FP4_E2M1_MAX,
    FP4_E2M1_VALUES,
    FP8_E4M3_MAX,
    KV_CACHE_FP8,
    PRESET_SCHEMES,
    QuantizationArgs,
    QuantScheme,
    QuantStrategy,
    QuantType,
    infer_format,
    is_ignored,
    match_targets,
    resolve_scheme,
)
from .numerics import (  # noqa: F401
    QuantizedTensor,
    compute_scale_zp,
    dequantize,
    minmax_along,
    quantize,
)
