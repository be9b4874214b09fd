"""Core quantization numerics: schemes, quantize / dequantize, observers."""

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
    dynamic_quantize_group_fp8,
    dynamic_quantize_token_fp8,
    dynamic_quantize_token_int8,
    fake_quantize,
    minmax_along,
    quantize,
)
