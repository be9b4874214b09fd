"""The data layer: the calibration-set engine and its formatters, and the
tokenizers (the byte-level fallback, tekken, ``load_tokenizer``).

``CalibrationSet`` reads its datasets through HF ``datasets``, imported
only when a set is built, loaded from its cache or tokenized."""

from .calibration_sets import (  # noqa: F401
    STREAMING_DEFAULT_SAMPLE_LIMIT,
    CalibrationSet,
    CalibrationSetConfig,
    DatasetEntryConfig,
)
from .formatters import DatasetFmt, available_formatters, formatter, get_formatter  # noqa: F401
from .simple_tokenizer import ByteTokenizer, load_tokenizer  # noqa: F401
from .tekken import TekkenTokenizer  # noqa: F401
