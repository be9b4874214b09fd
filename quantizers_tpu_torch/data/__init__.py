"""Tokenizers: the byte-level fallback, tekken, and ``load_tokenizer``.

The calibration-set engine and formatters of the JAX package's ``data``
layer wait for ROADMAP slice 6."""

from .simple_tokenizer import ByteTokenizer, load_tokenizer  # noqa: F401
from .tekken import TekkenTokenizer  # noqa: F401
