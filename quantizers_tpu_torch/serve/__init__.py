"""Serving layer: prefill and decode over in-place KV caches, and the
continuous batcher."""

from .engine import generate, perplexity, prefill  # noqa: F401
from .session import ContinuousBatcher, serving_layout  # noqa: F401
