"""Shared utilities (the persistent kernel build cache)."""

from .jitcache import enable_persistent_cache

__all__ = ["enable_persistent_cache"]
