"""Artifact tools: mixed-precision weight surgery, checkpoint utilities."""

from .recombine import MergeStats, ModelMerger  # noqa: F401
