"""Run-config loading (YAML) — source-compatible with the reference's schema.

Counterpart of ``quantizers_tpu/config.py``, the same code.

A run config names a model, a recipe path and a calibration set
(reference ``src/quantizers/config.py`` and
``configs/test-quantize_qwen3-4b-awq.yaml``)::

    model:
      name: "Qwen/Qwen3-4B"
      revision: "main"
    quantization:
      recipe: "recipes/recipe_awq_w4a16.yaml"
    calibration_set: "configs/calibration_sets/test-calibrate_multi_format.yaml"

Path-resolution rules carried over: the calibration-set path gets ``.yaml``
appended when missing, resolves relative to the run-config file, and a
leading ``configs/`` prefix is dropped to avoid ``configs/configs`` doubling.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

from .data.calibration_sets import CalibrationSetConfig


@dataclass
class ModelConfig:
    name: str
    revision: str = "main"

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ModelConfig":
        return cls(name=data.get("name", ""), revision=data.get("revision", "main"))

    def validate(self) -> None:
        if not self.name:
            raise ValueError("Model name is required")


@dataclass
class QuantizationConfig:
    recipe: str
    calibration_set: Optional[str] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "QuantizationConfig":
        return cls(recipe=data.get("recipe", ""), calibration_set=data.get("calibration_set"))

    def validate(self) -> None:
        if not self.recipe:
            raise ValueError("Recipe path is required")


def _resolve_calib_path(raw: str, config_path: Optional[str]) -> str:
    path = raw if raw.endswith(".yaml") else raw + ".yaml"
    if Path(path).is_absolute() or not config_path:
        return path
    anchor = Path(config_path).parent
    prefix = "configs/"
    if path.startswith(prefix):
        return str(anchor / path[len(prefix):])
    return str(anchor / path)


@dataclass
class QuantizationRunConfig:
    model: ModelConfig
    quantization: QuantizationConfig
    calibration_set_config: Optional[CalibrationSetConfig] = None

    @classmethod
    def from_dict(
        cls, data: Dict[str, Any], config_path: Optional[str] = None
    ) -> "QuantizationRunConfig":
        model = ModelConfig.from_dict(data.get("model", {}))
        quantization = QuantizationConfig.from_dict(data.get("quantization", {}))

        calib_config = None
        calib_ref = quantization.calibration_set or data.get("calibration_set")
        if calib_ref:
            calib_config = CalibrationSetConfig.from_file(_resolve_calib_path(calib_ref, config_path))

        return cls(model=model, quantization=quantization, calibration_set_config=calib_config)

    def validate(self) -> None:
        self.model.validate()
        self.quantization.validate()
        if self.calibration_set_config:
            self.calibration_set_config.validate()


def load_yaml(path: str) -> Dict[str, Any]:
    p = Path(path)
    if not p.exists():
        raise ValueError(f"Config file not found: {path}")
    with open(p) as f:
        return yaml.safe_load(f) or {}


def load_quantization_config(config_path: str) -> QuantizationRunConfig:
    run = QuantizationRunConfig.from_dict(load_yaml(config_path), config_path)
    run.validate()
    return run
