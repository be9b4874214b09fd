"""Quantization scheme descriptions.

This is the TPU-native replacement for the scheme axis that the reference
exercises through compressed-tensors recipes (see reference
``configs/recipes/*.yaml`` — e.g. ``recipe_awq_w4a16.yaml:7-32`` and the
mixed-precision config emitted by
``scripts/recombine_weights_MiniMax-M2.1.py:75-138``).

A :class:`QuantizationArgs` captures one quantized tensor's parameters
(bits / int-vs-float / symmetry / strategy / group size / block structure /
dynamic / observer / actorder), and a :class:`QuantScheme` bundles weight,
input-activation and output-activation args — mirroring the on-disk
``config_groups`` schema so checkpoints interop with vLLM's
compressed-tensors reader.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple


class QuantType(str, enum.Enum):
    INT = "int"
    FLOAT = "float"


class QuantStrategy(str, enum.Enum):
    TENSOR = "tensor"
    CHANNEL = "channel"
    GROUP = "group"
    BLOCK = "block"
    TOKEN = "token"
    TENSOR_GROUP = "tensor_group"  # NVFP4: group scales + global tensor scale


class ActOrder(str, enum.Enum):
    NONE = "none"
    GROUP = "group"
    WEIGHT = "weight"


# FP8 E4M3 (finite, fn variant) and FP4 E2M1 dynamic ranges.
FP8_E4M3_MAX = 448.0
FP4_E2M1_MAX = 6.0
# Representable magnitudes of FP4 E2M1.
FP4_E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


@dataclasses.dataclass(frozen=True)
class QuantizationArgs:
    """Parameters for quantizing one tensor (weights or activations)."""

    num_bits: int = 8
    type: QuantType = QuantType.INT
    symmetric: bool = True
    strategy: QuantStrategy = QuantStrategy.TENSOR
    group_size: Optional[int] = None
    block_structure: Optional[Tuple[int, int]] = None
    dynamic: bool = False
    observer: str = "minmax"
    observer_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    actorder: ActOrder = ActOrder.NONE
    # Second-level scale dtype for TENSOR_GROUP (NVFP4) strategies.
    scale_dtype: Optional[str] = None

    def __post_init__(self) -> None:
        if self.strategy == QuantStrategy.GROUP and not self.group_size:
            raise ValueError("group strategy requires a positive group_size")
        if self.strategy == QuantStrategy.TENSOR_GROUP and not self.group_size:
            raise ValueError("tensor_group strategy requires a positive group_size")
        if self.strategy == QuantStrategy.BLOCK and self.block_structure is None:
            raise ValueError("block strategy requires block_structure [rows, cols]")
        if self.type == QuantType.FLOAT and self.num_bits not in (4, 8):
            raise ValueError(f"float quantization supports 4 or 8 bits, got {self.num_bits}")
        if self.type == QuantType.INT and not (2 <= self.num_bits <= 8):
            raise ValueError(f"int quantization supports 2..8 bits, got {self.num_bits}")

    def __hash__(self) -> int:
        # the generated hash would choke on the observer_kwargs dict; args
        # must stay hashable (they ride as jit static_argnames, e.g. the
        # AWQ α-search program cache in oneshot/awq.py:_search_losses).
        # observer_kwargs is hashed through a canonical JSON encoding so
        # unhashable VALUES (a list straight out of a YAML recipe) don't
        # turn a valid recipe into a TypeError deep inside the α-search;
        # block_structure likewise tuple-ized (YAML yields a list).
        import json

        kw = json.dumps(self.observer_kwargs, sort_keys=True, default=str)
        bs = None if self.block_structure is None else tuple(self.block_structure)
        return hash((self.num_bits, self.type, self.symmetric, self.strategy,
                     self.group_size, bs, self.dynamic,
                     self.observer, kw, self.actorder, self.scale_dtype))

    # ---- value range -----------------------------------------------------
    @property
    def qrange(self) -> Tuple[float, float]:
        """(qmin, qmax) of the quantized integer / float grid."""
        if self.type == QuantType.INT:
            if self.symmetric:
                return (-(2 ** (self.num_bits - 1)), 2 ** (self.num_bits - 1) - 1)
            return (0.0, 2**self.num_bits - 1)
        if self.num_bits == 8:
            return (-FP8_E4M3_MAX, FP8_E4M3_MAX)
        return (-FP4_E2M1_MAX, FP4_E2M1_MAX)

    @property
    def scale_divisor(self) -> float:
        """absmax / scale_divisor == scale (symmetric case).

        Follows the compressed-tensors convention: for int types the
        divisor is (qmax - qmin) / 2 (e.g. 7.5 for int4), for float types
        the max representable magnitude (448 for e4m3, 6 for e2m1).
        """
        qmin, qmax = self.qrange
        if self.type == QuantType.INT:
            return (qmax - qmin) / 2.0
        return qmax

    # ---- (de)serialization ------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "num_bits": self.num_bits,
            "type": self.type.value,
            "symmetric": self.symmetric,
            "strategy": self.strategy.value,
            "group_size": self.group_size,
            "block_structure": list(self.block_structure) if self.block_structure else None,
            "dynamic": self.dynamic,
            "observer": None if self.dynamic else self.observer,
            "observer_kwargs": dict(self.observer_kwargs),
            "actorder": None if self.actorder == ActOrder.NONE else self.actorder.value,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "QuantizationArgs":
        if data is None:
            raise ValueError("cannot build QuantizationArgs from None")
        block = data.get("block_structure")
        if isinstance(block, str):
            # accept "128x128" spelling
            block = tuple(int(p) for p in block.split("x"))
        elif block is not None:
            block = tuple(int(p) for p in block)
        actorder = data.get("actorder")
        if actorder in (None, False, "none", "None"):
            actorder_e = ActOrder.NONE
        else:
            actorder_e = ActOrder(actorder if isinstance(actorder, str) else "group")
        observer = data.get("observer") or "minmax"
        return cls(
            num_bits=int(data.get("num_bits", 8)),
            type=QuantType(data.get("type", "int")),
            symmetric=bool(data.get("symmetric", True)),
            strategy=QuantStrategy(data.get("strategy", "tensor")),
            group_size=data.get("group_size"),
            block_structure=block,
            dynamic=bool(data.get("dynamic", False)),
            observer=observer,
            observer_kwargs=data.get("observer_kwargs") or {},
            actorder=actorder_e,
            scale_dtype=data.get("scale_dtype"),
        )


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """One config group: which tensors get quantized and how."""

    targets: Tuple[str, ...] = ("Linear",)
    weights: Optional[QuantizationArgs] = None
    input_activations: Optional[QuantizationArgs] = None
    output_activations: Optional[QuantizationArgs] = None
    format: Optional[str] = None  # compressed-tensors format name override

    def to_dict(self) -> Dict[str, Any]:
        return {
            "targets": list(self.targets),
            "weights": self.weights.to_dict() if self.weights else None,
            "input_activations": self.input_activations.to_dict() if self.input_activations else None,
            "output_activations": self.output_activations.to_dict() if self.output_activations else None,
            "format": self.format or infer_format(self),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "QuantScheme":
        targets = data.get("targets", ["Linear"])
        if isinstance(targets, str):
            targets = [targets]

        def _maybe(key: str) -> Optional[QuantizationArgs]:
            sub = data.get(key)
            return QuantizationArgs.from_dict(sub) if sub else None

        return cls(
            targets=tuple(targets),
            weights=_maybe("weights"),
            input_activations=_maybe("input_activations"),
            output_activations=_maybe("output_activations"),
            format=data.get("format"),
        )


def infer_format(scheme: QuantScheme) -> str:
    """Infer the compressed-tensors serialization format for a scheme."""
    w = scheme.weights
    if w is None:
        return "dense"
    if w.type == QuantType.FLOAT:
        if w.num_bits == 4:
            return "nvfp4-pack-quantized"
        return "float-quantized"
    if w.num_bits < 8:
        return "pack-quantized"
    return "int-quantized"


# ---------------------------------------------------------------------------
# Named scheme presets — the strings a recipe's `scheme:` field accepts
# (reference usage: `recipe_Dense_NVFP4.yaml:9`, `main_seed-oss-fp8.py:31-33`,
# `quant_GLM-4.7-Flash-FP8.py:16` FP8_BLOCK).
# ---------------------------------------------------------------------------

def _w4a16(group_size: int, actorder: ActOrder = ActOrder.NONE) -> QuantScheme:
    return QuantScheme(
        weights=QuantizationArgs(
            num_bits=4,
            type=QuantType.INT,
            symmetric=True,
            strategy=QuantStrategy.GROUP,
            group_size=group_size,
            observer="minmax",
            actorder=actorder,
        )
    )


PRESET_SCHEMES: Dict[str, QuantScheme] = {
    "W4A16": _w4a16(128),
    "W4A16_G32": _w4a16(32),
    "W4A16_G64": _w4a16(64),
    "W4A16_G128": _w4a16(128),
    "W8A16": QuantScheme(
        weights=QuantizationArgs(num_bits=8, type=QuantType.INT, strategy=QuantStrategy.CHANNEL)
    ),
    "W8A8": QuantScheme(
        weights=QuantizationArgs(num_bits=8, type=QuantType.INT, strategy=QuantStrategy.CHANNEL),
        input_activations=QuantizationArgs(
            num_bits=8, type=QuantType.INT, strategy=QuantStrategy.TOKEN, dynamic=True
        ),
    ),
    "FP8": QuantScheme(
        weights=QuantizationArgs(num_bits=8, type=QuantType.FLOAT, strategy=QuantStrategy.TENSOR),
        input_activations=QuantizationArgs(
            num_bits=8, type=QuantType.FLOAT, strategy=QuantStrategy.TENSOR
        ),
    ),
    "FP8_DYNAMIC": QuantScheme(
        weights=QuantizationArgs(num_bits=8, type=QuantType.FLOAT, strategy=QuantStrategy.CHANNEL),
        input_activations=QuantizationArgs(
            num_bits=8, type=QuantType.FLOAT, strategy=QuantStrategy.TOKEN, dynamic=True
        ),
    ),
    "FP8_BLOCK": QuantScheme(
        weights=QuantizationArgs(
            num_bits=8,
            type=QuantType.FLOAT,
            strategy=QuantStrategy.BLOCK,
            block_structure=(128, 128),
        ),
        input_activations=QuantizationArgs(
            num_bits=8,
            type=QuantType.FLOAT,
            strategy=QuantStrategy.GROUP,
            group_size=128,
            dynamic=True,
        ),
    ),
    "NVFP4": QuantScheme(
        weights=QuantizationArgs(
            num_bits=4,
            type=QuantType.FLOAT,
            symmetric=True,
            strategy=QuantStrategy.TENSOR_GROUP,
            group_size=16,
            scale_dtype="float8_e4m3fn",
        ),
    ),
    "NVFP4A16": QuantScheme(
        weights=QuantizationArgs(
            num_bits=4,
            type=QuantType.FLOAT,
            symmetric=True,
            strategy=QuantStrategy.TENSOR_GROUP,
            group_size=16,
            scale_dtype="float8_e4m3fn",
        ),
    ),
}

# KV-cache scheme (reference: `main_seed-oss-fp8-kv8.py:168-202` builds a
# per-tensor FP8 kv_cache_scheme).
KV_CACHE_FP8 = QuantizationArgs(
    num_bits=8, type=QuantType.FLOAT, strategy=QuantStrategy.TENSOR, symmetric=True
)


def resolve_scheme(name_or_dict: Any) -> QuantScheme:
    """Resolve a recipe `scheme:` value — preset name or inline dict."""
    if isinstance(name_or_dict, str):
        key = name_or_dict.upper()
        if key not in PRESET_SCHEMES:
            raise ValueError(f"Unknown scheme preset: {name_or_dict!r}. Known: {sorted(PRESET_SCHEMES)}")
        return PRESET_SCHEMES[key]
    if isinstance(name_or_dict, dict):
        return QuantScheme.from_dict(name_or_dict)
    raise TypeError(f"scheme must be a preset name or dict, got {type(name_or_dict)}")


def match_targets(module_path: str, module_type: str, targets: List[str]) -> bool:
    """compressed-tensors style target matching.

    ``"Linear"`` matches by module type; ``"re:<pattern>"`` matches the
    module path with an (unanchored) regex search, mirroring how the
    reference's recipes address layers (`recipe_MoE_RTN_NVFP4.yaml:19-21`).
    Plain strings match as path suffixes.
    """
    import re as _re

    for t in targets:
        if t == module_type:
            return True
        if t.startswith("re:"):
            if _re.match(t[3:], module_path):
                return True
        elif module_path == t or module_path.endswith("." + t) or module_path.endswith(t):
            return True
    return False


def is_ignored(module_path: str, ignore: List[str]) -> bool:
    return match_targets(module_path, "", list(ignore or []))
