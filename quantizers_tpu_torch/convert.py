"""Carry params across from the JAX package, as numpy arrays.

:func:`params_from_numpy` walks a params tree of dicts and lists whose
leaves are arrays (anything ``np.asarray`` takes) and quantized linears:
any object with ``kind / weight / scale / zero_point / bias / meta``
attributes, or a dict with those keys. Such an object becomes the port's
:class:`~quantizers_tpu_torch.models.moe.ExpertLinears` when it is an
expert stack (it has ``num_experts``, or its weight has a leading expert
axis: three dimensions), else a
:class:`~quantizers_tpu_torch.ops.linear.QuantLinear`. It imports nothing
of the JAX package; the at-rest layouts are the same on both sides.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.moe import ExpertLinears
from .ops.linear import QuantLinear

_LINEAR_FIELDS = ("kind", "weight", "scale", "zero_point", "bias", "meta")


def to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    """An array-like as a tensor on ``device``. bf16 and FP8 E4M3 arrays
    (``ml_dtypes`` types, which ``torch.from_numpy`` refuses) go across as
    their bits."""
    arr = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    elif arr.dtype.kind in "biuf":
        t = torch.from_numpy(arr)
    else:
        raise TypeError(f"no tensor type for array dtype {arr.dtype}")
    return t.to(device)


def _meta_value(v: Any) -> Any:
    # JAX metas may hold 0-d arrays (k, n of a quantized head)
    return v if v is None or isinstance(v, (str, bool)) else int(v)


def _getter(obj: Any):
    return obj.get if isinstance(obj, dict) else (lambda f: getattr(obj, f, None))


def _is_expert_stack(obj: Any) -> bool:
    if hasattr(obj, "num_experts"):
        return True
    w = _getter(obj)("weight")
    return w is not None and len(np.shape(w)) == 3


def _linear(obj: Any, device: torch.device):
    get = _getter(obj)

    def arr(f):
        return None if get(f) is None else to_tensor(get(f), device)

    cls = ExpertLinears if _is_expert_stack(obj) else QuantLinear
    return cls(kind=str(get("kind")), weight=arr("weight"), scale=arr("scale"),
               zero_point=arr("zero_point"), bias=arr("bias"),
               meta=tuple((str(k), _meta_value(v)) for k, v in (get("meta") or ())))


def _is_linear(obj: Any) -> bool:
    if isinstance(obj, dict):
        return all(f in obj for f in ("kind", "weight", "meta"))
    return all(hasattr(obj, f) for f in _LINEAR_FIELDS)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """The port's params on ``device`` from a JAX-side params tree."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if node is None or isinstance(node, (str, int, float, bool)):
            return node
        if _is_linear(node):
            return _linear(node, dev)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return to_tensor(node, dev)

    return walk(tree)
