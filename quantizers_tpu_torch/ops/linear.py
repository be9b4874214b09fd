"""Quantized linear layers as plain dataclasses of tensors.

Counterpart of ``quantizers_tpu/ops/linear.py``. A :class:`QuantLinear`
holds the payload in the same at-rest layouts as the JAX package, so
weights cross between the two as plain numpy arrays
(HF weights are ``(out_features, in_features)`` = (N, K)):

* ``w4``   — packed uint8 ``(K//2, N)``, split-half: the low nibble of row
  ``p`` holds ``W[p, n] + 8``, the high nibble ``W[K//2 + p, n] + 8``.
  Scales ``(K//g, N)``; optional zero points ``(K//g, N)`` int8.
* ``w8``   — int8 ``(K, N)``; per-channel ``(1, N)`` or per-group scales.
* ``dense``— bf16/f32 ``(K, N)``.

``fp8`` and ``nvfp4`` arrive with their port slices. The TPU's signed-int4
relayout (``i4_device_layout``) has no counterpart: the CUDA kernel reads
the packed bytes directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.numerics import QuantizedTensor
from ..core.scheme import QuantizationArgs, QuantStrategy, QuantType

_LATER_KINDS = {
    "fp8": "ROADMAP queue 1, slice 5 (MLA and FP8)",
    "nvfp4": "ROADMAP queue 1, slice 4 (NVFP4 and MoE)",
}


def _later(kind: str) -> NotImplementedError:
    return NotImplementedError(f"{kind} linears are not ported yet: {_LATER_KINDS[kind]}")


def _group_scaled(vals: torch.Tensor, scale: torch.Tensor,
                  zero_point: Optional[torch.Tensor], g: int, k: int, n: int
                  ) -> torch.Tensor:
    """Apply per-group scales (and zero points) to (k, n) f32 values.

    Groups are the nominal ``g`` rows each: the last may cover fewer real
    rows (K % g != 0), and a K < g weight has exactly one group."""
    r = scale.shape[0]
    pad = r * g - k
    if pad < 0:
        raise ValueError(f"scale rows {r} x group {g} < K {k}")
    if pad:
        vals = F.pad(vals, (0, 0, 0, pad))
    vals = vals.reshape(r, g, n)
    if zero_point is not None:
        vals = vals - zero_point[:, None, :].float()
    w = vals * scale[:, None, :].float()
    return w.reshape(r * g, n)[:k]


def _unpack_nibbles(packed: torch.Tensor, signed_offset: int = 8) -> torch.Tensor:
    """uint8 (K//2, N) split-half packed -> int8 (K, N)."""
    lo = (packed & 0x0F).to(torch.int8) - signed_offset
    hi = ((packed >> 4) & 0x0F).to(torch.int8) - signed_offset
    return torch.cat([lo, hi], dim=0)


def _pack_nibbles_np(vals: np.ndarray, offset: int = 8) -> np.ndarray:
    """int values (K, N) -> uint8 (K//2, N), split-half order: low nibble
    row p = vals[p], high nibble = vals[K//2 + p]."""
    u = (vals.astype(np.int16) + offset).astype(np.uint8)
    if u.shape[0] % 2:
        u = np.pad(u, ((0, 1), (0, 0)))
    half = u.shape[0] // 2
    return (u[:half] | (u[half:] << 4)).astype(np.uint8)


@dataclasses.dataclass
class QuantLinear:
    """A (possibly) quantized linear weight: tensors plus static ``meta``."""

    kind: str  # dense | w4 | w8 (fp8 | nvfp4 in later slices)
    weight: torch.Tensor
    scale: Optional[torch.Tensor] = None
    zero_point: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    meta: Tuple[Tuple[str, Any], ...] = ()

    @property
    def meta_dict(self) -> Dict[str, Any]:
        return dict(self.meta)

    @property
    def out_features(self) -> int:
        return int(self.meta_dict["n"])

    @property
    def in_features(self) -> int:
        return int(self.meta_dict["k"])

    def to(self, device) -> "QuantLinear":
        """The same linear with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(self, weight=mv(self.weight), scale=mv(self.scale),
                                   zero_point=mv(self.zero_point), bias=mv(self.bias))

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Materialize W^T as (K, N) in ``dtype``."""
        md = self.meta_dict
        k, n = int(md["k"]), int(md["n"])
        if self.kind == "dense":
            return self.weight.to(dtype)
        if self.kind == "w4":
            vals = _unpack_nibbles(self.weight).float()[:k]
            return _group_scaled(vals, self.scale, self.zero_point,
                                 int(md["group_size"]), k, n).to(dtype)
        if self.kind == "w8":
            vals = self.weight.float()
            g = md.get("group_size")
            if g:
                return _group_scaled(vals[:k], self.scale, self.zero_point,
                                     int(g), k, n).to(dtype)
            if self.zero_point is not None:
                vals = vals - self.zero_point.float()
            return (vals * self.scale.float()).to(dtype)
        if self.kind in _LATER_KINDS:
            raise _later(self.kind)
        raise ValueError(f"unknown QuantLinear kind {self.kind}")

    def apply(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        """``x @ W^T (+ bias)``; x (..., K) -> (..., N)."""
        from .dispatch import quant_matmul

        y = quant_matmul(x, self, use_kernel=use_kernel)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    __call__ = apply


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _as_tensor(a: Any, device=None, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device if device is not None else t.device, dtype=dtype)


def dense_linear(weight_nk: Any, bias: Optional[Any] = None, device=None) -> QuantLinear:
    """From an HF (N, K) weight -> bf16 dense layout (K, N)."""
    w = _as_tensor(weight_nk, device, torch.bfloat16).t().contiguous()
    k, n = w.shape
    b = None if bias is None else _as_tensor(bias, w.device, torch.bfloat16)
    return QuantLinear(kind="dense", weight=w, bias=b, meta=(("k", k), ("n", n)))


def from_quantized(qt: QuantizedTensor, args: QuantizationArgs,
                   bias: Optional[Any] = None) -> QuantLinear:
    """Build the at-rest layout from a :class:`QuantizedTensor` whose values
    are in the HF (N, K) orientation, with bf16 scales. The relayout runs
    on the values' device. (The W8A8 activation meta of the JAX package
    waits for its compute path, ROADMAP queue 1 item 13.)"""
    n, k = qt.shape
    values = qt.values
    dev = values.device
    scale = qt.scale.float()
    b = None if bias is None else _as_tensor(bias, dev, torch.bfloat16)

    if args.type == QuantType.INT and args.num_bits == 4:
        u = (values.t().to(torch.int16) + 8).to(torch.uint8)  # (K, N)
        if u.shape[0] % 2:
            u = F.pad(u, (0, 0, 0, 1))
        half = u.shape[0] // 2
        packed = (u[:half] | (u[half:] << 4)).contiguous()
        zp = None if qt.zero_point is None else qt.zero_point.t().to(torch.int8).contiguous()
        return QuantLinear(
            kind="w4", weight=packed, scale=scale.t().to(torch.bfloat16).contiguous(),
            zero_point=zp, bias=b,
            meta=(("k", k), ("n", n), ("group_size", int(args.group_size or k))))

    if args.type == QuantType.INT and args.num_bits == 8:
        w8 = values.t().to(torch.int8).contiguous()
        meta: Tuple[Tuple[str, Any], ...]
        if args.strategy == QuantStrategy.GROUP:
            meta = (("k", k), ("n", n), ("group_size", int(args.group_size)))
            scale_t = scale.t()
        else:  # channel: (N, 1) -> (1, N)
            meta = (("k", k), ("n", n), ("group_size", None))
            scale_t = scale.reshape(n, -1).t()
        zp = None
        if qt.zero_point is not None:
            zpd = qt.zero_point
            zp = (zpd.t() if zpd.ndim == 2 and zpd.shape[1] > 1
                  else zpd.reshape(n, -1).t()).to(torch.int8).contiguous()
        return QuantLinear(kind="w8", weight=w8, scale=scale_t.to(torch.bfloat16).contiguous(),
                           zero_point=zp, bias=b, meta=meta)

    if args.type == QuantType.FLOAT:
        raise _later("fp8" if args.num_bits == 8 else "nvfp4")
    raise ValueError(f"no layout for args {args}")


def concat_linears(lins: list) -> QuantLinear:
    """Concatenate linears sharing the same input along the output axis —
    the fused-QKV / fused-GateUp layout. Every layout keeps N trailing, so
    fusion is an axis-1 concat."""
    if len(lins) == 1:
        return lins[0]
    first = lins[0]
    md0 = dict(first.meta)
    for lin in lins[1:]:
        md = dict(lin.meta)
        if lin.kind != first.kind or md.get("k") != md0.get("k"):
            raise ValueError("fusion requires same kind and in_features")
        for key in md0:
            if key != "n" and md.get(key) != md0.get(key):
                raise ValueError(f"fusion requires matching meta ({key})")
    n_total = sum(int(dict(lin.meta)["n"]) for lin in lins)

    def cat(field: str, dim: int = 1):
        vals = [getattr(lin, field) for lin in lins]
        if all(v is None for v in vals):
            return None
        if any(v is None for v in vals):
            raise ValueError(f"fusion: mixed None/non-None {field}")
        return torch.cat(vals, dim=dim)

    meta = tuple((key, v) if key != "n" else ("n", n_total) for key, v in first.meta)
    return QuantLinear(kind=first.kind, weight=cat("weight"), scale=cat("scale"),
                       zero_point=cat("zero_point"), bias=cat("bias", dim=0), meta=meta)
