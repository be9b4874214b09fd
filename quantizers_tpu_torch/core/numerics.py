"""Quantization numerics in PyTorch: INT scale solving, quantize, dequantize.

Counterpart of ``quantizers_tpu/core/numerics.py`` for the INT strategies
(tensor, channel, group, token). FP8 and NVFP4 (``tensor_group``) arrive
with their own port slices. Weights follow the HF ``(out, in)`` convention;
reduction for scales is along ``in`` unless the strategy says otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .scheme import QuantizationArgs, QuantStrategy, QuantType


class QuantizedTensor(NamedTuple):
    """Quantized values (int8 for INT schemes) plus what dequantizes them."""

    values: torch.Tensor
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor]
    global_scale: Optional[torch.Tensor]
    shape: Tuple[int, ...]  # original (unpadded) shape


def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pads = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards
    pads[2 * (x.ndim - 1 - axis) + 1] = rem
    return F.pad(x, pads)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero. ``torch.round`` rounds half to even
    (0.5 -> 0, 2.5 -> 2), which would change codes on exact ties."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _not_int(args: QuantizationArgs) -> NotImplementedError:
    return NotImplementedError(
        f"{args.type.value}{args.num_bits} numerics are not ported yet "
        "(FP8 and NVFP4 land with their ROADMAP slices)")


def compute_scale_zp(min_val: torch.Tensor, max_val: torch.Tensor,
                     args: QuantizationArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) from min/max, compressed-tensors convention."""
    qmin, qmax = args.qrange
    eps = torch.finfo(torch.float32).tiny
    min_val = torch.clamp(min_val.float(), max=0.0)
    max_val = torch.clamp(max_val.float(), min=0.0)
    if args.symmetric:
        absmax = torch.maximum(min_val.abs(), max_val.abs())
        scale = torch.clamp(absmax / args.scale_divisor, min=eps)
        zp = torch.zeros_like(scale, dtype=torch.int32)
    else:
        scale = torch.clamp((max_val - min_val) / (qmax - qmin), min=eps)
        zp = _round_half_away(qmin - min_val / scale).to(torch.int32)
        zp = torch.clamp(zp, qmin, qmax)
    return scale, zp


def _grouped(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """(out, in) -> (out, n_groups, group_size), padding in-dim if needed."""
    out_f = w.shape[0]
    return _pad_axis(w, 1, group_size).reshape(out_f, -1, group_size)


def minmax_along(w: torch.Tensor, args: QuantizationArgs
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-strategy (min, max) reduction."""
    s = args.strategy
    if s == QuantStrategy.TENSOR:
        return w.min(), w.max()
    if s in (QuantStrategy.CHANNEL, QuantStrategy.TOKEN):
        return w.amin(dim=-1, keepdim=True), w.amax(dim=-1, keepdim=True)
    if s == QuantStrategy.GROUP:
        g = _grouped(w, int(args.group_size))
        return g.amin(dim=-1), g.amax(dim=-1)
    raise NotImplementedError(f"strategy {s.value} is not ported yet")


def _snap(x: torch.Tensor, args: QuantizationArgs) -> torch.Tensor:
    """Round a scaled tensor onto the INT grid."""
    if args.type != QuantType.INT:
        raise _not_int(args)
    qmin, qmax = args.qrange
    return torch.clamp(_round_half_away(x), qmin, qmax)


def quantize(w: torch.Tensor, args: QuantizationArgs,
             scale: Optional[torch.Tensor] = None,
             zero_point: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize ``w`` under INT ``args``; solves min/max scales if not given."""
    if args.type != QuantType.INT:
        raise _not_int(args)
    if args.observer and "mse" in args.observer:
        raise NotImplementedError("the mse observer lands with the calibration slice")
    orig_shape = tuple(w.shape)
    w = w.float()
    s = args.strategy
    if scale is None:
        mn, mx = minmax_along(w, args)
        scale, zero_point = compute_scale_zp(mn, mx, args)

    if s in (QuantStrategy.TENSOR, QuantStrategy.CHANNEL, QuantStrategy.TOKEN):
        x = w / scale
        if not args.symmetric:
            x = x + zero_point
        q = _snap(x, args)
    elif s == QuantStrategy.GROUP:
        g = _grouped(w, int(args.group_size))
        x = g / scale[..., None]
        if not args.symmetric:
            x = x + zero_point[..., None]
        q = _snap(x, args).reshape(orig_shape[0], -1)[:, : orig_shape[1]]
    else:
        raise NotImplementedError(f"strategy {s.value} is not ported yet")
    return QuantizedTensor(q.to(torch.int8), scale,
                           zero_point if not args.symmetric else None, None, orig_shape)


def dequantize(qt: QuantizedTensor, args: QuantizationArgs) -> torch.Tensor:
    """Dequantize back to float32."""
    q = qt.values.float()
    scale = qt.scale.float()
    s = args.strategy
    if s in (QuantStrategy.TENSOR, QuantStrategy.CHANNEL, QuantStrategy.TOKEN):
        if qt.zero_point is not None:
            q = q - qt.zero_point
        return q * scale
    if s == QuantStrategy.GROUP:
        g = _grouped(q, int(args.group_size))
        if qt.zero_point is not None:
            g = g - qt.zero_point[..., None]
        w = g * scale[..., None]
        return w.reshape(qt.shape[0], -1)[:, : qt.shape[1]]
    raise NotImplementedError(f"strategy {s.value} is not ported yet")
