"""Quantization numerics in PyTorch: scale solving, quantize, dequantize.

Counterpart of ``quantizers_tpu/core/numerics.py`` for the INT and FP8
E4M3 strategies (tensor, channel, group, block, token) and NVFP4
(``tensor_group``: E2M1 values with 16-wide group scales snapped to FP8
E4M3 under an f32 global scale). Weights follow the HF ``(out, in)``
convention; reduction for scales is along ``in`` unless the strategy says
otherwise.

Every division by a constant divides by a tensor of it: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, which would move
codes on the card against the CPU and the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .scheme import FP4_E2M1_MAX, FP8_E4M3_MAX, QuantizationArgs, QuantStrategy, QuantType


class QuantizedTensor(NamedTuple):
    """Quantized values (int8 for INT schemes) plus what dequantizes them."""

    values: torch.Tensor  # int8 codes (INT) or f32 grid values (NVFP4)
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor]
    global_scale: Optional[torch.Tensor]  # NVFP4 second-level scale
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


def quantize_to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round values to the FP8 E4M3 grid (clipped to +-448), as f32. The
    cast rounds to nearest, ties to even, as ml_dtypes does."""
    clipped = torch.clamp(x.float(), -FP8_E4M3_MAX, FP8_E4M3_MAX)
    return clipped.to(torch.float8_e4m3fn).float()


def quantize_to_fp4(x: torch.Tensor) -> torch.Tensor:
    """Round values to the FP4 E2M1 grid {0, +-.5, +-1, +-1.5, +-2, +-3, +-4,
    +-6}; a magnitude on a midpoint goes to the smaller neighbour."""
    a = torch.abs(x)
    q = torch.full_like(a, 6.0)
    # midpoints between neighbours, largest first, so the smallest wins
    for mid, val in ((5.0, 4.0), (3.5, 3.0), (2.5, 2.0), (1.75, 1.5),
                     (1.25, 1.0), (0.75, 0.5), (0.25, 0.0)):
        q = torch.where(a <= mid, torch.full_like(a, val), q)
    return torch.sign(x) * q


def compute_global_scale(w: torch.Tensor, args: QuantizationArgs) -> torch.Tensor:
    """NVFP4 second-level scale: 448 * 6 / absmax(tensor), f32, so that the
    group scales map into the FP8 E4M3 range."""
    absmax = torch.clamp(torch.max(torch.abs(w.float())), min=torch.finfo(torch.float32).tiny)
    # a true division: ``scalar / tensor`` would multiply by a reciprocal
    return torch.full_like(absmax, FP8_E4M3_MAX * FP4_E2M1_MAX) / absmax


def compute_scale_zp(min_val: torch.Tensor, max_val: torch.Tensor,
                     args: QuantizationArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) from min/max, compressed-tensors convention."""
    qmin, qmax = args.qrange
    eps = torch.finfo(torch.float32).tiny
    min_val = torch.clamp(min_val.float(), max=0.0)
    max_val = torch.clamp(max_val.float(), min=0.0)
    if args.symmetric:
        absmax = torch.maximum(min_val.abs(), max_val.abs())
        scale = torch.clamp(absmax / torch.full_like(absmax, args.scale_divisor), min=eps)
        zp = torch.zeros_like(scale, dtype=torch.int32)
    else:
        span = max_val - min_val
        scale = torch.clamp(span / torch.full_like(span, qmax - qmin), min=eps)
        zp = _round_half_away(qmin - min_val / scale).to(torch.int32)
        zp = torch.clamp(zp, qmin, qmax)
    return scale, zp


def _grouped(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """(out, in) -> (out, n_groups, group_size), padding in-dim if needed."""
    out_f = w.shape[0]
    return _pad_axis(w, 1, group_size).reshape(out_f, -1, group_size)


def _blocked(w: torch.Tensor, block: Tuple[int, int]) -> torch.Tensor:
    """(out, in) -> (nbr, nbc, br, bc) block view, padded."""
    br, bc = block
    w = _pad_axis(_pad_axis(w, 0, br), 1, bc)
    o, i = w.shape
    return w.reshape(o // br, br, i // bc, bc).permute(0, 2, 1, 3)


def _unblocked(b: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """(nbr, nbc, br, bc) -> the (out, in) tensor of ``shape``."""
    nbr, nbc, br, bc = b.shape
    return b.permute(0, 2, 1, 3).reshape(nbr * br, nbc * bc)[: shape[0], : shape[1]]


def minmax_along(w: torch.Tensor, args: QuantizationArgs
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-strategy (min, max) reduction."""
    s = args.strategy
    if s == QuantStrategy.TENSOR:
        return w.min(), w.max()
    if s in (QuantStrategy.CHANNEL, QuantStrategy.TOKEN):
        return w.amin(dim=-1, keepdim=True), w.amax(dim=-1, keepdim=True)
    if s in (QuantStrategy.GROUP, QuantStrategy.TENSOR_GROUP):
        g = _grouped(w, int(args.group_size))
        return g.amin(dim=-1), g.amax(dim=-1)
    if s == QuantStrategy.BLOCK:
        b = _blocked(w, tuple(args.block_structure))
        return b.amin(dim=(-1, -2)), b.amax(dim=(-1, -2))
    raise NotImplementedError(f"strategy {s.value} is not ported yet")


def _snap(x: torch.Tensor, args: QuantizationArgs) -> torch.Tensor:
    """Round a scaled tensor onto the INT, FP8 E4M3 or FP4 E2M1 grid."""
    if args.type == QuantType.INT:
        qmin, qmax = args.qrange
        return torch.clamp(_round_half_away(x), qmin, qmax)
    if args.num_bits == 8:
        return quantize_to_fp8(x)
    return quantize_to_fp4(x)


def _quantize_nvfp4(w: torch.Tensor, args: QuantizationArgs,
                    scale: Optional[torch.Tensor],
                    global_scale: Optional[torch.Tensor]) -> QuantizedTensor:
    """The ``tensor_group`` branch of :func:`quantize`, in the JAX package's
    order of f32 operations."""
    orig_shape = tuple(w.shape)
    if global_scale is None:
        global_scale = compute_global_scale(w, args)
    g = _grouped(w, int(args.group_size))
    if scale is None:
        amax = torch.amax(torch.abs(g), dim=-1)
        raw_scale = amax / torch.full_like(amax, FP4_E2M1_MAX)  # a true division
        # the scale lives on the FP8 grid (its on-disk dtype)
        scale = quantize_to_fp8(raw_scale * global_scale)
    eff = torch.clamp(scale / global_scale, min=torch.finfo(torch.float32).tiny)
    q = quantize_to_fp4(g / eff[..., None])
    q = q.reshape(orig_shape[0], -1)[:, : orig_shape[1]]
    return QuantizedTensor(q, scale, None, global_scale, orig_shape)


def quantize(w: torch.Tensor, args: QuantizationArgs,
             scale: Optional[torch.Tensor] = None,
             zero_point: Optional[torch.Tensor] = None,
             global_scale: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize ``w`` under INT, FP8 or NVFP4 (``tensor_group``) ``args``;
    solves the scales if not given: min/max, the ``mse`` observer's search
    (:func:`_mse_scale_zp`), or NVFP4's absmax and global scale. FP8
    values come back as f32 numbers on the E4M3 grid, as in the JAX
    package."""
    if args.strategy == QuantStrategy.TENSOR_GROUP:
        return _quantize_nvfp4(w.float(), args, scale, global_scale)
    orig_shape = tuple(w.shape)
    w = w.float()
    s = args.strategy
    if scale is None:
        if args.observer and "mse" in args.observer:
            scale, zero_point = _mse_scale_zp(w, args)
        else:
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
    elif s == QuantStrategy.BLOCK:
        b = _blocked(w, tuple(args.block_structure))
        x = b / scale[..., None, None]
        if not args.symmetric:
            x = x + zero_point[..., None, None]
        q = _unblocked(_snap(x, args), orig_shape)
    else:
        raise NotImplementedError(f"strategy {s.value} is not ported yet")
    if args.type == QuantType.INT:
        q = q.to(torch.int8)
    return QuantizedTensor(q, scale,
                           zero_point if not args.symmetric else None, None, orig_shape)


def dequantize(qt: QuantizedTensor, args: QuantizationArgs) -> torch.Tensor:
    """Dequantize back to float32."""
    q = qt.values.float()
    scale = qt.scale.float()
    s = args.strategy
    if s == QuantStrategy.TENSOR_GROUP:
        g = _grouped(q, int(args.group_size))
        w = g * (scale / qt.global_scale)[..., None]
        return w.reshape(qt.shape[0], -1)[:, : qt.shape[1]]
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
    if s == QuantStrategy.BLOCK:
        b = _blocked(q, tuple(args.block_structure))
        if qt.zero_point is not None:
            b = b - qt.zero_point[..., None, None]
        return _unblocked(b * scale[..., None, None], qt.shape)
    raise NotImplementedError(f"strategy {s.value} is not ported yet")


def _reduce_err_to_scale(err: torch.Tensor, args: QuantizationArgs) -> torch.Tensor:
    """Sum a per-element error tensor down to the scale grid's shape."""
    s = args.strategy
    if s == QuantStrategy.TENSOR:
        return torch.sum(err)
    if s in (QuantStrategy.CHANNEL, QuantStrategy.TOKEN):
        return torch.sum(err, dim=-1, keepdim=True)
    if s == QuantStrategy.GROUP:
        return torch.sum(_grouped(err, int(args.group_size)), dim=-1)
    if s == QuantStrategy.BLOCK:
        return torch.sum(_blocked(err, tuple(args.block_structure)), dim=(-1, -2))
    raise ValueError(f"mse observer unsupported for strategy {s}")


#: the ``mse`` observer's search: MSE_GRID clip ratios in (MSE_SHRINK_MIN, 1]
MSE_GRID, MSE_SHRINK_MIN = 12, 0.4


def _mse_scale_zp(w: torch.Tensor, args: QuantizationArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data-aware ``mse`` observer: per scale cell, the clip ratio on the
    min/max envelope with the least quantization error, among ``MSE_GRID``
    ratios in (MSE_SHRINK_MIN, 1]; the first of equal errors wins. The ratio
    multiplies as an f32 number, as in the JAX package."""
    w = w.float()
    mn0, mx0 = minmax_along(w, args)
    best_scale = best_zp = best_err = None
    for i in range(MSE_GRID):
        r = MSE_SHRINK_MIN + (1.0 - MSE_SHRINK_MIN) * (i + 1) / MSE_GRID
        s_i, zp_i = compute_scale_zp(mn0 * torch.full_like(mn0, r),
                                     mx0 * torch.full_like(mx0, r), args)
        qt = quantize(w, args, scale=s_i, zero_point=None if args.symmetric else zp_i)
        d = dequantize(qt, args) - w
        err = _reduce_err_to_scale(d * d, args)
        if best_err is None:
            best_scale, best_zp, best_err = s_i, zp_i, err
        else:
            better = err < best_err
            best_scale = torch.where(better, s_i, best_scale)
            best_zp = torch.where(better, zp_i, best_zp)
            best_err = torch.minimum(err, best_err)
    return best_scale, best_zp


def fake_quantize(w: torch.Tensor, args: QuantizationArgs,
                  scale: Optional[torch.Tensor] = None,
                  zero_point: Optional[torch.Tensor] = None,
                  global_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """quantize -> dequantize, back in ``w``'s dtype (QDQ)."""
    qt = quantize(w, args, scale=scale, zero_point=zero_point, global_scale=global_scale)
    return dequantize(qt, args).to(w.dtype)


# ---------------------------------------------------------------------------
# dynamic activation quantization (the W8A8 path and the tests)
# ---------------------------------------------------------------------------

def _dynamic_scale(absmax: torch.Tensor, divisor: float) -> torch.Tensor:
    """max(absmax, 1e-12) / divisor in absmax's dtype, then f32, as the JAX
    package computes it; a true division by a tensor on every device."""
    absmax = torch.clamp(absmax, min=1e-12)
    return (absmax / torch.full_like(absmax, divisor)).float()


def _to_fp8_saturated(q: torch.Tensor) -> torch.Tensor:
    """Cast to float8_e4m3fn after clamping to +-448: the cast gives NaN
    past the range on one device and may not on another, so values out of
    range saturate on both (NaN stays NaN). The JAX package casts with no
    clamp (ROADMAP queue 3)."""
    return torch.clamp(q, -FP8_E4M3_MAX, FP8_E4M3_MAX).to(torch.float8_e4m3fn)


def dynamic_quantize_token_fp8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic FP8: x [..., d] -> (fp8 values, per-token f32 scale [..., 1])."""
    scale = _dynamic_scale(torch.amax(torch.abs(x), dim=-1, keepdim=True), FP8_E4M3_MAX)
    return _to_fp8_saturated(x / scale), scale


def dynamic_quantize_group_fp8(x: torch.Tensor, group_size: int = 128
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-group dynamic FP8 (the FP8_BLOCK activation side): the last
    axis zero-padded to a multiple of ``group_size``; returns the fp8 values
    in ``x``'s shape and the f32 scales [..., groups]."""
    d = x.shape[-1]
    xp = _pad_axis(x, x.ndim - 1, group_size)
    g = xp.reshape(*xp.shape[:-1], -1, group_size)
    scale = _dynamic_scale(torch.amax(torch.abs(g), dim=-1, keepdim=True), FP8_E4M3_MAX)
    q = _to_fp8_saturated(g / scale).reshape(xp.shape)[..., :d]
    return q, scale.squeeze(-1)


def dynamic_quantize_token_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic symmetric INT8: x [..., d] -> (int8 codes, per-token
    f32 scale [..., 1]); scale absmax / 127.5, codes rounded half away from
    zero and clipped to [-128, 127]."""
    scale = _dynamic_scale(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.5)
    q = torch.clamp(_round_half_away(x / scale), -128, 127).to(torch.int8)
    return q, scale
