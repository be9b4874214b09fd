"""Quantized linear layers as plain dataclasses of tensors.

Counterpart of ``quantizers_tpu/ops/linear.py``. A :class:`QuantLinear`
holds the payload in the same at-rest layouts as the JAX package, so
weights cross between the two as plain numpy arrays
(HF weights are ``(out_features, in_features)`` = (N, K)):

* ``w4``   — packed uint8 ``(K//2, N)``, split-half: the low nibble of row
  ``p`` holds ``W[p, n] + 8``, the high nibble ``W[K//2 + p, n] + 8``.
  Scales ``(K//g, N)``; optional zero points ``(K//g, N)`` int8.
* ``w8``   — int8 ``(K, N)``; per-channel ``(1, N)`` or per-group scales
  (bf16, or f32 in the w8pc expert layout).
* ``nvfp4``— packed uint8 ``(K//2, N)`` E2M1 codes, split-half; effective
  scales (the global scale folded in) bf16 ``(K//16, N)``. The serving
  layout :func:`nvfp4_device_layout` may turn the codes into int8 ``(K, N)``
  holding 2x the E2M1 value, with the scales halved.
* ``fp8``  — ``float8_e4m3fn`` ``(K, N)``; f32 scales: a block grid
  ``(ceil(K/bk), ceil(N/bn))`` (meta ``strategy="block"``, ``block_k``,
  ``block_n``), groups ``(K/g, N)``, a channel row ``(1, N)`` or one
  ``(1, 1)`` tensor scale. The serving layout :func:`fp8_device_layout` may
  hoist them to bf16 ``dense`` copies.
* ``dense``— bf16/f32 ``(K, N)``.

The TPU's signed-int4 relayout (the w4 half of ``i4_device_layout``) has no
counterpart: the CUDA kernel reads the packed bytes directly.

The MoE serving layouts live here too, as in the JAX package: the NVFP4
capacity plan, the int8-doubled NVFP4 layout, and the fused int8
per-channel expert layout (``moe_w8pc_layout``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.numerics import QuantizedTensor
from ..core.scheme import QuantizationArgs, QuantStrategy, QuantType

def _group_scaled(vals: torch.Tensor, scale: torch.Tensor,
                  zero_point: Optional[torch.Tensor], g: int, k: int, n: int
                  ) -> torch.Tensor:
    """Apply per-group scales (S, r, N) (and zero points) to (S, k, N) f32
    values.

    Groups are the nominal ``g`` rows each: the last may cover fewer real
    rows (K % g != 0), and a K < g weight has exactly one group."""
    S, r = vals.shape[0], scale.shape[-2]
    pad = r * g - k
    if pad < 0:
        raise ValueError(f"scale rows {r} x group {g} < K {k}")
    if pad:
        vals = F.pad(vals, (0, 0, 0, pad))
    vals = vals.reshape(S, r, g, n)
    if zero_point is not None:
        vals = vals - zero_point[:, :, None, :].float()
    w = vals * scale[:, :, None, :].float()
    return w.reshape(S, r * g, n)[:, :k]


def _unpack_nibbles(packed: torch.Tensor, signed_offset: int = 8) -> torch.Tensor:
    """uint8 (..., K//2, N) split-half packed -> int8 (..., K, N)."""
    lo = (packed & 0x0F).to(torch.int8) - signed_offset
    hi = ((packed >> 4) & 0x0F).to(torch.int8) - signed_offset
    return torch.cat([lo, hi], dim=-2)


#: E2M1 magnitudes by the low three bits of a code
_FP4_LUT = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def _fp4_values(codes: torch.Tensor) -> torch.Tensor:
    """E2M1 codes (0..15, any integer dtype) -> float32 values; bit 3 is the sign."""
    c = codes.to(torch.int64)
    lut = torch.tensor(_FP4_LUT, dtype=torch.float32, device=codes.device)
    mag = lut[c & 7]
    return torch.where((c & 8) != 0, -mag, mag)


def _unpack_fp4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K//2, N) of split-half packed E2M1 codes -> float32 (..., K, N)."""
    return _fp4_values(torch.cat([packed & 0x0F, packed >> 4], dim=-2))


def nvfp4_packed_to_i8(packed: torch.Tensor) -> torch.Tensor:
    """Split-half packed E2M1 codes uint8 (..., K//2, N) -> int8 (..., K, N)
    holding 2x the E2M1 value (exact: 2v in {0, +-1, +-2, +-3, +-4, +-6, +-8,
    +-12}); the companion scale must be halved."""
    return (2.0 * _unpack_fp4(packed)).to(torch.int8)


def _fp4_encode(values: torch.Tensor) -> torch.Tensor:
    """Float values on the E2M1 grid -> 4-bit codes (uint8 0..15): the
    magnitude's nearest table entry, bit 3 set for negative values (the
    JAX package's ``formats.compressed_tensors.fp4_encode``)."""
    lut = torch.tensor(_FP4_LUT, dtype=torch.float32, device=values.device)
    a = torch.abs(values.float())
    mag = torch.argmin(torch.abs(a[..., None] - lut), dim=-1).to(torch.uint8)
    return ((values < 0).to(torch.uint8) << 3) | mag


def _pack_split_half(u: torch.Tensor) -> torch.Tensor:
    """uint8 nibbles (K, N) -> uint8 (ceil(K/2), N): low nibble row p, high
    nibble row K/2 + p (an odd K is padded with one zero row)."""
    if u.shape[0] % 2:
        u = F.pad(u, (0, 0, 0, 1))
    half = u.shape[0] // 2
    return (u[:half] | (u[half:] << 4)).contiguous()


def _pack_nibbles_np(vals: np.ndarray, offset: int = 8) -> np.ndarray:
    """int values (K, N) -> uint8 (K//2, N), split-half order: low nibble
    row p = vals[p], high nibble = vals[K//2 + p]."""
    u = (vals.astype(np.int16) + offset).astype(np.uint8)
    if u.shape[0] % 2:
        u = np.pad(u, ((0, 1), (0, 0)))
    half = u.shape[0] // 2
    return (u[:half] | (u[half:] << 4)).astype(np.uint8)


def dequantize_stack(kind: str, weight: torch.Tensor, scale: Optional[torch.Tensor],
                     zero_point: Optional[torch.Tensor], meta, dtype) -> torch.Tensor:
    """A stack of S payloads (S, ...) in the at-rest layout of ``kind`` ->
    (S, K, N) in ``dtype``: values times scales in f32, rounded to ``dtype``
    once. One linear is a stack of one; an expert stack, or the experts
    gathered for a batch of slots, is a stack of many."""
    md = dict(meta)
    if kind == "dense":
        return weight.to(dtype)
    k, n = int(md["k"]), int(md["n"])
    if kind == "fp8":
        vals, s = weight.float(), scale.float()
        strategy = md.get("strategy", "block")
        if strategy == "block":
            up = (s.repeat_interleave(int(md["block_k"]), dim=-2)
                  .repeat_interleave(int(md["block_n"]), dim=-1))
            return (vals * up[:, :k, :n]).to(dtype)
        if strategy == "group":
            return _group_scaled(vals[:, :k], s, None, int(md["group_size"]), k, n).to(dtype)
        return (vals * s).to(dtype)  # channel (S, 1, N) / tensor (S, 1, 1)
    if kind == "w4":
        vals, g = _unpack_nibbles(weight).float()[:, :k], int(md["group_size"])
    elif kind == "nvfp4":
        # int8: 2x the values, with the scale already halved
        vals = weight.float()[:, :k] if weight.dtype == torch.int8 else _unpack_fp4(weight)[:, :k]
        g = int(md.get("group_size", 16))
    elif kind == "w8":
        vals, g = weight.float()[:, :k], md.get("group_size")
        if not g:  # per-channel: the (S, 1, N) scale broadcasts over the K rows
            if zero_point is not None:
                vals = vals - zero_point.float()
            return (vals * scale.float()).to(dtype)
        g = int(g)
    else:
        raise ValueError(f"unknown QuantLinear kind {kind}")
    return _group_scaled(vals, scale, zero_point, g, k, n).to(dtype)


@dataclasses.dataclass
class QuantLinear:
    """A (possibly) quantized linear weight: tensors plus static ``meta``."""

    kind: str  # dense | w4 | w8 | fp8 | nvfp4
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
        def one(t):
            return None if t is None else t[None]
        return dequantize_stack(self.kind, self.weight[None], one(self.scale),
                                one(self.zero_point), self.meta, dtype)[0]

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


def dense_linear(weight_nk: Any, bias: Optional[Any] = None, device=None,
                 dtype=torch.bfloat16) -> QuantLinear:
    """From an HF (N, K) weight -> dense layout (K, N) in ``dtype``."""
    w = _as_tensor(weight_nk, device, dtype).t().contiguous()
    k, n = w.shape
    b = None if bias is None else _as_tensor(bias, w.device, torch.bfloat16)
    return QuantLinear(kind="dense", weight=w, bias=b, meta=(("k", k), ("n", n)))


def _act_meta(act_args: Optional[QuantizationArgs]) -> Tuple[Tuple[str, Any], ...]:
    """The meta entry recording a scheme's input-activation quantization,
    where the JAX package records one: dynamic per-token symmetric INT8 (the
    W8A8 preset), which :func:`~quantizers_tpu_torch.ops.dispatch.quant_matmul`
    serves through the int8 GEMM (``dispatch.w8a8_token_matmul``)."""
    if (act_args is not None and act_args.dynamic and act_args.symmetric
            and act_args.type == QuantType.INT and act_args.num_bits == 8
            and act_args.strategy == QuantStrategy.TOKEN):
        return (("act", "token_i8"),)
    return ()


def from_quantized(qt: QuantizedTensor, args: QuantizationArgs,
                   bias: Optional[Any] = None,
                   act_args: Optional[QuantizationArgs] = None) -> QuantLinear:
    """Build the at-rest layout from a :class:`QuantizedTensor` whose values
    are in the HF (N, K) orientation, with bf16 scales. The relayout runs
    on the values' device. ``act_args`` (the scheme's input activations) is
    recorded in a per-channel w8 linear's meta as the JAX package does
    (:func:`_act_meta`)."""
    n, k = qt.shape
    values = qt.values
    dev = values.device
    scale = qt.scale.float()
    b = None if bias is None else _as_tensor(bias, dev, torch.bfloat16)

    if args.type == QuantType.INT and args.num_bits == 4:
        packed = _pack_split_half((values.t().to(torch.int16) + 8).to(torch.uint8))
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
            meta = (("k", k), ("n", n), ("group_size", None)) + _act_meta(act_args)
            scale_t = scale.reshape(n, -1).t()
        zp = None
        if qt.zero_point is not None:
            zpd = qt.zero_point
            zp = (zpd.t() if zpd.ndim == 2 and zpd.shape[1] > 1
                  else zpd.reshape(n, -1).t()).to(torch.int8).contiguous()
        return QuantLinear(kind="w8", weight=w8, scale=scale_t.to(torch.bfloat16).contiguous(),
                           zero_point=zp, bias=b, meta=meta)

    if args.type == QuantType.FLOAT and args.num_bits == 4:
        # NVFP4: E2M1 codes packed split-half; the global scale is folded
        # into per-group effective scales
        packed = _pack_split_half(_fp4_encode(values.t()))
        gsc = float(qt.global_scale) if qt.global_scale is not None else 1.0
        # a true division on every device (CUDA multiplies by the reciprocal
        # of a Python scalar divisor), so that the card builds the CPU's scales
        eff = (scale / torch.full_like(scale, gsc)).t()  # (K/16, N)
        return QuantLinear(
            kind="nvfp4", weight=packed, scale=eff.to(torch.bfloat16).contiguous(), bias=b,
            meta=(("k", k), ("n", n), ("group_size", int(args.group_size or 16))))

    if args.type == QuantType.FLOAT and args.num_bits == 8:
        w8 = values.t().to(torch.float8_e4m3fn).contiguous()  # (K, N), values on the grid
        if args.strategy == QuantStrategy.BLOCK:
            br, bc = tuple(args.block_structure)
            # the (N-blocks, K-blocks) grid over (N, K), transposed
            scale_t = scale.t()
            meta = (("k", k), ("n", n), ("strategy", "block"), ("block_k", bc), ("block_n", br))
        elif args.strategy == QuantStrategy.GROUP:
            scale_t = scale.t()
            meta = (("k", k), ("n", n), ("strategy", "group"), ("group_size", int(args.group_size)))
        elif args.strategy == QuantStrategy.CHANNEL:
            scale_t = scale.reshape(n, -1).t()
            meta = (("k", k), ("n", n), ("strategy", "channel"))
        else:
            scale_t = scale.reshape(1, 1)
            meta = (("k", k), ("n", n), ("strategy", "tensor"))
        return QuantLinear(kind="fp8", weight=w8, scale=scale_t.float().contiguous(), bias=b,
                           meta=meta)
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

    if first.kind == "fp8" and md0.get("strategy") == "tensor":
        raise ValueError("cannot fuse tensor-scaled fp8 linears")
    meta = tuple((key, v) if key != "n" else ("n", n_total) for key, v in first.meta)
    return QuantLinear(kind=first.kind, weight=cat("weight"), scale=cat("scale"),
                       zero_point=cat("zero_point"), bias=cat("bias", dim=0), meta=meta)


# ---------------------------------------------------------------------------
# serving layouts: the NVFP4 capacity plan, int8-doubled NVFP4, MoE w8pc
# ---------------------------------------------------------------------------

def device_hbm_bytes(device=None) -> int:
    """Total memory of a CUDA device, from ``torch.cuda.mem_get_info``."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_hbm_bytes: {dev} is no CUDA device")
    return int(torch.cuda.mem_get_info(dev)[1])


def _is_expert_stack(x: Any) -> bool:
    return hasattr(x, "num_experts")


def infer_expert_shards(tree: Any) -> int:
    """How many ways the expert stacks are sharded (1 if unsharded): the
    shard count that :func:`~quantizers_tpu_torch.parallel.shard_params`
    records on the first expert stack of the tree."""
    for leaf in _leaves(tree):
        if _is_expert_stack(leaf):
            return int(getattr(leaf, "shards", 1))
    return 1


def _is_shard_wrapper(x: Any) -> bool:
    """A rank's shard of a linear wrapped with its collective
    (:mod:`~quantizers_tpu_torch.parallel.collectives`)."""
    return hasattr(x, "with_shard")


def _leaves(tree: Any):
    """The quantized linears, expert stacks and plain tensors of a params
    tree, in order (a parallel wrapper's shard in its place)."""
    if _is_shard_wrapper(tree):
        yield from _leaves(tree.shard)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, (QuantLinear, torch.Tensor)) or _is_expert_stack(tree):
        yield tree


def _map_leaves(tree: Any, fn) -> Any:
    """The params tree with ``fn`` applied to every leaf (new dicts and
    lists; ``fn`` returns a leaf as it is to keep it); a parallel wrapper
    is kept around ``fn`` of its shard."""
    if _is_shard_wrapper(tree):
        return tree.with_shard(_map_leaves(tree.shard, fn))
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def nvfp4_capacity_plan(tree: Any, hbm_bytes: Optional[int] = None,
                        headroom: float = 0.25, expert_shards: int = 1,
                        device=None) -> Dict[str, Any]:
    """Decide the NVFP4 serving layout by capacity: the resident bytes of
    the params as they are (``packed_bytes``) and with every packed NVFP4
    payload stored as int8 and every fp8 weight as a bf16 copy
    (``int8_bytes``, one more byte per packed byte or fp8 weight), against
    ``(1 - headroom)`` of the device's memory (``hbm_bytes``, by default
    :func:`device_hbm_bytes` of ``device``). Expert stacks divide by
    ``expert_shards``, as the JAX package's, which sees whole stacks: a
    rank's shard of a stack (``shards`` > 1) is counted as the whole stack
    first, so that a rank's own tree plans its own bytes. Other leaves are
    counted as the tree holds them."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    packed_total = 0
    int8_extra = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            packed_total += _nbytes(leaf)
            continue
        div, whole = 1, 1
        if _is_expert_stack(leaf):
            div, whole = expert_shards, int(getattr(leaf, "shards", 1))
        nb = sum(_nbytes(t) for t in (leaf.weight, leaf.scale, leaf.zero_point, leaf.bias))
        packed_total += nb * whole // div
        if (leaf.kind == "nvfp4" and leaf.weight.dtype == torch.uint8) or leaf.kind == "fp8":
            int8_extra += _nbytes(leaf.weight) * whole // div
    budget = int((1.0 - headroom) * hbm_bytes)
    int8_total = packed_total + int8_extra
    return {"hbm_bytes": int(hbm_bytes), "budget_bytes": budget,
            "packed_bytes": int(packed_total), "int8_bytes": int(int8_total),
            "expert_shards": int(expert_shards), "int8_ok": int8_total <= budget}


def _nvfp4_layout_decision(tree: Any, nvfp4_int8: Optional[bool], expert_shards: int) -> bool:
    """int8-doubled (True) or packed (False) NVFP4: ``QTPU_NVFP4_LAYOUT``
    (``packed`` / ``int8``) first, then the legacy ``QTPU_KEEP_PACKED_NVFP4``,
    then the pinned ``nvfp4_int8``, then the capacity plan."""
    env = os.environ.get("QTPU_NVFP4_LAYOUT")
    if env in ("packed", "int8"):
        return env == "int8"
    if os.environ.get("QTPU_KEEP_PACKED_NVFP4"):
        return False
    if nvfp4_int8 is not None:
        return nvfp4_int8
    return nvfp4_capacity_plan(tree, expert_shards=expert_shards)["int8_ok"]


def _nvfp4_to_i8(x: Any) -> Any:
    """A packed NVFP4 linear or expert stack in the int8-doubled layout."""
    return dataclasses.replace(x, weight=nvfp4_packed_to_i8(x.weight),
                               scale=(x.scale.float() * 0.5).to(x.scale.dtype))


def nvfp4_device_layout(tree: Any, nvfp4_int8: Optional[bool] = None,
                        expert_shards: int = 1,
                        nvfp4_int8_experts: Optional[bool] = None) -> Any:
    """The NVFP4 half of the JAX package's ``i4_device_layout``: packed
    NVFP4 payloads become int8-doubled (:func:`nvfp4_packed_to_i8`, scales
    halved) for plain linears and expert stacks, as ``nvfp4_int8`` pins or,
    when it is None, as :func:`_nvfp4_layout_decision` says;
    ``nvfp4_int8_experts`` overrides that for the expert stacks only.
    Asymmetric and already-converted leaves pass through."""
    decide: Dict[str, bool] = {} if nvfp4_int8 is None else {"int8": nvfp4_int8}

    def conv(x: Any) -> Any:
        if not (isinstance(x, QuantLinear) or _is_expert_stack(x)):
            return x
        if x.kind != "nvfp4" or x.zero_point is not None or x.weight.dtype != torch.uint8:
            return x
        if int(dict(x.meta)["k"]) != 2 * x.weight.shape[-2]:
            return x
        if "int8" not in decide:
            decide["int8"] = _nvfp4_layout_decision(tree, None, expert_shards)
        leaf_int8 = decide["int8"]
        if nvfp4_int8_experts is not None and _is_expert_stack(x):
            leaf_int8 = nvfp4_int8_experts
        return _nvfp4_to_i8(x) if leaf_int8 else x

    return _map_leaves(tree, conv)


def fp8_device_layout(tree: Any, fp8_dense: bool) -> Any:
    """The fp8 half of the JAX package's ``i4_device_layout``: with
    ``fp8_dense`` every fp8 :class:`QuantLinear` becomes a bf16 ``dense``
    copy of its dequantized weight (the hoisted dequantize, one more byte
    per weight); without it the tree is returned as it is and fp8 weights
    stay resident. Expert stacks and other leaves pass through."""
    if not fp8_dense:
        return tree

    def hoist(x: Any) -> Any:
        if not (isinstance(x, QuantLinear) and x.kind == "fp8"):
            return x
        return QuantLinear(kind="dense", weight=x.dequantize(torch.bfloat16), bias=x.bias,
                           meta=(("k", x.in_features), ("n", x.out_features)))

    return _map_leaves(tree, hoist)


def experts_to_w8pc(el: Any, chunk: int = 16) -> Any:
    """Requantize a symmetric expert stack onto the int8 per-channel grid
    (kind ``w8``, one f32 scale per output column): each expert is
    dequantized in f32, its column scale is ``max|W| / 127 + 1e-12``, and
    its codes ``round(W / scale)`` (half to even, as ``jnp.round``) clipped
    to +-127. ``chunk`` experts are dequantized at a time, to bound the f32
    transient."""
    from ..models.moe import ExpertLinears

    if el.zero_point is not None:
        raise ValueError("w8pc serving layout requires symmetric experts")
    md = dict(el.meta)
    k, n = int(md["k"]), int(md["n"])
    w8s, scs = [], []
    for e0 in range(0, el.num_experts, chunk):
        part = ExpertLinears(kind=el.kind, weight=el.weight[e0:e0 + chunk],
                             scale=el.scale[e0:e0 + chunk], meta=el.meta)
        W = part.dequantize(torch.float32)  # (c, k, n)
        amax = torch.amax(torch.abs(W), dim=1, keepdim=True)
        # a true division on every device (CUDA multiplies by the reciprocal
        # of a Python scalar divisor), so that the card and the CPU agree
        sc = amax / torch.full_like(amax, 127.0) + 1e-12
        w8s.append(torch.clamp(torch.round(W / sc), -127, 127).to(torch.int8))
        scs.append(sc.float())
        del W
    return ExpertLinears(kind="w8", weight=torch.cat(w8s), scale=torch.cat(scs), bias=el.bias,
                         meta=(("k", k), ("n", n), ("group_size", None)),
                         shards=el.shards, first=el.first)


def fuse_experts_gate_up(gate_el: Any, up_el: Any) -> Any:
    """Concatenate gate/up expert stacks along the output axis into one
    (E, K, 2F) stack (meta ``fused="gate_up"``)."""
    from ..models.moe import ExpertLinears

    if (gate_el.kind != up_el.kind or gate_el.meta != up_el.meta
            or (gate_el.shards, gate_el.first) != (up_el.shards, up_el.first)):
        raise ValueError("gate/up fusion requires matching kind, meta and experts")
    n2 = 2 * int(dict(gate_el.meta)["n"])
    meta = tuple((key, v) if key != "n" else ("n", n2) for key, v in gate_el.meta)
    meta = meta + (("fused", "gate_up"),)

    def cat(field):
        a, b = getattr(gate_el, field), getattr(up_el, field)
        if a is None and b is None:
            return None
        return torch.cat([a, b], dim=-1)

    return ExpertLinears(kind=gate_el.kind, weight=cat("weight"), scale=cat("scale"),
                         zero_point=cat("zero_point"), bias=cat("bias"), meta=meta,
                         shards=gate_el.shards, first=gate_el.first)


def moe_w8pc_layout(tree: Any) -> Any:
    """Swap every MoE block's gate/up/down expert stacks for the fused int8
    per-channel serving layout (``gate_up_proj`` plus a w8pc ``down_proj``;
    :func:`experts_to_w8pc`). Routers, shared experts, other leaves and
    asymmetric or dense stacks pass through. The dicts are new; the tensors
    of untouched leaves are shared."""
    def eligible(el: Any) -> bool:
        return (_is_expert_stack(el) and el.zero_point is None
                and el.kind in ("nvfp4", "w4", "w8") and el.scale is not None)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            node = {key: walk(v) for key, v in node.items()}
            g, u, d = (node.get("gate_proj"), node.get("up_proj"), node.get("down_proj"))
            if all(x is not None and eligible(x) for x in (g, u, d)):
                node["gate_up_proj"] = fuse_experts_gate_up(experts_to_w8pc(g),
                                                            experts_to_w8pc(u))
                node["down_proj"] = experts_to_w8pc(d)
                del node["gate_proj"], node["up_proj"]
            return node
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)
