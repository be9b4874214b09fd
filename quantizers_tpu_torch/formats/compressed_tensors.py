"""compressed-tensors on-disk format: packing, per-format serialization and
the ``quantization_config`` JSON schema, over torch tensors.

Counterpart of ``quantizers_tpu/formats/compressed_tensors.py``; the bits
on disk are the same, so checkpoints written by either package read
identically in the other. Every function runs on the device its inputs
lie on.

* ``pack-quantized`` (INT<8 weights): ``weight_packed`` (int32, 32/b values
  per word along the in-features axis, offset to unsigned, element ``j`` at
  bits ``b*j``), ``weight_scale``, ``weight_shape`` (int64 [2]), plus
  ``weight_zero_point`` (packed, asymmetric only) and ``weight_g_idx``
  (int32, actorder only);
* ``float-quantized`` (FP8): ``weight`` stored as F8_E4M3 + ``weight_scale``
  (f32);
* ``nvfp4-pack-quantized``: ``weight_packed`` (uint8, two E2M1 codes per
  byte, low nibble first), ``weight_scale`` (F8_E4M3 per 16-group),
  ``weight_global_scale`` (f32 [1]);
* config: ``quantization_config`` with ``quant_method: compressed-tensors``,
  ``config_groups``, ``format`` (or ``mixed-precision``), ``ignore``,
  ``kv_cache_scheme``, ``quantization_status: compressed``.

The JAX package's ``dequantize_numpy`` has no counterpart here: the port's
:func:`~quantizers_tpu_torch.core.numerics.dequantize` takes the decompressed
tensors as they are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.numerics import QuantizedTensor
from ..core.scheme import (
    QuantizationArgs,
    QuantScheme,
    QuantStrategy,
    QuantType,
    infer_format,
)
from ..ops.linear import _fp4_encode, _fp4_values

COMPRESSION_VERSION = "0.13.1"
QUANT_METHOD = "compressed-tensors"


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_int_to_int32(values: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Pack signed sub-byte integers along the last axis into int32 words.

    Values are offset to unsigned (v + 2^(b-1)) and laid out little-endian
    within each word: element ``j`` of a word sits at bits ``b*j`` — the
    compressed-tensors layout.
    """
    if num_bits not in (2, 4, 8):
        raise ValueError(f"pack supports 2/4/8 bits, got {num_bits}")
    per_word = 32 // num_bits
    offset = 1 << (num_bits - 1)

    u = values.to(torch.int64) + offset
    rows, cols = u.shape
    u = F.pad(u, (0, (-cols) % per_word)).reshape(rows, -1, per_word)
    # an OR of the shifted fields within 32 bits, as the JAX package's
    # uint32 arithmetic: a value outside the signed range spills into its
    # neighbour's bits there, and so it does here
    packed = u[..., 0] & 0xFFFFFFFF
    for j in range(1, per_word):
        packed |= (u[..., j] << (j * num_bits)) & 0xFFFFFFFF
    # the unsigned 32-bit word, as a two's-complement int32
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_int32_to_int(packed: torch.Tensor, num_bits: int, original_cols: int) -> torch.Tensor:
    """Inverse of :func:`pack_int_to_int32`; returns signed int8."""
    per_word = 32 // num_bits
    offset = 1 << (num_bits - 1)
    mask = (1 << num_bits) - 1

    u = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(per_word, dtype=torch.int64, device=u.device) * num_bits
    vals = (u[..., None] >> shifts) & mask
    vals = vals.reshape(packed.shape[0], -1)[:, :original_cols]
    return (vals - offset).to(torch.int8)


def fp4_encode(values: torch.Tensor) -> torch.Tensor:
    """float values (already on the E2M1 grid) -> 4-bit codes (uint8 0..15),
    sign in bit 3."""
    return _fp4_encode(values)


def fp4_decode(codes: torch.Tensor) -> torch.Tensor:
    """4-bit E2M1 codes -> float32 values."""
    return _fp4_values(codes)


def pack_fp4_to_uint8(values: torch.Tensor) -> torch.Tensor:
    """Two E2M1 codes per byte along the last axis, low nibble = even index."""
    codes = fp4_encode(values)
    if codes.shape[1] % 2:
        codes = F.pad(codes, (0, 1))
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def unpack_uint8_to_fp4(packed: torch.Tensor, original_cols: int) -> torch.Tensor:
    codes = torch.stack([packed & 0x0F, (packed >> 4) & 0x0F], dim=-1)
    return fp4_decode(codes.reshape(packed.shape[0], -1)[:, :original_cols])


# ---------------------------------------------------------------------------
# per-format compress / decompress
# ---------------------------------------------------------------------------

def compress_tensor(
    prefix: str,
    qt: QuantizedTensor,
    args: QuantizationArgs,
    scale_dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Serialize one quantized weight into its on-disk parameter set.

    ``prefix`` is the module path (e.g. ``model.layers.0.mlp.down_proj``).
    The tensors stay on the device of ``qt``.
    """
    fmt = infer_format(QuantScheme(weights=args))
    out: Dict[str, torch.Tensor] = {}
    values, scale = qt.values, qt.scale
    rows, cols = qt.shape
    asym = qt.zero_point is not None and not args.symmetric

    def shape() -> torch.Tensor:
        return torch.tensor([rows, cols], dtype=torch.int64, device=values.device)

    if fmt == "pack-quantized":
        out[f"{prefix}.weight_packed"] = pack_int_to_int32(values, args.num_bits)
        out[f"{prefix}.weight_scale"] = scale.to(scale_dtype)
        out[f"{prefix}.weight_shape"] = shape()
        if asym:
            out[f"{prefix}.weight_zero_point"] = pack_int_to_int32(
                qt.zero_point.to(torch.int8), args.num_bits)
        # an actorder permutation (weight_g_idx) is written by the
        # checkpoint writer, from CompressedParam.g_idx
    elif fmt == "nvfp4-pack-quantized":
        out[f"{prefix}.weight_packed"] = pack_fp4_to_uint8(values)
        out[f"{prefix}.weight_scale"] = scale.to(torch.float8_e4m3fn)
        out[f"{prefix}.weight_global_scale"] = torch.tensor(
            [float(qt.global_scale)], dtype=torch.float32, device=values.device)
        out[f"{prefix}.weight_shape"] = shape()
    elif fmt == "float-quantized":
        out[f"{prefix}.weight"] = values.to(torch.float8_e4m3fn)
        out[f"{prefix}.weight_scale"] = scale.to(torch.float32)
        if asym:
            out[f"{prefix}.weight_zero_point"] = qt.zero_point.to(torch.float32)
    elif fmt == "int-quantized":
        out[f"{prefix}.weight"] = values.to(torch.int8)
        out[f"{prefix}.weight_scale"] = scale.to(scale_dtype)
        if asym:
            out[f"{prefix}.weight_zero_point"] = qt.zero_point.to(torch.int8)
    else:
        raise ValueError(f"unsupported serialization format {fmt}")
    return out


def decompress_tensor(
    prefix: str,
    tensors: Dict[str, torch.Tensor],
    args: QuantizationArgs,
) -> QuantizedTensor:
    """Rebuild a :class:`QuantizedTensor` from on-disk parameters, on their
    device.

    Accepts both ``weight_scale`` and DeepSeek-style ``weight_scale_inv``
    spellings for FP8 block checkpoints.
    """
    fmt = infer_format(QuantScheme(weights=args))

    def grab(suffix: str) -> Optional[torch.Tensor]:
        return tensors.get(f"{prefix}.{suffix}")

    if fmt == "pack-quantized":
        packed = grab("weight_packed")
        rows, cols = (int(v) for v in grab("weight_shape").tolist())
        values = unpack_int32_to_int(packed, args.num_bits, cols)[:rows]
        scale = grab("weight_scale").float()
        zp_packed = grab("weight_zero_point")
        zp = None
        if zp_packed is not None and not args.symmetric:
            n_groups = scale.shape[-1] if scale.ndim > 1 else 1
            zp = unpack_int32_to_int(zp_packed, args.num_bits, n_groups).to(torch.int32)
        return QuantizedTensor(values, scale, zp, None, (rows, cols))

    if fmt == "nvfp4-pack-quantized":
        packed = grab("weight_packed")
        shape = grab("weight_shape")
        if shape is not None:
            rows, cols = (int(v) for v in shape.tolist())
        else:
            rows, cols = packed.shape[0], packed.shape[1] * 2
        values = unpack_uint8_to_fp4(packed, cols)[:rows]
        scale = grab("weight_scale").float()
        gscale = grab("weight_global_scale")
        g = (gscale.reshape(-1)[0].float() if gscale is not None
             else torch.tensor(1.0, device=packed.device))
        return QuantizedTensor(values, scale, None, g, (rows, cols))

    if fmt in ("float-quantized", "int-quantized"):
        w = grab("weight")
        scale = grab("weight_scale")
        if scale is None:
            scale = grab("weight_scale_inv")
            if scale is None:
                raise KeyError(f"{prefix}: no weight_scale / weight_scale_inv found")
            # DeepSeek's 'scale_inv' is the multiplicative dequant factor
        vals = w.float() if fmt == "float-quantized" else w.to(torch.int8)
        return QuantizedTensor(vals, scale.float(), grab("weight_zero_point"), None,
                               tuple(w.shape))

    raise ValueError(f"unsupported serialization format {fmt}")


# ---------------------------------------------------------------------------
# quantization_config schema
# ---------------------------------------------------------------------------

def build_quantization_config(
    config_groups: Dict[str, QuantScheme],
    ignore: List[str],
    kv_cache_scheme: Optional[QuantizationArgs] = None,
    global_compression_ratio: Optional[float] = None,
) -> Dict[str, Any]:
    """Build the ``quantization_config`` block written into ``config.json``."""
    groups_json: Dict[str, Any] = {}
    formats = set()
    for name, scheme in config_groups.items():
        d = scheme.to_dict()
        formats.add(d["format"])
        groups_json[name] = d

    overall_format = formats.pop() if len(formats) == 1 else "mixed-precision"
    return {
        "quant_method": QUANT_METHOD,
        "format": overall_format,
        "quantization_status": "compressed",
        "config_groups": groups_json,
        "ignore": list(ignore or []),
        "kv_cache_scheme": kv_cache_scheme.to_dict() if kv_cache_scheme else None,
        "global_compression_ratio": global_compression_ratio,
        "sparsity_config": {},
        "transform_config": {},
        "version": COMPRESSION_VERSION,
    }


def parse_quantization_config(qcfg: Dict[str, Any]
                              ) -> Tuple[Dict[str, QuantScheme], List[str],
                                         Optional[QuantizationArgs]]:
    """Inverse of :func:`build_quantization_config` (also reads configs that
    llmcompressor produced)."""
    groups = {
        name: QuantScheme.from_dict(body)
        for name, body in (qcfg.get("config_groups") or {}).items()
    }
    ignore = list(qcfg.get("ignore") or [])
    kv = qcfg.get("kv_cache_scheme")
    kv_args = QuantizationArgs.from_dict(kv) if kv else None
    return groups, ignore, kv_args


def compression_ratio(
    schemes_by_param: Dict[str, QuantizationArgs], param_sizes: Dict[str, int], base_bits: int = 16
) -> float:
    """Rough global compression ratio: weighted bits-per-weight vs base."""
    total = 0
    compressed = 0.0
    for name, size in param_sizes.items():
        total += size * base_bits
        args = schemes_by_param.get(name)
        if args is None:
            compressed += size * base_bits
        else:
            bits = args.num_bits
            if args.strategy in (QuantStrategy.GROUP, QuantStrategy.TENSOR_GROUP) and args.group_size:
                scale_bits = 8 if args.type == QuantType.FLOAT else 16
                bits += scale_bits / args.group_size
            compressed += size * bits
    return total / max(compressed, 1.0)
