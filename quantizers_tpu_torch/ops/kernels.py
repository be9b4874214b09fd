"""The serving path's CUDA kernels: wrappers, plain versions, launch counts.

Each wrapper checks what its kernel takes and raises
:class:`KernelUnsupported` on anything else, before any launch. Given CPU
tensors it computes the kernel's plain PyTorch version; given CUDA tensors
it launches the kernel (``csrc/*.cu``, built by :mod:`._build`) on the
current stream and raises if the launch fails. It adds one to its
``launches`` count where it launches, and nowhere else. The kernels have
no backward: on every device, a wrapper raises ``RuntimeError`` where
autograd records through one of its inputs (:func:`._launch.refuse_grad`),
so that no launch cuts a graph silently.

* :func:`w4_matmul` replaces ``quantizers_tpu/ops/kernels.py``
  ``_w4_matmul_2d`` and ``_w4i_matmul_2d`` (W4A16, group scales);
* :func:`w8_matmul` replaces ``_w8_matmul_2d`` (int8, channel or group,
  bf16 or f32 scales);
* :func:`w8a8_token_matmul` replaces no Pallas kernel: the per-token int8
  quantizer and XLA int8 ``dot_general`` of ``quantizers_tpu/ops/dispatch.py``
  ``w8a8_token_matmul`` (int8 activations and weights, int32 sums,
  per-token and per-channel scales); :func:`w8a8_matmul` is its GEMM alone,
  on codes quantized beforehand;
* :func:`decode_attention` replaces ``_decode_attention_call`` (one-token
  GQA attention with the new K/V row written into the cache in place);
* :func:`nvfp4_matmul` replaces ``_nvfp4_matmul_2d`` (packed E2M1 codes)
  and hands the int8-doubled layout to :func:`nvfp4_i8_matmul`, which
  replaces ``_nvfp4_i8_matmul_2d``;
* :func:`moe_slot_ffn` replaces ``_moe_slot_ffn_call`` (the gated FFN of
  routed expert slots over packed w4, packed E2M1 or int8-doubled E2M1
  stacks);
* :func:`moe_slot_gu_ffn` replaces ``_moe_slot_gu_call`` (the same over
  the fused int8 per-channel gate|up layout);
* :func:`fp8_matmul` replaces ``_fp8_matmul_2d`` (FP8 E4M3 weights with
  128 x 128 block scales, bf16 activations);
* :func:`mla_decode_attention` replaces ``_mla_decode_call`` (absorbed-MLA
  one-token attention over the latent cache, appended in place);
* :func:`gptq_block` replaces no Pallas kernel: the in-block column loop of
  the XLA ``fori_loop`` in ``quantizers_tpu/oneshot/gptq.py`` ``_gptq_solve``
  (GPTQ's serial elimination of one block of columns);
* :func:`~quantizers_tpu_torch.ops.flash.flash_attention` (module
  :mod:`.flash`) replaces ``quantizers_tpu/ops/flash.py`` ``_flash_call``
  (blockwise attention of the no-cache forward).

Importing this module needs neither ``nvcc`` nor a card: the library is
built at the first launch.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.numerics import dynamic_quantize_token_int8
from . import _build
from ._launch import KernelUnsupported, _count, _stream, aligned16, refuse_grad
from .flash import flash_attention
from .linear import QuantLinear, _unpack_fp4, _unpack_nibbles

#: head dim and largest query-group size the decode-attention kernel is built for
DECODE_HEAD_DIM = 128
DECODE_MAX_REP = 8
#: the largest latent width, padded rope width and cache length the MLA
#: decode kernel is built for (csrc/mla_decode_attention.cu)
MLA_MAX_RANK, MLA_MAX_ROPE, MLA_MAX_SLOTS = 1024, 256, 8192
#: the FP8 block the fp8 kernel takes (rows of K by columns of N)
FP8_BLOCK = 128


def _flatten_x(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    lead = tuple(x.shape[:-1])
    return aligned16(x.reshape(-1, k).to(torch.bfloat16).contiguous()), lead


def _check_cache_bases(name: str, **caches: torch.Tensor) -> None:
    """The decode kernels copy rows 16 bytes at a time: their inputs are
    copied to an aligned base where needed (``aligned16``), but a cache is
    written in place and cannot be, so an unaligned one raises."""
    for key, cache in caches.items():
        if cache.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start 16-byte aligned "
                             f"(its base is {cache.data_ptr() % 16} bytes past)")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


# ---------------------------------------------------------------------------
# W4A16: packed uint8 (K/2, N) split-half, value + 8; bf16 scales (K/g, N)
# ---------------------------------------------------------------------------

def _w4_reason(lin: QuantLinear) -> Optional[str]:
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md["group_size"])
    if lin.zero_point is not None:
        return "asymmetric w4 goes through the reference path"
    # on the card, the CUDA entry's own conditions (csrc/w4_matmul.cu:
    # qtt_w4_matmul): 16-byte rows of both planes of x (8 | K/2) and whole
    # 128-column tiles; its K stages are 128 rows, so a tensor-parallel
    # down_proj (Qwen3-4B's local K 4864 at tp 2, 2432 at tp 4) stays on it.
    # Weights on the CPU keep the JAX kernel's tiling (8g | K/2) as well, so
    # that the CPU takes the JAX package's routes and its tests hold the port
    # to them
    if k % (2 * g) or n % 128 or g % 2:
        return f"w4 kernel needs 2g|K and 128|N (k={k}, n={n}, g={g})"
    if (k // 2) % 8:
        return f"w4 kernel needs 8 | K/2 (k={k})"
    if lin.weight.device.type != "cuda" and (k // 2) % (8 * g):
        return f"w4 off the card: the JAX kernel's tiling needs 8g | K/2 (k={k}, g={g})"
    if lin.weight.dtype != torch.uint8 or lin.scale.dtype != torch.bfloat16:
        return "w4 kernel takes packed uint8 weights with bf16 scales"
    return None


def w4_matmul_plain(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    g: int) -> torch.Tensor:
    """The w4 kernel's arithmetic in PyTorch: (code - 8) * scale in f32,
    f32 products and sums, bf16 out. x2 (M, K) -> (M, N)."""
    w = _unpack_nibbles(packed).float() * scale.float().repeat_interleave(g, dim=0)
    return (x2.float() @ w).to(torch.bfloat16)


@_count
def w4_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for a symmetric packed w4 linear -> (..., N)."""
    refuse_grad("w4_matmul", x, lin.weight, lin.scale)
    reason = _w4_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md["group_size"])
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = w4_matmul_plain(x2, lin.weight, lin.scale, g)
    elif x2.is_cuda:
        out = _launch_matmul("qtt_w4_matmul", w4_matmul, x2, lin, g)
    else:
        raise ValueError(f"w4_matmul: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


# ---------------------------------------------------------------------------
# W8: int8 (K, N); bf16 scales per channel (1, N) or per group (K/g, N)
# ---------------------------------------------------------------------------

def _w8_reason(lin: QuantLinear) -> Optional[str]:
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    g = md.get("group_size")
    if lin.zero_point is not None:
        return "asymmetric w8 goes through the reference path"
    if n % 128 or k % 256:
        return f"w8 kernel needs 128|N, 256|K (k={k}, n={n})"
    if g:
        quantum = max(8 * int(g), 256)
        if k % quantum or quantum % int(g):
            return f"w8 kernel: group {g} does not tile K={k}"
    if lin.weight.dtype != torch.int8 or lin.scale.dtype not in (torch.bfloat16, torch.float32):
        return "w8 kernel takes int8 weights with bf16 or f32 scales"
    return None


def w8_matmul_plain(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                    g: Optional[int]) -> torch.Tensor:
    """The w8 kernel's arithmetic in PyTorch: f32 products and sums, bf16 out."""
    s = scale.float()
    if g:
        s = s.repeat_interleave(int(g), dim=0)
    return (x2.float() @ (w8.float() * s)).to(torch.bfloat16)


@_count
def w8_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for a symmetric int8 linear -> (..., N)."""
    refuse_grad("w8_matmul", x, lin.weight, lin.scale)
    reason = _w8_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    g = md.get("group_size")
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = w8_matmul_plain(x2, lin.weight, lin.scale, g)
    elif x2.is_cuda:
        # a per-channel scale is one group spanning all of K
        entry = "qtt_w8_matmul_f32s" if lin.scale.dtype == torch.float32 else "qtt_w8_matmul"
        out = _launch_matmul(entry, w8_matmul, x2, lin, int(g) if g else k)
    else:
        raise ValueError(f"w8_matmul: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


def _launch_matmul(entry: str, wrapper: Callable, x2: torch.Tensor, lin: QuantLinear,
                   g: int) -> torch.Tensor:
    _check_cuda(entry, x2, lin.weight, lin.scale)
    lib = _build.load()
    m, k = x2.shape
    n = lin.weight.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = getattr(lib, entry)(x2.data_ptr(), lin.weight.data_ptr(), lin.scale.data_ptr(),
                              out.data_ptr(), m, k, n, g, _stream(x2.device))
    _build.check(err, entry)
    wrapper.launches += 1
    return out


# ---------------------------------------------------------------------------
# W8A8: activations quantized per token to int8 (or int8 codes with their f32
# row scales) x int8 weights (K, N), int32 sums, per-token and per-channel
# scales
# ---------------------------------------------------------------------------

#: K10's block columns and K step (csrc/w8a8_matmul.cu)
W8A8_BN, W8A8_BK = 128, 64
#: its decode body's rows at most (in blocks of 16, 32 or 64; a block's
#: share of x, its rows by its share of K's steps, within W8A8_X_SHARE
#: bytes), its prefill bodies' block rows, columns and K steps (wgmma where
#: N and K are multiples of 16, else mma.sync), and the most blocks of a
#: cluster
W8A8_DECODE_ROWS, W8A8_X_SHARE = 64, 96 * 1024
W8A8_WG_TILE, W8A8_MMA_TILE, W8A8_MAX_SPLIT = (128, 128, 128), (64, 128, 64), 8


class W8A8Plan(NamedTuple):
    """How K10 runs one call: ``decode``, the one-launch body (the quantizer
    inside) or the quantizer pass and the prefill GEMM; ``rows``, a block's
    rows; ``split``, the blocks of a cluster that share one output tile's K."""

    decode: bool
    rows: int
    split: int


def _x_share(m: int, steps: int, split: int, elem: int) -> int:
    """The decode body's share of x: a 64-column box of m rows (128-byte
    aligned) for each of a block's K steps."""
    return -(-steps // split) * (-(-m * W8A8_BK * elem // 128) * 128)


def w8a8_plan(m: int, k: int, n: int, sms: int, elem: int = 2) -> W8A8Plan:
    """K10's plan for (m, K, N) with x of ``elem`` bytes an element (1: the
    int8 codes) on a card of ``sms`` SMs; the C entry makes the same choice
    of body from the split. The decode body takes m <= W8A8_DECODE_ROWS
    where some split of at most 8 holds a block's share of x; from the
    least such split it doubles while the blocks stay within two an SM and
    each keeps 4 K steps or more. The prefill bodies double their split
    while the blocks are fewer than the SMs and each keeps 4 steps or
    more."""
    steps, cols = -(-k // W8A8_BK), -(-n // W8A8_BN)
    split = 1
    if m <= W8A8_DECODE_ROWS:
        while split < W8A8_MAX_SPLIT and _x_share(m, steps, split, elem) > W8A8_X_SHARE:
            split += 1
        if _x_share(m, steps, split, elem) <= W8A8_X_SHARE:
            while (split * 2 <= W8A8_MAX_SPLIT and cols * split * 2 <= 2 * sms
                   and steps >= 8 * split):
                split *= 2
            return W8A8Plan(True, 16 if m <= 16 else 32 if m <= 32 else 64, split)
        split = 1
    bm, bn, bk = W8A8_WG_TILE if n % 16 == 0 and k % 16 == 0 else W8A8_MMA_TILE
    steps, tiles = -(-k // bk), -(-n // bn) * -(-m // bm)
    while split < W8A8_MAX_SPLIT and tiles * split < sms and steps >= 8 * split:
        split *= 2
    return W8A8Plan(False, bm, split)


def _w8a8_reason(lin: QuantLinear) -> Optional[str]:
    if lin.kind != "w8" or lin.zero_point is not None or lin.meta_dict.get("group_size"):
        return "w8a8 kernel takes symmetric per-channel int8 linears"
    if (lin.weight.dtype != torch.int8 or lin.scale.dtype not in (torch.bfloat16, torch.float32)
            or lin.scale.numel() != lin.out_features):
        return "w8a8 kernel takes int8 (K, N) weights with bf16 or f32 (1, N) scales"
    return None


def w8a8_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, w8: torch.Tensor,
                      sw: torch.Tensor) -> torch.Tensor:
    """K10's GEMM in PyTorch, f32 out: the int8 products summed exactly
    (both operands widened to float64, exact for every |sum| < 2^53;
    neither device has an integer ``matmul``), the sum rounded to f32, then
    times the row's scale and the column's, in that order.
    xq (M, K), sx (M,) -> (M, N)."""
    acc = torch.matmul(xq.double(), w8.double()).float()
    return (acc * sx.reshape(-1, 1).float()) * sw.reshape(1, -1).float()


def w8a8_token_matmul_plain(x2: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """K10's whole arithmetic in PyTorch, f32 out: the per-token quantizer
    of ``x2`` (M, K) in f32, then :func:`w8a8_matmul_plain` -> (M, N)."""
    xq, sx = dynamic_quantize_token_int8(x2.float())
    return w8a8_matmul_plain(xq, sx.reshape(-1), lin.weight, lin.scale)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: K10's output types (the C entry's out_type); others are made in f32
_W8A8_OUT = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def _w8a8_launch(wrapper: Callable, lin: QuantLinear, out_dtype: torch.dtype,
                 x2: Optional[torch.Tensor] = None, xq: Optional[torch.Tensor] = None,
                 sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K10 call on the card: x2 (M, K) in ``out_dtype``, quantized by
    the kernel, or the codes xq (M, K) with their scales sx (M,)."""
    a = x2 if x2 is not None else xq
    m, k = a.shape
    n = lin.out_features
    sw = lin.scale.reshape(-1)
    _check_cuda(wrapper.__name__, a, lin.weight, sw, *(() if sx is None else (sx,)))
    plan = w8a8_plan(m, k, n, _sm_count(a.device.index or 0), a.element_size())
    if x2 is not None and not plan.decode:  # the quantizer pass's codes and scales
        xq = torch.empty((m, k), dtype=torch.int8, device=a.device)
        sx = torch.empty((m,), dtype=torch.float32, device=a.device)
    direct = out_dtype in _W8A8_OUT
    out = torch.empty((m, n), dtype=out_dtype if direct else torch.float32, device=a.device)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()
    err = _build.load().qtt_w8a8_matmul(
        ptr(xq), lin.weight.data_ptr(), ptr(sx), sw.data_ptr(), out.data_ptr(), ptr(x2), m, k, n,
        int(sw.dtype == torch.float32), _W8A8_OUT[out.dtype], plan.split, _stream(a.device))
    _build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return out if direct else out.to(out_dtype)


@_count
def w8a8_token_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """A W8A8 linear: x (..., K) in bf16, f16 or f32, quantized per token to
    int8, times a symmetric per-channel int8 linear -> (..., N) in x's
    dtype, in one launch (m <= W8A8_DECODE_ROWS) or two (the quantizer
    pass, then the GEMM). The JAX package's ``w8a8_token_matmul``, bit for
    bit."""
    refuse_grad("w8a8_token_matmul", x, lin.weight, lin.scale)
    reason = _w8a8_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    if x.dtype not in _W8A8_OUT:
        raise KernelUnsupported(f"w8a8 kernel takes bf16, f16 or f32 activations, not {x.dtype}")
    k, n = lin.in_features, lin.out_features
    lead = tuple(x.shape[:-1])
    x2 = aligned16(x.reshape(-1, k).contiguous())
    if x2.device.type == "cpu":
        return w8a8_token_matmul_plain(x2, lin).to(x.dtype).reshape(*lead, n)
    if not x2.is_cuda:
        raise ValueError(f"w8a8_token_matmul: no kernel for device {x2.device}")
    return _w8a8_launch(w8a8_token_matmul, lin, x.dtype, x2=x2).reshape(*lead, n)


@_count
def w8a8_matmul(xq: torch.Tensor, sx: torch.Tensor, lin: QuantLinear,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 activations ``xq`` (..., K) with their per-row f32 scales ``sx``
    (..., 1) times a symmetric per-channel int8 linear -> (..., N) in
    ``out_dtype``: K10's GEMM alone (:func:`w8a8_token_matmul` after its
    quantizer)."""
    refuse_grad("w8a8_matmul", xq, sx, lin.weight, lin.scale)
    reason = _w8a8_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    k, n = lin.in_features, lin.out_features
    lead = tuple(xq.shape[:-1])
    x2 = aligned16(xq.reshape(-1, k).contiguous())
    s2 = sx.reshape(-1).float().contiguous()
    if x2.device.type == "cpu":
        return w8a8_matmul_plain(x2, s2, lin.weight, lin.scale).to(out_dtype).reshape(*lead, n)
    if not x2.is_cuda:
        raise ValueError(f"w8a8_matmul: no kernel for device {x2.device}")
    if x2.dtype != torch.int8 or s2.shape[0] != x2.shape[0]:
        raise ValueError("w8a8_matmul: int8 activations with one scale a row")
    return _w8a8_launch(w8a8_matmul, lin, out_dtype, xq=x2, sx=s2).reshape(*lead, n)


# ---------------------------------------------------------------------------
# NVFP4: packed E2M1 uint8 (K/2, N) or int8-doubled (K, N); bf16 effective
# group scales (K/g, N), halved in the int8 layout
# ---------------------------------------------------------------------------

def _nvfp4_reason(lin: QuantLinear) -> Optional[str]:
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md.get("group_size", 16))
    if lin.zero_point is not None:
        return "asymmetric nvfp4 goes through the reference path"
    if k % (2 * g) or n % 128:
        return f"nvfp4 kernel needs 2g|K and 128|N (k={k}, n={n})"
    if lin.scale.dtype != torch.bfloat16:
        return "nvfp4 kernel takes bf16 scales"
    if lin.weight.dtype == torch.uint8:
        if (k // 2) % (8 * g):  # the JAX kernel's K tiles are multiples of 8g packed rows
            return f"nvfp4 kernel needs 8g | K/2 (k={k}, g={g})"
    elif lin.weight.dtype == torch.int8:
        if k % (8 * g):
            return f"nvfp4 int8 kernel needs 8g | K (k={k}, g={g})"
    else:
        return "nvfp4 kernel takes packed uint8 or int8-doubled weights"
    return None


def nvfp4_matmul_plain(x2: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                       g: int) -> torch.Tensor:
    """The NVFP4 kernels' arithmetic in PyTorch: value * scale in f32 (exact),
    rounded to bf16 once, f32 products and sums, bf16 out. x2 (M, K) -> (M, N)."""
    vals = weight.float() if weight.dtype == torch.int8 else _unpack_fp4(weight)
    w = (vals * scale.float().repeat_interleave(g, dim=0)).to(torch.bfloat16)
    return (x2.float() @ w.float()).to(torch.bfloat16)


def _nvfp4_call(x: torch.Tensor, lin: QuantLinear, entry: str, wrapper: Callable) -> torch.Tensor:
    refuse_grad(wrapper.__name__, x, lin.weight, lin.scale)
    reason = _nvfp4_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    md = lin.meta_dict
    k, n, g = int(md["k"]), int(md["n"]), int(md.get("group_size", 16))
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = nvfp4_matmul_plain(x2, lin.weight, lin.scale, g)
    elif x2.is_cuda:
        out = _launch_matmul(entry, wrapper, x2, lin, g)
    else:
        raise ValueError(f"{wrapper.__name__}: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


@_count
def nvfp4_i8_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for an NVFP4 linear in the int8-doubled layout."""
    if lin.weight.dtype != torch.int8:
        raise KernelUnsupported("nvfp4_i8_matmul takes the int8-doubled layout")
    return _nvfp4_call(x, lin, "qtt_nvfp4_i8_matmul", nvfp4_i8_matmul)


@_count
def nvfp4_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for an NVFP4 linear -> (..., N): packed codes here,
    the int8-doubled layout through :func:`nvfp4_i8_matmul`."""
    if lin.weight.dtype == torch.int8:
        return nvfp4_i8_matmul(x, lin)
    return _nvfp4_call(x, lin, "qtt_nvfp4_matmul", nvfp4_matmul)


# ---------------------------------------------------------------------------
# FP8 block: float8_e4m3fn (K, N); f32 scales (K/128, N/128)
# ---------------------------------------------------------------------------

def _fp8_reason(lin: QuantLinear) -> Optional[str]:
    """Why :func:`fp8_matmul` cannot take ``lin`` (None if it can).

    The conditions of the JAX package's ``fp8_matmul`` as its tests run it
    (interpret mode): the block strategy, 128 x 128 blocks, 128 | K and
    128 | N. Its compiled-TPU refusal (``kernels.py:525-532``: no fused
    formulation beat XLA's dequantize-then-matmul on a v5e) is a fact of
    that chip, not of the function, and is not mirrored. Other fp8
    strategies (channel, group, tensor) take the reference path, as there.
    The payload must be float8_e4m3fn with the f32 (K/128, N/128) grid."""
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    if md.get("strategy") != "block":
        return "fp8 kernel covers the block strategy only"
    if (int(md["block_k"]) != FP8_BLOCK or int(md["block_n"]) != FP8_BLOCK
            or k % FP8_BLOCK or n % FP8_BLOCK):
        return f"fp8 kernel needs 128x128 blocks and 128|K,N (k={k}, n={n})"
    if (lin.weight.dtype != torch.float8_e4m3fn or lin.scale.dtype != torch.float32
            or tuple(lin.scale.shape) != (k // FP8_BLOCK, n // FP8_BLOCK)):
        return "fp8 kernel takes float8_e4m3fn weights with an f32 (K/128, N/128) scale grid"
    return None


def fp8_matmul_plain(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The fp8 kernel's arithmetic in PyTorch: each weight times its
    block's scale in f32, rounded to bf16, f32 products and sums, bf16 out.
    x2 (M, K) -> (M, N)."""
    up = scale.float().repeat_interleave(FP8_BLOCK, dim=0).repeat_interleave(FP8_BLOCK, dim=1)
    w = (w8.float() * up).to(torch.bfloat16)
    return (x2.float() @ w.float()).to(torch.bfloat16)


@_count
def fp8_matmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x (..., K) @ W^T for an FP8 block-scaled linear -> (..., N)."""
    refuse_grad("fp8_matmul", x, lin.weight, lin.scale)
    reason = _fp8_reason(lin)
    if reason:
        raise KernelUnsupported(reason)
    k, n = lin.in_features, lin.out_features
    x2, lead = _flatten_x(x, k)
    if x2.device.type == "cpu":
        out = fp8_matmul_plain(x2, lin.weight, lin.scale)
    elif x2.is_cuda:
        _check_cuda("fp8_matmul", x2, lin.weight, lin.scale)
        lib = _build.load()
        m = x2.shape[0]
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
        err = lib.qtt_fp8_matmul(x2.data_ptr(), lin.weight.data_ptr(), lin.scale.data_ptr(),
                                 out.data_ptr(), m, k, n, _stream(x2.device))
        _build.check(err, "fp8_matmul")
        fp8_matmul.launches += 1
    else:
        raise ValueError(f"fp8_matmul: no kernel for device {x2.device}")
    return out.reshape(*lead, n).to(x.dtype)


KERNELS: Dict[str, Callable] = {"w4": w4_matmul, "w8": w8_matmul, "nvfp4": nvfp4_matmul,
                                "fp8": fp8_matmul}
_REASONS: Dict[str, Callable] = {"w4": _w4_reason, "w8": _w8_reason, "nvfp4": _nvfp4_reason,
                                 "fp8": _fp8_reason}


def supports(lin: QuantLinear) -> bool:
    """Does ``lin`` have a kernel that takes its layout and shape?"""
    reason = _REASONS.get(lin.kind)
    return reason is not None and reason(lin) is None


# ---------------------------------------------------------------------------
# Decode attention with in-place KV-cache update
# ---------------------------------------------------------------------------

def decode_reason(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor
                   ) -> Optional[str]:
    if cache_k.dtype != q.dtype or cache_v.dtype != q.dtype or q.dtype != torch.bfloat16:
        return "decode_attention takes a bf16 cache and bf16 queries"
    dk, dv = q.shape[-1], cache_v.shape[-1]
    if dk % 128 or dv % 128:
        return "decode_attention needs 128|head_dim"
    if dk != DECODE_HEAD_DIM or dv != DECODE_HEAD_DIM:
        return f"the decode_attention kernel is built for head_dim {DECODE_HEAD_DIM}"
    if q.shape[2] > DECODE_MAX_REP:
        return f"decode_attention takes at most {DECODE_MAX_REP} query heads per KV head"
    if cache_k.shape[2] % 8:
        return "decode_attention needs 8|S"
    return None


def decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths, sm_scale):
    """The decode-attention kernel's function in PyTorch, with f32 scores
    and sums: writes the new row at ``min(length, S-1)`` in place, attends
    positions <= that row, and keeps masked positions out of every product."""
    B, KV, rep, hd = q.shape
    S = cache_k.shape[2]
    L = lengths.clamp(max=S - 1).long()
    rows = torch.arange(B, device=q.device)
    cache_k[rows, :, L] = new_k.to(cache_k.dtype)
    cache_v[rows, :, L] = new_v.to(cache_v.dtype)
    valid = torch.arange(S, device=q.device)[None, :] <= L[:, None]  # (B, S)
    kf = torch.where(valid[:, None, :, None], cache_k.float(), 0.0)
    vf = torch.where(valid[:, None, :, None], cache_v.float(), 0.0)
    scores = torch.einsum("bkrd,bksd->bkrs", q.float(), kf) * sm_scale
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    # the probabilities are rounded to the activation dtype before the value
    # product, as in the JAX package's Pallas kernel; the CUDA kernel rounds
    # them too, before it normalises them (against its running max of each
    # share of positions, so at most 2^-9 of each term apart)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return torch.einsum("bkrs,bksd->bkrd", probs, vf).to(q.dtype)


@_count
def decode_attention(q: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """One-token GQA attention over a head-major cache, written in place.

    q (B, KV, rep, hd); new_k/new_v (B, KV, hd); cache_k/cache_v
    (B, KV, S, hd), updated in place at row ``min(lengths[b], S-1)``;
    lengths (B,) int32. Returns ctx (B, KV, rep, hd). The caller advances
    ``lengths``."""
    refuse_grad("decode_attention", q, new_k, new_v, cache_k, cache_v)
    reason = decode_reason(q, cache_k, cache_v)
    if reason:
        raise KernelUnsupported(reason)
    if q.device.type == "cpu":
        return decode_attention_plain(q, new_k, new_v, cache_k, cache_v, lengths, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, KV, rep, hd = q.shape
    S = cache_k.shape[2]
    _check_cache_bases("decode_attention", cache_k=cache_k, cache_v=cache_v)
    q = aligned16(q.contiguous())
    new_k = aligned16(new_k.to(cache_k.dtype).contiguous())
    new_v = aligned16(new_v.to(cache_v.dtype).contiguous())
    lengths = lengths.to(torch.int32).contiguous()
    _check_cuda("decode_attention", q, new_k, new_v, cache_k, cache_v, lengths)
    lib = _build.load()
    ctx = torch.empty_like(q)
    err = lib.qtt_decode_attention(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), lengths.data_ptr(), ctx.data_ptr(), B, KV, rep, S, hd,
        float(sm_scale), _stream(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return ctx


# ---------------------------------------------------------------------------
# Absorbed-MLA decode attention over the latent cache, appended in place
# ---------------------------------------------------------------------------

def mla_decode_reason(q_abs: torch.Tensor, q_pe: torch.Tensor, cache_c: torch.Tensor,
                      cache_p: torch.Tensor) -> Optional[str]:
    """Why :func:`mla_decode_attention` cannot take these tensors (None if
    it can): the JAX kernel's conditions (a cache of the queries' dtype, so
    that an fp8 latent cache takes the plain attention path; 128 | r and
    128 | rope_pad; 8 | S), bf16, and the widths the CUDA kernel is built
    for."""
    if cache_c.dtype != q_abs.dtype or cache_p.dtype != q_abs.dtype:
        return "mixed-dtype latent cache goes through the plain attention path"
    r, dp, S = q_abs.shape[-1], q_pe.shape[-1], cache_c.shape[2]
    if r % 128 or dp % 128:
        return "mla decode kernel needs 128|r and 128|rope_pad"
    if S % 8:
        return "mla decode kernel needs 8|S"
    if q_abs.dtype != torch.bfloat16 or q_pe.dtype != torch.bfloat16:
        return "mla decode kernel takes bf16 queries and caches"
    if r > MLA_MAX_RANK or dp > MLA_MAX_ROPE or S > MLA_MAX_SLOTS:
        return (f"the mla decode kernel is built for r <= {MLA_MAX_RANK}, rope_pad <= "
                f"{MLA_MAX_ROPE}, S <= {MLA_MAX_SLOTS}")
    return None


def mla_decode_attention_plain(q_abs, q_pe, new_c, new_p, cache_c, cache_p, lengths,
                               sm_scale):
    """The MLA decode kernel's function in PyTorch: writes the new latent
    and rope rows at ``min(length, S-1)`` in place, scores every head
    against positions <= that row as (q_abs . C + q_pe . P) * sm_scale with
    f32 sums, takes an f32 softmax rounded to bf16 (as the JAX package's
    kernel does), and returns ctx_lat = p . C with f32 sums, in bf16.
    Masked positions stay out of every product."""
    B, H, r = q_abs.shape
    S = cache_c.shape[2]
    L = lengths.long().clamp(min=0, max=S - 1)
    rows = torch.arange(B, device=q_abs.device)
    cache_c[rows, 0, L] = new_c.to(cache_c.dtype)
    cache_p[rows, 0, L] = new_p.to(cache_p.dtype)
    valid = torch.arange(S, device=q_abs.device)[None, :] <= L[:, None]  # (B, S)
    C = torch.where(valid[:, :, None], cache_c[:, 0].float(), 0.0)
    P = torch.where(valid[:, :, None], cache_p[:, 0].float(), 0.0)
    scores = (torch.einsum("bhr,bsr->bhs", q_abs.float(), C)
              + torch.einsum("bhd,bsd->bhs", q_pe.float(), P)) * sm_scale
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhs,bsr->bhr", probs, C).to(q_abs.dtype)


@_count
def mla_decode_attention(q_abs: torch.Tensor, q_pe: torch.Tensor, new_c: torch.Tensor,
                         new_p: torch.Tensor, cache_c: torch.Tensor, cache_p: torch.Tensor,
                         lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Absorbed one-token MLA attention over the latent cache, written in
    place.

    q_abs (B, H, r); q_pe (B, H, rope_pad); new_c (B, r); new_p
    (B, rope_pad); cache_c (B, 1, S, r) and cache_p (B, 1, S, rope_pad),
    updated in place at row ``min(lengths[b], S-1)``; lengths (B,) int32.
    Returns ctx_lat (B, H, r). The caller advances ``lengths``."""
    refuse_grad("mla_decode_attention", q_abs, q_pe, new_c, new_p, cache_c, cache_p)
    reason = mla_decode_reason(q_abs, q_pe, cache_c, cache_p)
    if reason:
        raise KernelUnsupported(reason)
    if q_abs.device.type == "cpu":
        return mla_decode_attention_plain(q_abs, q_pe, new_c, new_p, cache_c, cache_p,
                                          lengths, sm_scale)
    if not q_abs.is_cuda:
        raise ValueError(f"mla_decode_attention: no kernel for device {q_abs.device}")
    B, H, r = q_abs.shape
    dp, S = q_pe.shape[2], cache_c.shape[2]
    _check_cache_bases("mla_decode_attention", cache_c=cache_c, cache_p=cache_p)
    q_abs, q_pe = aligned16(q_abs.contiguous()), aligned16(q_pe.contiguous())
    new_c = aligned16(new_c.to(cache_c.dtype).contiguous())
    new_p = aligned16(new_p.to(cache_p.dtype).contiguous())
    lengths = lengths.to(torch.int32).contiguous()
    _check_cuda("mla_decode_attention", q_abs, q_pe, new_c, new_p, cache_c, cache_p, lengths)
    lib = _build.load()
    ctx = torch.empty_like(q_abs)
    err = lib.qtt_mla_decode_attention(
        q_abs.data_ptr(), q_pe.data_ptr(), new_c.data_ptr(), new_p.data_ptr(),
        cache_c.data_ptr(), cache_p.data_ptr(), lengths.data_ptr(), ctx.data_ptr(),
        B, H, r, dp, S, float(sm_scale), _stream(q_abs.device))
    _build.check(err, "mla_decode_attention")
    mla_decode_attention.launches += 1
    return ctx


# ---------------------------------------------------------------------------
# MoE slot FFN: the gated FFN of S (token, expert) slots over expert stacks
# ---------------------------------------------------------------------------

#: payload codes of csrc/moe_slot_ffn.cu
_SLOT_PAYLOAD = {("w4", torch.uint8): 0, ("nvfp4", torch.uint8): 1, ("nvfp4", torch.int8): 2}


def moe_slot_ffn_reason(x: torch.Tensor, gate_el, up_el, down_el) -> Optional[str]:
    """Why :func:`moe_slot_ffn` cannot take these slots (None if it can):
    the JAX kernel's conditions (kind w4 or nvfp4, symmetric, 8|S, 128|D
    and 128|F), plus one payload layout for the three stacks, bf16 scales
    and groups that divide D and F."""
    kind = gate_el.kind
    if kind not in ("w4", "nvfp4"):
        return f"moe_slot_ffn supports w4/nvfp4, got {kind}"
    els = (gate_el, up_el, down_el)
    if any(el.zero_point is not None for el in els):
        return "asymmetric experts go through the gather reference"
    S, D = x.shape
    gm, dm = gate_el.meta_dict, down_el.meta_dict
    Fe = int(gm["n"])
    if S % 8 or D % 128 or int(dm["k"]) % 128:
        return "moe_slot_ffn needs 8|S and 128|D,Fe"
    if (int(gm["k"]) != D or int(dm["k"]) != Fe or int(dm["n"]) != D
            or up_el.meta != gate_el.meta or down_el.kind != kind or up_el.kind != kind):
        return "moe_slot_ffn: gate/up (E, D, F) and down (E, F, D) stacks of one kind"
    payload = {_SLOT_PAYLOAD.get((kind, el.weight.dtype)) for el in els}
    if len(payload) != 1 or None in payload:
        return "moe_slot_ffn takes packed w4, packed nvfp4 or int8-doubled nvfp4 stacks"
    if any(el.scale is None or el.scale.dtype != torch.bfloat16 for el in els):
        return "moe_slot_ffn takes bf16 group scales"
    g = int(gm.get("group_size", 16 if kind == "nvfp4" else 32))
    if D % g or Fe % g or int(dm.get("group_size", g)) != g:
        return f"moe_slot_ffn needs the group ({g}) to divide D and F"
    return None


def moe_slot_ffn_plain(x: torch.Tensor, idx: torch.Tensor, gate_el, up_el,
                       down_el) -> torch.Tensor:
    """The slot kernel's arithmetic in PyTorch: each gathered weight is
    value * scale rounded to bf16, f32 products and sums,
    a = bf16(silu(g) * u), y = a @ down in f32. x (S, D) -> (S, D) f32."""
    from ..models.moe import _slot_dequant

    xs = x.to(torch.bfloat16).float()[:, None, :]
    g = torch.bmm(xs, _slot_dequant(gate_el, idx).float())[:, 0]
    u = torch.bmm(xs, _slot_dequant(up_el, idx).float())[:, 0]
    a = (F.silu(g) * u).to(torch.bfloat16).float()[:, None, :]
    return torch.bmm(a, _slot_dequant(down_el, idx).float())[:, 0]


@_count
def moe_slot_ffn(x: torch.Tensor, idx: torch.Tensor, gate_el, up_el, down_el) -> torch.Tensor:
    """Gated FFN of ``S`` expert slots: x (S, D) (a token row per slot),
    idx (S,) expert ids; gate/up (E, D, F) and down (E, F, D) stacks.
    Returns (S, D) f32, not yet combined."""
    refuse_grad("moe_slot_ffn", x, *(t for el in (gate_el, up_el, down_el)
                                     for t in (el.weight, el.scale)))
    reason = moe_slot_ffn_reason(x, gate_el, up_el, down_el)
    if reason:
        raise KernelUnsupported(reason)
    if x.device.type == "cpu":
        return moe_slot_ffn_plain(x, idx, gate_el, up_el, down_el)
    if not x.is_cuda:
        raise ValueError(f"moe_slot_ffn: no kernel for device {x.device}")
    S, D = x.shape
    Fe = int(gate_el.meta_dict["n"])
    g = int(gate_el.meta_dict.get("group_size", 16 if gate_el.kind == "nvfp4" else 32))
    xb = aligned16(x.to(torch.bfloat16).contiguous())
    ids = idx.to(torch.int32).contiguous()
    ts = [gate_el.weight, gate_el.scale, up_el.weight, up_el.scale, down_el.weight,
          down_el.scale]
    _check_cuda("moe_slot_ffn", xb, ids, *ts)
    lib = _build.load()
    a_ws = torch.empty((S, Fe), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((S, D), dtype=torch.float32, device=x.device)
    payload = _SLOT_PAYLOAD[(gate_el.kind, gate_el.weight.dtype)]
    err = lib.qtt_moe_slot_ffn(payload, xb.data_ptr(), ids.data_ptr(),
                               *(t.data_ptr() for t in ts), a_ws.data_ptr(), out.data_ptr(),
                               S, D, Fe, gate_el.num_experts, g, _stream(x.device))
    _build.check(err, "moe_slot_ffn")
    moe_slot_ffn.launches += 1
    return out


def moe_slot_gu_reason(x: torch.Tensor, gu_el, down_el) -> Optional[str]:
    """Why :func:`moe_slot_gu_ffn` cannot take these slots (None if it
    can): the JAX kernel's conditions without its VMEM limit (kind w8,
    per-channel, symmetric, 8|S, 128|D, 256|2F, down K = F), int8 payloads
    and scales of one row per expert."""
    if gu_el.kind != "w8" or down_el.kind != "w8":
        return "moe_slot_gu_ffn needs the w8pc layout"
    if gu_el.meta_dict.get("group_size") or down_el.meta_dict.get("group_size"):
        return "moe_slot_gu_ffn needs per-channel scales"
    if gu_el.zero_point is not None or down_el.zero_point is not None:
        return "asymmetric experts go through the gather reference"
    S, D = x.shape
    Fe2 = int(gu_el.meta_dict["n"])
    if S % 8 or D % 128 or Fe2 % 256 or int(down_el.meta_dict["k"]) != Fe2 // 2:
        return "moe_slot_gu_ffn geometry mismatch"
    if int(gu_el.meta_dict["k"]) != D or int(down_el.meta_dict["n"]) != D:
        return "moe_slot_gu_ffn: gate|up (E, D, 2F) and down (E, F, D) stacks"
    if gu_el.weight.dtype != torch.int8 or down_el.weight.dtype != torch.int8:
        return "moe_slot_gu_ffn takes int8 stacks"
    if gu_el.scale.shape[-2] != 1 or down_el.scale.shape[-2] != 1:
        return "moe_slot_gu_ffn takes (E, 1, N) per-channel scales"
    return None


def moe_slot_gu_ffn_plain(x: torch.Tensor, idx: torch.Tensor, gu_el, down_el) -> torch.Tensor:
    """The fused slot kernel's arithmetic in PyTorch: int8 values (exact in
    bf16) times bf16 x summed in f32, the per-channel f32 scales applied to
    the sums, a = bf16(silu(g) * u). x (S, D) -> (S, D) f32."""
    i = idx.long()
    S = x.shape[0]
    xs = x.to(torch.bfloat16).float()[:, None, :]
    guv = torch.bmm(xs, gu_el.weight[i].float())[:, 0] * gu_el.scale[i].float().reshape(S, -1)
    Fe = guv.shape[-1] // 2
    a = (F.silu(guv[:, :Fe]) * guv[:, Fe:]).to(torch.bfloat16).float()[:, None, :]
    return (torch.bmm(a, down_el.weight[i].float())[:, 0]
            * down_el.scale[i].float().reshape(S, -1))


@_count
def moe_slot_gu_ffn(x: torch.Tensor, idx: torch.Tensor, gu_el, down_el) -> torch.Tensor:
    """Gated FFN of ``S`` expert slots over the fused w8pc layout: gate|up
    int8 (E, D, 2F) with f32 scales (E, 1, 2F), down int8 (E, F, D) with
    (E, 1, D). Returns (S, D) f32, not yet combined."""
    refuse_grad("moe_slot_gu_ffn", x, gu_el.weight, gu_el.scale, down_el.weight, down_el.scale)
    reason = moe_slot_gu_reason(x, gu_el, down_el)
    if reason:
        raise KernelUnsupported(reason)
    if x.device.type == "cpu":
        return moe_slot_gu_ffn_plain(x, idx, gu_el, down_el)
    if not x.is_cuda:
        raise ValueError(f"moe_slot_gu_ffn: no kernel for device {x.device}")
    S, D = x.shape
    Fe = int(gu_el.meta_dict["n"]) // 2
    xb = aligned16(x.to(torch.bfloat16).contiguous())
    ids = idx.to(torch.int32).contiguous()
    # the scales may be bf16: widening them is exact
    ts = [gu_el.weight, gu_el.scale.float().contiguous(), down_el.weight,
          down_el.scale.float().contiguous()]
    _check_cuda("moe_slot_gu_ffn", xb, ids, *ts)
    lib = _build.load()
    a_ws = torch.empty((S, Fe), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((S, D), dtype=torch.float32, device=x.device)
    err = lib.qtt_moe_slot_gu_ffn(xb.data_ptr(), ids.data_ptr(), *(t.data_ptr() for t in ts),
                                  a_ws.data_ptr(), out.data_ptr(), S, D, Fe,
                                  gu_el.num_experts, _stream(x.device))
    _build.check(err, "moe_slot_gu_ffn")
    moe_slot_gu_ffn.launches += 1
    return out


# ---------------------------------------------------------------------------
# GPTQ: the serial column elimination inside one block of columns
# ---------------------------------------------------------------------------

#: the widest block K11 takes (csrc/gptq_block.cu): its rows of U fill 64 KB
#: of shared memory
GPTQ_MAX_BLOCK = 128


def gptq_block_plain(w_blk: torch.Tensor, u_blk: torch.Tensor, scale: torch.Tensor,
                     zp: Optional[torch.Tensor], col_group: torch.Tensor, qmin: float,
                     qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's arithmetic in PyTorch, the JAX package's ``col_step`` loop
    (``quantizers_tpu/oneshot/gptq.py:93-113``) column by column: snap
    column i onto the grid of its scale group (``x / s``, ``+ zp``
    when asymmetric, round half to even, clamp), dequantize it, ``err = (w
    - dq) / U[i, i]`` and ``w[:, c] -= err * U[i, c]`` for c > i, each
    operation rounded once. ``w_blk`` (N, bs) f32 is not modified; ``zp``
    None is symmetric; ``col_group`` (bs,) maps each column to its column of
    ``scale`` (N, G). Returns the grid values Q and the errors Err, (N, bs)
    f32. It works on the transposed block, so that a column and the update
    of the later ones are contiguous rows (on a CPU 30x faster at N 9728
    than strided columns, with the same roundings), in a buffer of its own
    (``.t().contiguous()`` of one row is a view of it)."""
    wt = w_blk.new_empty((w_blk.shape[1], w_blk.shape[0]), dtype=torch.float32).copy_(w_blk.t())
    st = scale.float().t().contiguous()
    zt = None if zp is None else zp.t().contiguous()
    q_out, err_out = torch.empty_like(wt), torch.empty_like(wt)
    for i, g in enumerate(col_group.tolist()):
        s = st[g]
        x = wt[i] / s
        if zt is not None:
            x = x + zt[g]
        q = torch.clamp(torch.round(x), qmin, qmax)
        dq = (q - zt[g] if zt is not None else q) * s
        err = (wt[i] - dq) / u_blk[i, i]
        wt[i + 1:] -= u_blk[i, i + 1:, None] * err[None, :]
        q_out[i], err_out[i] = q, err
    # contiguous (N, bs), as the kernel writes them: the tail product reads
    # Err in the same layout on both routes
    return q_out.t().contiguous(), err_out.t().contiguous()


def _rows_aligned(t: torch.Tensor) -> bool:
    """Rows of contiguous f32 that each start 16-byte aligned."""
    return t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0


def gptq_operands(device: torch.device, scale: torch.Tensor, zp: Optional[torch.Tensor],
                  col_group: torch.Tensor):
    """The scales, zero points (None: symmetric) and column groups of a
    whole solve as K11 reads them: contiguous f32, int32 and int32 on
    ``device``. :func:`gptq_block` makes them at every call; a solve on the
    card makes them once (``oneshot/gptq.py:_block_route``) and hands them
    to :func:`gptq_block_launcher`'s launches, block by block."""
    scale = scale.float().contiguous()
    cg = col_group.to(torch.int32).contiguous()
    zp = None if zp is None else zp.to(torch.int32).contiguous()
    if any(t.device != device for t in (scale, cg, *(() if zp is None else (zp,)))):
        raise ValueError("gptq_block: tensors on more than one device")
    if zp is not None and zp.shape != scale.shape:
        raise ValueError("gptq_block: zero points unlike the scales")
    return scale, zp, cg


def _gptq_launch(w_blk: torch.Tensor, u_blk: torch.Tensor, scale: torch.Tensor,
                 zp: Optional[torch.Tensor], cg: torch.Tensor, qmin: float, qmax: float, *,
                 sms: int, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 on one block of operands that :func:`gptq_operands` made: a block
    whose width is not a multiple of 4 is padded with columns that come
    after all of its own (so they change none of its results), W and U rows
    that are not 16-byte aligned are copied."""
    refuse_grad("gptq_block", w_blk, u_blk)
    n, bs = w_blk.shape
    pad = -bs % 4
    if pad:
        w_blk = F.pad(w_blk.float(), (0, pad))
        u_blk = F.pad(u_blk.float(), (0, pad, 0, pad))
        u_blk.diagonal()[bs:] = 1.0
        cg = F.pad(cg, (0, pad))
    bw = bs + pad
    if w_blk.dtype != torch.float32 or not _rows_aligned(w_blk):
        w_blk = aligned16(w_blk.float().contiguous())
    if u_blk.dtype != torch.float32 or not _rows_aligned(u_blk):
        u_blk = aligned16(u_blk.float().contiguous())
    q, err = torch.empty((2, n, bw), dtype=torch.float32, device=w_blk.device)
    rc = _build.load().qtt_gptq_block(
        w_blk.data_ptr(), w_blk.stride(0), u_blk.data_ptr(), u_blk.stride(0), scale.data_ptr(),
        None if zp is None else zp.data_ptr(), scale.shape[1], cg.data_ptr(), q.data_ptr(),
        err.data_ptr(), n, bw, float(qmin), float(qmax), sms, stream)
    _build.check(rc, "gptq_block")
    gptq_block.launches += 1
    return (q[:, :bs].contiguous(), err[:, :bs].contiguous()) if pad else (q, err)


def gptq_block_launcher(device: torch.device) -> Callable:
    """:func:`gptq_block`'s launch on ``device`` (a card), for operands that
    :func:`gptq_operands` made: the block function of a solve on the card,
    with the SM count and the current stream read once."""
    return functools.partial(_gptq_launch, sms=_sm_count(device.index or 0),
                             stream=_stream(device))


@_count
def gptq_block(w_blk: torch.Tensor, u_blk: torch.Tensor, scale: torch.Tensor,
               zp: Optional[torch.Tensor], col_group: torch.Tensor, qmin: float,
               qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of GPTQ's column elimination (:func:`gptq_block_plain`),
    bit for bit. ``w_blk`` and ``u_blk`` may be views into the whole W and U
    (their rows strided); a block narrower than GPTQ_MAX_BLOCK is taken as
    it is, one whose width is not a multiple of 4 is padded with columns
    that come after all of its own (so they change none of its results)."""
    refuse_grad("gptq_block", w_blk, u_blk, scale)
    n, bs = w_blk.shape
    if u_blk.shape != (bs, bs) or col_group.shape != (bs,) or bs > GPTQ_MAX_BLOCK:
        raise KernelUnsupported(f"gptq block takes (N, bs <= {GPTQ_MAX_BLOCK}) W with a "
                                f"(bs, bs) U and bs groups: {tuple(w_blk.shape)}, "
                                f"{tuple(u_blk.shape)}, {tuple(col_group.shape)}")
    if w_blk.device.type == "cpu":
        return gptq_block_plain(w_blk, u_blk, scale, zp, col_group, qmin, qmax)
    if not w_blk.is_cuda:
        raise ValueError(f"gptq_block: no kernel for device {w_blk.device}")
    if u_blk.device != w_blk.device:
        raise ValueError("gptq_block: tensors on more than one device")
    scale, zp, cg = gptq_operands(w_blk.device, scale, zp, col_group)
    return gptq_block_launcher(w_blk.device)(w_blk, u_blk, scale, zp, cg, qmin, qmax)


ALL_KERNELS = (w4_matmul, w8_matmul, decode_attention, nvfp4_matmul, nvfp4_i8_matmul,
               moe_slot_ffn, moe_slot_gu_ffn, flash_attention, fp8_matmul,
               mla_decode_attention, w8a8_token_matmul, w8a8_matmul, gptq_block)


def reset_launch_counts() -> None:
    for fn in ALL_KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in ALL_KERNELS}
