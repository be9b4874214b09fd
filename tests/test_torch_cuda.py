"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA card is present. On a machine
with one (and without JAX, which the repository's conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: for the matmuls 1e-2 of the plain output's
largest |value| (bf16 outputs, f32 sums in another order); for decode
attention 2e-2 of each (row, KV head)'s own largest |value| (both sides
round p to bf16, the kernel before it normalises, against the running max
of its share of positions), so that long rows, whose values are small,
are held as closely as short ones; for the slot FFNs 1e-2 of each slot
row's largest |value| (f32 outputs; a, rounded to bf16 on both sides, may
round the other way after sums in another order), 1e-3 for K7 on one-hot
rows of x (each gate and up sum one exact product); for flash attention 2e-2
of each (b, h, t) row's largest |value| (p rounded to bf16 against a running
max over 128-key tiles in the kernel, 64 at head dim 256, and 256-key tiles
in the plain version);
for the MLA decode kernel 2e-2 of each (row, head)'s largest |value| (p is
rounded to bf16 on both sides, after f32 sums in another order), its cache
rows exactly. The matmul, slot, flash and both decode-attention kernels
sum in a fixed order, so a second call gives the same bits.
"""

import math

import numpy as np
import pytest
import torch

from quantizers_tpu_torch.models.moe import ExpertLinears
from quantizers_tpu_torch.ops import kernels as K
from quantizers_tpu_torch.ops.linear import QuantLinear, _unpack_fp4, nvfp4_packed_to_i8

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, rtol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rtol * ref.float().abs().max().item()


#: (m, k, n, g) for the w4 kernel: the tensor-core body at g 16, 32 and 64
#: (scales staged with the weights) and 48 and 128 (read from device memory),
#: with 1, 3, 5, 9, 17, 33, 40, 65, 129 and 512 rows (every 8-row grouping of
#: a block, ragged last tiles, 2 and 8 row tiles); the CUDA-core body at g 8
#: and 24. The small ones are held against the JAX Pallas kernel on the CPU
#: (tests/test_torch_w4.py).
W4_SMALL = [(3, 1024, 384, 64), (40, 1024, 256, 32), (5, 768, 128, 48), (9, 2048, 256, 128),
            (1, 512, 256, 32), (17, 256, 128, 16), (65, 512, 256, 16), (129, 1024, 384, 32),
            (512, 1024, 256, 64), (33, 1536, 256, 48), (64, 2048, 128, 128),
            (8, 512, 256, 8), (65, 256, 128, 8), (9, 768, 128, 24)]
#: the four Qwen3-4B decode calls (qkv, o_proj, gate|up, down) at g 32 with
#: 8 rows (decode), 32 and 128 (the batcher's row prefills)
W4_QWEN3 = [(m, k, n, 32) for m in (8, 32, 128)
            for k, n in ((2560, 6144), (4096, 2560), (2560, 19456), (9728, 2560))]
W4_SHAPES = W4_QWEN3 + W4_SMALL


def _w4(gen, k, n, g):
    return QuantLinear(
        kind="w4",
        weight=torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, device="cuda", generator=gen),
        scale=(torch.rand((k // g, n), device="cuda", generator=gen) * 0.01).bfloat16(),
        meta=(("k", k), ("n", n), ("group_size", g)))


@pytest.mark.parametrize("m,k,n,g", W4_SHAPES)
def test_w4_kernel_matches_plain(gen, m, k, n, g):
    lin = _w4(gen, k, n, g)
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = K.w4_matmul.launches
    got = K.w4_matmul(x, lin)
    assert K.w4_matmul.launches == before + 1 and got.shape == (m, n)
    _close(got, K.w4_matmul_plain(x, lin.weight, lin.scale, g), 1e-2)
    assert torch.equal(K.w4_matmul(x, lin), got)


def w4_one_hot_case(k, n, g, seed):
    """Packed codes over all 16 values in both nibbles (each column of a
    packed row sees every code in each nibble) and bf16 scales from
    subnormals (exponent 0, the smallest 2^-133 among them) up to the
    largest s at which 8 s is finite in bf16 (exponent 251, mantissa 127),
    in both planes. Returns the packed bytes, the scales and the
    dequantized weight bf16((c - 8) s), each product exact in f32."""
    from quantizers_tpu_torch.ops.linear import _unpack_nibbles

    idx = torch.arange((k // 2) * n).reshape(k // 2, n)
    lo, hi = idx % 16, (idx // 16 + 7 * idx) % 16
    assert len(torch.unique(lo[0])) == 16 and len(torch.unique(hi[0])) == 16
    packed = (lo | (hi << 4)).to(torch.uint8)
    rng = np.random.default_rng(seed)
    expo = rng.integers(0, 252, (k // g, n))
    mant = rng.integers(0, 128, (k // g, n))
    half = k // (2 * g)  # the hi plane's first group
    expo[0], mant[0, :2] = 0, (1, 0)  # subnormal scales, the smallest first, in both planes
    expo[half], mant[half, :2] = 0, (1, 0)
    expo[1], mant[1] = 251, 127  # the largest
    expo[half + 1] = 251
    bits = (expo << 7) | mant
    scale = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    wq = (_unpack_nibbles(packed).float() * scale.float().repeat_interleave(g, dim=0)).bfloat16()
    assert torch.isfinite(wq.float()).all() and (wq[:g] != 0).any()
    return packed, scale, wq


@pytest.mark.parametrize("g,k,m", [(32, 512, 8), (16, 512, 64), (64, 1024, 8), (48, 768, 8),
                                   (128, 2048, 16), (8, 256, 8), (24, 384, 8)])
def test_w4_kernel_reads_out_every_weight_exactly(gen, g, k, m):
    """One-hot rows of x read the weights out through the kernel (both
    bodies, staged and unstaged scales): every code in both nibbles times
    scales from bf16 subnormals to the top of the range. The kernel never
    rounds (c - 8) s to bf16; it multiplies the f32 partial sum by the
    scale, which for one-hot rows is (c - 8) s exactly in f32, rounded once
    at the output: bit for bit the plain version's and the dequantized
    rows. This pins the fragment mapping of both planes, the nibble decode
    and the scale of every column and group."""
    n = 256
    packed, scale, wq = w4_one_hot_case(k, n, g, seed=g)
    packed, scale, wq = packed.cuda(), scale.cuda(), wq.cuda()
    lin = QuantLinear(kind="w4", weight=packed, scale=scale,
                      meta=(("k", k), ("n", n), ("group_size", g)))
    rows = torch.arange(m, device="cuda")
    for r0 in range(0, k, m):
        x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
        x[rows, r0 + rows] = 1
        got = K.w4_matmul(x, lin)
        ref = K.w4_matmul_plain(x, packed, scale, g)
        assert torch.equal(ref, wq[r0:r0 + m])
        assert torch.equal(got, ref), (r0, (got != ref).nonzero()[:4].tolist())


#: (m, k, n, g, scale dtype) for the w8 kernel (g None: per channel). The
#: tensor-core body with the scale on each column's finished f32 sum: the
#: three int8 heads at decode (slice 1's and path A's, vocab 151936 padded to
#: 152064, and path E's, 102400 padded to 102912), m 64 and 65 (one full and
#: one ragged 64-row tile), the w8pc experts' (2048, 1536) and (768, 2048)
#: with f32 scales at the row prefills' m 32 and 128 and at 512; with a fold
#: a k16 step: g 16, 32, 64 and 128 (scale rows staged with the weights) and
#: 48 (read from device memory); the CUDA-core body at g 8.
W8_SHAPES = [(8, 2560, 152064, None, torch.bfloat16), (5, 512, 256, 32, torch.bfloat16),
             (64, 2560, 1024, None, torch.bfloat16), (128, 2048, 1536, None, torch.float32),
             (128, 768, 2048, None, torch.float32), (3, 512, 256, 32, torch.float32),
             (8, 2048, 152064, None, torch.bfloat16), (8, 2048, 102912, None, torch.bfloat16),
             (32, 2048, 1536, None, torch.float32), (32, 768, 2048, None, torch.float32),
             (512, 2048, 1536, None, torch.float32), (512, 768, 2048, None, torch.float32),
             (65, 2560, 1024, None, torch.bfloat16), (65, 1024, 384, 64, torch.bfloat16),
             (8, 1024, 256, 64, torch.float32), (17, 512, 256, 16, torch.bfloat16),
             (65, 512, 128, 16, torch.float32), (9, 768, 256, 48, torch.bfloat16),
             (33, 2048, 256, 128, torch.float32), (8, 512, 256, 8, torch.bfloat16),
             (65, 256, 384, 8, torch.float32)]


def _w8(gen, k, n, g, sdt):
    rows = k // g if g else 1
    return QuantLinear(
        kind="w8",
        weight=torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen),
        scale=(torch.rand((rows, n), device="cuda", generator=gen) * 0.01).to(sdt),
        meta=(("k", k), ("n", n), ("group_size", g)))


@pytest.mark.parametrize("m,k,n,g,sdt", W8_SHAPES)
def test_w8_kernel_matches_plain(gen, m, k, n, g, sdt):
    lin = _w8(gen, k, n, g, sdt)
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = K.w8_matmul.launches
    got = K.w8_matmul(x, lin)
    assert K.w8_matmul.launches == before + 1 and got.shape == (m, n)
    _close(got, K.w8_matmul_plain(x, lin.weight, lin.scale, g), 1e-2)
    assert torch.equal(K.w8_matmul(x, lin), got)


def w8_one_hot_case(k, n, g, sdt, seed):
    """int8 codes over all 256 values (column j of row r holds code
    (37 r + 11 j) mod 256 - 128, so each column sees every code in each 256
    rows) and scales from subnormals (the smallest first) up to where
    128 s is still finite after the bf16 rounding, in bf16 or f32. Returns
    the codes, the scales and the dequantized weight bf16(f32(c s))."""
    r = torch.arange(k)[:, None]
    j = torch.arange(n)[None, :]
    w = ((37 * r + 11 * j) % 256 - 128).to(torch.int8)
    rng = np.random.default_rng(seed)
    rows = k // g if g else 1
    if sdt == torch.bfloat16:
        expo = rng.integers(0, 248, (rows, n))
        mant = rng.integers(0, 128, (rows, n))
        expo[0], mant[0, :2] = 0, (1, 0)  # subnormal scales, the smallest first
        expo[-1, :4] = 247  # the largest
        scale = torch.from_numpy(((expo << 7) | mant).astype(np.int16)).view(torch.bfloat16)
    else:
        expo = rng.integers(0, 247, (rows, n))
        mant = rng.integers(0, 1 << 23, (rows, n))
        expo[0], mant[0, :2] = 0, (1, 0)
        expo[-1, :4], mant[-1, :4] = 246, (1 << 23) - 1
        scale = torch.from_numpy(((expo << 23) | mant).astype(np.int32)).view(torch.float32)
    wq = (w.float() * scale.float().repeat_interleave(g or k, dim=0)).bfloat16()
    assert torch.isfinite(wq.float()).all() and (wq != 0).any()
    assert len(torch.unique(w[:256, 0])) == 256
    return w, scale, wq


@pytest.mark.parametrize("g,k,m,sdt", [(None, 512, 8, torch.bfloat16),
                                       (None, 512, 8, torch.float32),
                                       (32, 512, 8, torch.bfloat16), (32, 512, 8, torch.float32),
                                       (None, 512, 64, torch.bfloat16), (16, 256, 16, torch.float32),
                                       (48, 768, 32, torch.bfloat16), (8, 256, 8, torch.float32)])
def test_w8_kernel_reads_out_every_weight_exactly(gen, g, k, m, sdt):
    """One-hot rows of x read the weights out through the kernel (every
    scale mode of both bodies, bf16 and f32 scales): every int8 code times
    scales from subnormals to the top of the range. The codes are decoded
    exactly and the scale multiplies the f32 sum, which for a one-hot row is
    c s in f32, rounded once at the output: bit for bit the plain version's
    and bf16(f32(c s)). This pins the fragment mapping, the decode over the
    full code range and the scale of every column and group."""
    n = 256
    w, scale, wq = w8_one_hot_case(k, n, g, sdt, seed=k + (g or 0))
    w, scale, wq = w.cuda(), scale.cuda(), wq.cuda()
    lin = QuantLinear(kind="w8", weight=w, scale=scale,
                      meta=(("k", k), ("n", n), ("group_size", g)))
    rows = torch.arange(m, device="cuda")
    for r0 in range(0, k, m):
        x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
        x[rows, r0 + rows] = 1
        got = K.w8_matmul(x, lin)
        ref = K.w8_matmul_plain(x, w, scale, g)
        assert torch.equal(ref, wq[r0:r0 + m])
        assert torch.equal(got, ref), (r0, (got != ref).nonzero()[:4].tolist())


#: (B, KV, rep, S, lengths): slice 1's and path A's shapes, rep 1, and a
#: 2048-slot cache whose lengths leave some ranks of the split empty and some
#: full (None: random lengths, the first 0)
DECODE_CASES = [(8, 8, 4, 512, None), (3, 2, 8, 64, None), (8, 4, 8, 512, None),
                (2, 8, 1, 64, None), (8, 8, 4, 2048, (0, 1, 15, 16, 17, 300, 2047, 2048 + 5))]


def _decode_case(gen, B, KV, rep, S, lengths=None):
    """Decode-attention inputs with NaN in every stale cache row (past
    min(length, S - 1)): they must never reach a product."""
    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    q, nk, nv, ck, cv = rnd(B, KV, rep, 128), rnd(B, KV, 128), rnd(B, KV, 128), \
        rnd(B, KV, S, 128), rnd(B, KV, S, 128)
    if lengths is None:
        lengths = torch.randint(0, S + 8, (B,), dtype=torch.int32, device="cuda", generator=gen)
        lengths[0] = 0
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    stale = torch.arange(S, device="cuda")[None, :] > lengths.clamp(max=S - 1)[:, None]
    ck[stale[:, None, :, None].expand_as(ck)] = float("nan")
    cv[stale[:, None, :, None].expand_as(cv)] = float("nan")
    return q, nk, nv, ck, cv, lengths


def _same(a, b):
    return torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


@pytest.mark.parametrize("B,KV,rep,S,lengths", DECODE_CASES)
def test_decode_attention_matches_plain(gen, B, KV, rep, S, lengths):
    q, nk, nv, ck, cv, lengths = _decode_case(gen, B, KV, rep, S, lengths)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got = K.decode_attention(q, nk, nv, k1, v1, lengths, 1 / math.sqrt(128))
    ref = K.decode_attention_plain(q, nk, nv, k2, v2, lengths, 1 / math.sqrt(128))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # each (row, KV head) against its own largest |value|
    err = (got.float() - ref.float()).abs().amax(dim=(2, 3))
    assert (err <= 2e-2 * ref.float().abs().amax(dim=(2, 3))).all(), err
    assert _same(k1, k2) and _same(v1, v2)
    rows, L = torch.arange(B, device="cuda"), lengths.clamp(max=S - 1).long()
    assert torch.equal(k1[rows, :, L], nk) and torch.equal(v1[rows, :, L], nv)


def test_decode_attention_repeats_bit_for_bit(gen):
    """The split's partials are added in a fixed order: two calls on copies
    of the same inputs give the same ctx and caches, bit for bit."""
    q, nk, nv, ck, cv, lengths = _decode_case(gen, 8, 8, 4, 2048,
                                              (0, 1, 15, 16, 17, 300, 2047, 2048 + 5))
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got = K.decode_attention(q, nk, nv, k1, v1, lengths, 1 / math.sqrt(128))
    again = K.decode_attention(q.clone(), nk.clone(), nv.clone(), k2, v2, lengths.clone(),
                               1 / math.sqrt(128))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _same(k1, k2) and _same(v1, v2)


def _nvfp4(gen, k, n, layout, g=16):
    packed = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, device="cuda", generator=gen)
    scale = (torch.rand((k // g, n), device="cuda", generator=gen) * 0.01 + 0.001).bfloat16()
    if layout == "int8":
        packed, scale = nvfp4_packed_to_i8(packed), (scale.float() * 0.5).bfloat16()
    return QuantLinear(kind="nvfp4", weight=packed, scale=scale,
                       meta=(("k", k), ("n", n), ("group_size", g)))


@pytest.mark.parametrize("layout", ["packed", "int8"])
@pytest.mark.parametrize("m,k,n", [(8, 2560, 6144), (8, 9728, 2560), (128, 2048, 768),
                                   (128, 768, 2048), (3, 512, 256)])
def test_nvfp4_kernels_match_plain(gen, layout, m, k, n):
    lin = _nvfp4(gen, k, n, layout)
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    wrapper = K.nvfp4_i8_matmul if layout == "int8" else K.nvfp4_matmul
    before = wrapper.launches
    got = K.nvfp4_matmul(x, lin)
    assert wrapper.launches == before + 1
    _close(got, K.nvfp4_matmul_plain(x, lin.weight, lin.scale, 16), 1e-2)
    assert torch.equal(K.nvfp4_matmul(x, lin), got)


#: (m, k, n, g) for the int8-doubled kernel: ragged and edge row counts at
#: the smallest shape the wrapper admits (k 128, n 128), the row prefills'
#: expert shapes, and groups other than NVFP4's 16 (the kernel reads their
#: scales per K row; k 576 ends in a partial stage)
NVFP4_I8_SHAPES = [(1, 128, 128, 16), (9, 128, 128, 16), (64, 128, 128, 16),
                   (65, 128, 128, 16), (512, 128, 128, 16), (128, 2048, 768, 16),
                   (128, 768, 2048, 16), (8, 512, 256, 8), (65, 576, 128, 8),
                   (8, 512, 256, 32), (33, 768, 384, 32), (9, 384, 128, 48)]


@pytest.mark.parametrize("m,k,n,g", NVFP4_I8_SHAPES)
def test_nvfp4_i8_kernel_shapes_match_plain(gen, m, k, n, g):
    lin = _nvfp4(gen, k, n, "int8", g)
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = K.nvfp4_i8_matmul.launches
    got = K.nvfp4_i8_matmul(x, lin)
    assert K.nvfp4_i8_matmul.launches == before + 1 and got.shape == (m, n)
    _close(got, K.nvfp4_matmul_plain(x, lin.weight, lin.scale, g), 1e-2)
    assert torch.equal(K.nvfp4_i8_matmul(x, lin), got)


def test_nvfp4_i8_kernel_reads_out_every_weight_exactly(gen):
    """One-hot rows of x read the dequantized weights out through the
    kernel: every doubled E2M1 value times scales from bf16 subnormals up to
    the largest exponent at which 12 x scale stays finite. The output must
    equal the plain version's bit for bit (a single product each, so no sum
    order enters), which pins the fragment mapping and the dequantization."""
    m, k, n, g = 8, 512, 256, 16
    vals = torch.tensor([0, 1, -1, 2, -2, 3, -3, 4, -4, 6, -6, 8, -8, 12, -12], dtype=torch.int8)
    w8 = vals[torch.arange(k * n).reshape(k, n) % 15].cuda()
    rng = np.random.default_rng(7)
    expo = rng.integers(0, 251, (k // g, n))
    expo[0], expo[1], expo[2] = 0, 1, 250  # subnormal scales and the top of the range
    bits = (expo << 7) | rng.integers(0, 128, (k // g, n))
    scale = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16).cuda()
    lin = QuantLinear(kind="nvfp4", weight=w8, scale=scale,
                      meta=(("k", k), ("n", n), ("group_size", g)))
    wq = (w8.float() * scale.float().repeat_interleave(g, dim=0)).bfloat16()
    assert torch.isfinite(wq.float()).all() and (wq[:2 * g] != 0).any()
    for r0 in range(0, k, m):
        x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
        rows = torch.arange(m, device="cuda")
        x[rows, r0 + rows] = 1
        got = K.nvfp4_i8_matmul(x, lin)
        ref = K.nvfp4_matmul_plain(x, w8, scale, g)
        assert torch.equal(ref, wq[r0:r0 + m])
        assert torch.equal(got, ref), (r0, (got != ref).nonzero()[:4].tolist())


#: (m, k, n, g) for the packed kernel: ragged row counts (1, 9, 17, 65 and
#: two 64-row tiles at 130) at the smallest K the wrapper admits at g 16,
#: groups 8 and 32, groups 12 and 20, at which K/2 ends in a partial
#: 64-row stage (the kernel reads their scales per K row), the four
#: Qwen3-4B decode calls and the row prefills' expert shapes. The small
#: ones are held against the JAX Pallas kernel on the CPU
#: (tests/test_torch_nvfp4.py).
NVFP4_PACKED_SMALL = [(1, 256, 128, 16), (9, 256, 128, 16), (17, 512, 256, 16),
                      (65, 256, 128, 16), (130, 512, 256, 16), (8, 512, 256, 8),
                      (33, 1024, 384, 32), (9, 192, 128, 12), (65, 576, 256, 12),
                      (5, 320, 128, 20)]
NVFP4_PACKED_SHAPES = NVFP4_PACKED_SMALL + [
    (8, 2560, 6144, 16), (8, 4096, 2560, 16), (8, 2560, 19456, 16), (8, 9728, 2560, 16),
    (128, 2048, 768, 16), (128, 768, 2048, 16)]


@pytest.mark.parametrize("m,k,n,g", NVFP4_PACKED_SHAPES)
def test_nvfp4_packed_kernel_shapes_match_plain(gen, m, k, n, g):
    lin = _nvfp4(gen, k, n, "packed", g)
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = K.nvfp4_matmul.launches
    got = K.nvfp4_matmul(x, lin)
    assert K.nvfp4_matmul.launches == before + 1 and got.shape == (m, n)
    _close_rows(got.float(), K.nvfp4_matmul_plain(x, lin.weight, lin.scale, g).float(), 1e-2)
    assert torch.equal(K.nvfp4_matmul(x, lin), got)


def test_nvfp4_packed_kernel_reads_out_every_weight_exactly(gen):
    """One-hot rows of x read the dequantized weights out through the
    packed kernel: all 16 E2M1 codes in both nibbles of a byte (each column
    of a row sees every code in each nibble) times bf16 scales from
    subnormals (exponent 0) up to the largest exponent at which 6 x scale
    stays finite. Columns 0-127 hold scales below 4 only (up to 3.98), so
    their warps take the kernel's one-multiply path; columns 128-255 span
    the whole range and take the two-multiply one. The output must equal
    the plain version's bit for bit (a single product each, so no sum
    order enters), which pins the fragment mapping of both planes, the
    decode, both paths and the scale planes."""
    m, k, n, g = 8, 512, 256, 16
    idx = torch.arange((k // 2) * n).reshape(k // 2, n)
    lo, hi = idx % 16, (idx // 16 + 7 * idx) % 16
    packed = (lo | (hi << 4)).to(torch.uint8).cuda()
    rng = np.random.default_rng(11)
    expo = np.concatenate([rng.integers(0, 129, (k // g, 128)),
                           rng.integers(0, 252, (k // g, n - 128))], axis=1)
    expo[0], expo[1] = 0, 1  # subnormal scales, in both planes
    expo[k // (2 * g)], expo[k // (2 * g) + 1] = 1, 0
    expo[2, 128:], expo[k // (2 * g) + 2, 128:] = 251, 251  # the top of the range
    mant = rng.integers(0, 128, (k // g, n))
    expo[3, :128], mant[3, :128] = 128, 127  # 3.98, the largest scale of the one-multiply path
    bits = (expo << 7) | mant
    scale = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16).cuda()
    lin = QuantLinear(kind="nvfp4", weight=packed, scale=scale,
                      meta=(("k", k), ("n", n), ("group_size", g)))
    wq = (_unpack_fp4(packed) * scale.float().repeat_interleave(g, dim=0)).bfloat16()
    assert torch.isfinite(wq.float()).all() and (wq[:2 * g] != 0).any()
    assert len(torch.unique(lo[0])) == 16 and len(torch.unique(hi[0])) == 16
    rows = torch.arange(m, device="cuda")
    for r0 in range(0, k, m):
        x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
        x[rows, r0 + rows] = 1
        got = K.nvfp4_matmul(x, lin)
        ref = K.nvfp4_matmul_plain(x, packed, scale, g)
        assert torch.equal(ref, wq[r0:r0 + m])
        assert torch.equal(got, ref), (r0, (got != ref).nonzero()[:4].tolist())


def _offset_view(t):
    """t's values in a contiguous view at element offset 3 of a flat buffer:
    a base that is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 3, dtype=t.dtype, device=t.device)
    view = buf[3:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("kind", ["fp8", "nvfp4_i8", "nvfp4_packed", "w4", "w8"])
def test_matmul_kernels_take_an_offset_view(gen, kind):
    """x at an unaligned base is copied to an aligned one before the launch
    (the kernels refuse unaligned bases): the same bits as the aligned call."""
    m, k, n = 8, 2048, 3072
    if kind == "fp8":
        w = (torch.randn((k, n), device="cuda", generator=gen) * 100).clamp(-448, 448)
        lin = QuantLinear(kind="fp8", weight=w.to(torch.float8_e4m3fn),
                          scale=torch.rand((k // 128, n // 128), device="cuda",
                                           generator=gen) * 1e-4,
                          meta=(("k", k), ("n", n), ("strategy", "block"), ("block_k", 128),
                                ("block_n", 128)))
        wrapper = K.fp8_matmul
    elif kind == "w4":
        lin, wrapper = _w4(gen, k, n, 32), K.w4_matmul
    elif kind == "w8":
        lin, wrapper = _w8(gen, k, n, None, torch.bfloat16), K.w8_matmul
    else:
        layout = "int8" if kind == "nvfp4_i8" else "packed"
        lin = _nvfp4(gen, k, n, layout)
        wrapper = K.nvfp4_i8_matmul if layout == "int8" else K.nvfp4_matmul
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = wrapper.launches
    got = wrapper(_offset_view(x), lin)
    assert wrapper.launches == before + 1
    assert torch.equal(got, wrapper(x, lin))


def test_flash_attention_takes_offset_views(gen):
    from quantizers_tpu_torch.ops.flash import flash_attention

    q, k, v = (torch.randn((1, 8, 256, 128), device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    got = flash_attention(_offset_view(q), _offset_view(k), _offset_view(v), 0.0884)
    assert torch.equal(got, flash_attention(q, k, v, 0.0884))


def test_decode_attention_takes_offset_views(gen):
    """q, new_k and new_v at unaligned bases are copied to aligned ones
    before the launch: the same bits as the aligned call."""
    q, nk, nv, ck, cv, lengths = _decode_case(gen, 8, 4, 8, 512)
    ins = [_offset_view(t) for t in (q, nk, nv)]
    before = K.decode_attention.launches
    got = K.decode_attention(*ins, ck.clone(), cv.clone(), lengths, 1 / math.sqrt(128))
    assert K.decode_attention.launches == before + 1
    assert torch.equal(got, K.decode_attention(q, nk, nv, ck.clone(), cv.clone(), lengths,
                                               1 / math.sqrt(128)))


def test_decode_attention_refuses_an_unaligned_cache(gen):
    """A cache is written in place, so it cannot be copied: an unaligned one
    raises a ValueError naming it, before any launch."""
    q, nk, nv, ck, cv, lengths = _decode_case(gen, 3, 2, 8, 64)
    before = K.decode_attention.launches
    with pytest.raises(ValueError, match="cache_k"):
        K.decode_attention(q, nk, nv, _offset_view(ck), cv.clone(), lengths, 0.0884)
    with pytest.raises(ValueError, match="cache_v"):
        K.decode_attention(q, nk, nv, ck.clone(), _offset_view(cv), lengths, 0.0884)
    assert K.decode_attention.launches == before


def test_mla_decode_attention_refuses_an_unaligned_cache(gen):
    """A cache is written in place, so it cannot be copied: an unaligned one
    raises a ValueError naming it, before any launch. The other inputs are
    copied to aligned bases (the same bits as the aligned call), and the
    next call still matches the plain version."""
    B, H, r, dp, S = 3, 4, 128, 128, 64

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    ins = [rnd(B, H, r), rnd(B, H, dp), rnd(B, r), rnd(B, dp)]
    cc, cp = rnd(B, 1, S, r), rnd(B, 1, S, dp)
    lengths = torch.tensor([0, 17, S - 1], dtype=torch.int32, device="cuda")
    sm = 1 / math.sqrt(192)
    before = K.mla_decode_attention.launches
    with pytest.raises(ValueError, match="cache_c"):
        K.mla_decode_attention(*ins, _offset_view(cc), cp.clone(), lengths, sm)
    with pytest.raises(ValueError, match="cache_p"):
        K.mla_decode_attention(*ins, cc.clone(), _offset_view(cp), lengths, sm)
    assert K.mla_decode_attention.launches == before
    c1, p1, c2, p2 = cc.clone(), cp.clone(), cc.clone(), cp.clone()
    got = K.mla_decode_attention(*[_offset_view(t) for t in ins], c1, p1, lengths, sm)
    assert torch.equal(got, K.mla_decode_attention(*ins, cc.clone(), cp.clone(), lengths, sm))
    ref = K.mla_decode_attention_plain(*ins, c2, p2, lengths, sm)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().amax(dim=2)
    assert (err <= 2e-2 * ref.float().abs().amax(dim=2)).all(), err.amax()
    assert torch.equal(c1, c2) and torch.equal(p1, p2)


def test_fp8_kv_cache_saturates_on_the_card(gen):
    """The fp8 cache's explicit rule on the card: the CPU test's row."""
    from quantizers_tpu_torch.models import transformer as tt

    cache = torch.zeros((1, 1, 8, 6), dtype=torch.float8_e4m3fn, device="cuda")
    one = torch.tensor(1.0, device="cuda")
    rows = [[1.0, 300.0, 470.0, 600.0, -2000.0, 5000.0],
            [float("inf"), float("-inf"), float("nan"), 0.0, 0.0, 0.0]]
    for i, row in enumerate(rows):
        new = torch.tensor(row, device="cuda").bfloat16().reshape(1, 1, 1, 6)
        tt._store(cache, new, torch.tensor([i], dtype=torch.int32, device="cuda"), one)
    got = tt._read(cache, one, torch.float32)[0, 0].cpu()
    assert torch.equal(got[0], torch.tensor([1.0, 288.0, 448.0, 448.0, -448.0, 448.0]))
    assert got[1, :2].tolist() == [448.0, -448.0] and bool(got[1, 2].isnan())


def _stack(gen, kind, E, k, n, layout, g):
    packed = torch.randint(0, 256, (E, k // 2, n), dtype=torch.uint8, device="cuda",
                           generator=gen)
    scale = (torch.rand((E, k // g, n), device="cuda", generator=gen) * 0.02 + 0.005).bfloat16()
    if layout == "int8":
        packed, scale = nvfp4_packed_to_i8(packed), (scale.float() * 0.5).bfloat16()
    return ExpertLinears(kind=kind, weight=packed, scale=scale,
                         meta=(("k", k), ("n", n), ("group_size", g)))


def _close_rows(got, ref, rtol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().amax(dim=1)
    assert (err <= rtol * ref.abs().amax(dim=1)).all(), err


SLOT_PAYLOADS = [("w4", "packed", 32), ("nvfp4", "packed", 16), ("nvfp4", "int8", 16)]
#: (S, D, F, E, routing): chip_smoke's routings of K6's slots at path B's
#: shape (the router's top-8 of 8 tokens, every slot on one expert, 8
#: experts x 8 slots, every slot on its own expert, the router at 15 tokens:
#: S 120), and uniform draws, at path B's shape and at a small one
SLOT_CASES = [(64, 2048, 768, 128, r)
              for r in ("router", "one_expert", "eight_by_eight", "all_distinct", "random")]
SLOT_CASES += [(120, 2048, 768, 128, "router_s120"), (8, 256, 128, 4, "random")]


def _slot_case(gen, kind, layout, g, S, D, F, E, routing):
    from chip_smoke import slot_ids

    els = [_stack(gen, kind, E, D, F, layout, g), _stack(gen, kind, E, D, F, layout, g),
           _stack(gen, kind, E, F, D, layout, g)]
    x = torch.randn((S, D), device="cuda", generator=gen).bfloat16()
    return els, x, slot_ids(gen, routing, S, E)


@pytest.mark.parametrize("kind,layout,g", SLOT_PAYLOADS)
@pytest.mark.parametrize("S,D,F,E,routing", SLOT_CASES)
def test_moe_slot_ffn_matches_plain(gen, kind, layout, g, S, D, F, E, routing):
    """Each slot row within 1e-2 of its largest |value|, one launch a call,
    and the same bits on a second call: a group mixed with another's slots,
    a slot dropped from its group or a ragged 8-slot tile shows here."""
    els, x, idx = _slot_case(gen, kind, layout, g, S, D, F, E, routing)
    before = K.moe_slot_ffn.launches
    got = K.moe_slot_ffn(x, idx, *els)
    assert K.moe_slot_ffn.launches == before + 1
    _close_rows(got, K.moe_slot_ffn_plain(x, idx, *els), 1e-2)
    assert torch.equal(K.moe_slot_ffn(x, idx, *els), got)


#: groups other than the serving layouts' (w4 g 32, NVFP4 g 16): scales staged
#: a k16 step at a time (16 | g, a group over both planes of down at g 128),
#: or read a K row at a time from device memory (g 8)
@pytest.mark.parametrize("kind,layout,g", [("w4", "packed", 8), ("w4", "packed", 64),
                                           ("w4", "packed", 128), ("nvfp4", "packed", 32),
                                           ("nvfp4", "int8", 8)])
def test_moe_slot_ffn_other_groups(gen, kind, layout, g):
    els, x, idx = _slot_case(gen, kind, layout, g, 16, 256, 128, 8, "random")
    _close_rows(K.moe_slot_ffn(x, idx, *els), K.moe_slot_ffn_plain(x, idx, *els), 1e-2)


@pytest.mark.parametrize("kind,layout,g", SLOT_PAYLOADS)
def test_moe_slot_ffn_out_of_range_id_gives_a_nan_row(gen, kind, layout, g):
    """Ids out of range (E, -1) give NaN rows there; the other slots, among
    them the rest of an expert's group, are as the plain version gives them."""
    els, x, idx = _slot_case(gen, kind, layout, g, 16, 256, 128, 8, "random")
    bad = idx.clone()
    bad[3], bad[9] = 8, -1
    got = K.moe_slot_ffn(x, bad, *els)
    torch.cuda.synchronize()
    assert torch.isnan(got[[3, 9]]).all()
    ok = [i for i in range(16) if i not in (3, 9)]
    _close_rows(got[ok], K.moe_slot_ffn_plain(x[ok], idx[ok], *els), 1e-2)


def test_moe_slot_ffn_takes_an_offset_view(gen):
    """x at an unaligned base is copied to an aligned one before the launch:
    the same bits as the aligned call."""
    els, x, idx = _slot_case(gen, "nvfp4", "packed", 16, 64, 2048, 768, 128, "router")
    before = K.moe_slot_ffn.launches
    got = K.moe_slot_ffn(_offset_view(x), idx, *els)
    assert K.moe_slot_ffn.launches == before + 1
    assert torch.equal(got, K.moe_slot_ffn(x, idx, *els))


#: (B, H, KV, T, d, dv, causal): the perplexity path's shape, a single
#: ragged tile, Qwen3-30B-A3B's heads (rep 8), a non-causal call, the MLA
#: prefill's padded qk head, less than one 128-row block, a T ragged over
#: eight blocks (which the JAX package's 256-row blocks refuse: the kernel
#: is called through its C entry), and d 256 over several key tiles
FLASH_SHAPES = [(4, 32, 8, 2048, 128, 128, True), (1, 32, 8, 200, 128, 128, True),
                (2, 32, 4, 512, 128, 128, True), (1, 8, 8, 256, 128, 128, False),
                (1, 16, 16, 512, 256, 128, True), (1, 8, 8, 64, 128, 128, True),
                (1, 16, 4, 1000, 128, 128, True), (2, 16, 16, 1024, 256, 128, True)]


def _flash_against_plain(q, k, v, sm, causal):
    """The kernel (through the wrapper where the JAX package's blocks take
    the shape, else through its C entry) against the plain version, each
    (b, h, t) row within 2e-2 of its own largest |value|, and the same bits
    on a second call."""
    from chip_smoke import flash_c_entry
    from quantizers_tpu_torch.ops.flash import flash_attention, flash_attention_plain, flash_reason

    B, H, T = q.shape[:3]
    S, dv = k.shape[2], v.shape[3]
    if flash_reason(q, k, v) is None:
        before = flash_attention.launches
        got = flash_attention(q, k, v, sm, causal)
        assert flash_attention.launches == before + 1
        again = flash_attention(q, k, v, sm, causal)
        ref = flash_attention_plain(q, k, v, sm, causal)
    else:
        got = flash_c_entry(q, k, v, sm, causal)
        again = flash_c_entry(q, k, v, sm, causal)
        ref = flash_attention_plain(q, k, v, sm, causal, block_q=T, block_k=S)
    assert got.shape == (B, H, T, dv)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # each (b, h, t) row against its own largest |value|, so that the long
    # causal rows, whose values are small, are held as closely as the short
    # ones: the kernel rounds p to bf16 against a running max over 128-key
    # tiles (64 at d 256) and computes exp as exp2 of a product with log2 e,
    # the plain version over 256-key tiles with exp (each at most 2^-9 of
    # a term apart), and each side rounds its output once
    err = (got.float() - ref.float()).abs().amax(dim=3)
    assert (err <= 2e-2 * ref.float().abs().amax(dim=3)).all(), err.amax()
    assert torch.equal(again, got)
    return got, ref


@pytest.mark.parametrize("B,H,KV,T,d,dv,causal", FLASH_SHAPES)
def test_flash_attention_matches_plain(gen, B, H, KV, T, d, dv, causal):
    # q as the transformer passes it: a transpose(1, 2) view of (B, T, H, d)
    q = torch.randn((B, T, H, d), device="cuda", generator=gen).bfloat16().transpose(1, 2)
    k = torch.randn((B, KV, T, d), device="cuda", generator=gen).bfloat16()
    v = torch.randn((B, KV, T, dv), device="cuda", generator=gen).bfloat16()
    _flash_against_plain(q, k, v, 1 / math.sqrt(d), causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_more_keys_than_queries(gen, causal):
    # T 256 queries over S 512 keys (causal: query t sees keys 0..t)
    B, H, KV, T, S, d = 1, 8, 2, 256, 512, 128
    q = torch.randn((B, T, H, d), device="cuda", generator=gen).bfloat16().transpose(1, 2)
    k = torch.randn((B, KV, S, d), device="cuda", generator=gen).bfloat16()
    v = torch.randn((B, KV, S, d), device="cuda", generator=gen).bfloat16()
    _flash_against_plain(q, k, v, 1 / math.sqrt(d), causal)


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_structured(gen, T, d, causal):
    # Key s is one-hot on dim s mod d and query t one-hot on dim t mod d,
    # large enough that the softmax keeps only the matching keys (the
    # others' weights are below e^-40). v holds key s's index / T in column
    # 0 and a one on column 1 + s mod 127, so a transposed or mis-swizzled
    # fragment of q, k, p or v moves the one to another column (an error of
    # 1/2 or more against a row maximum of at most 1), and column 0 says
    # which keys were taken.
    B, H, KV, dv = 1, 2, 1, 128
    sm = 1 / math.sqrt(d)
    idx = torch.arange(T, device="cuda")
    q = torch.zeros((B, T, H, d), device="cuda")
    q[:, idx, :, idx % d] = 40 / sm
    k = torch.zeros((B, KV, T, d), device="cuda")
    k[:, :, idx, idx % d] = 1.0
    v = torch.zeros((B, KV, T, dv), device="cuda")
    v[:, :, idx, 0] = idx.float() / T
    v[:, :, idx, 1 + idx % (dv - 1)] = 1.0
    _, ref = _flash_against_plain(q.bfloat16().transpose(1, 2), k.bfloat16(), v.bfloat16(),
                                   sm, causal)
    # and the plain version picks the matching keys: query t's weight lies
    # on column 1 + t mod 127 (and on the other matching key's column)
    rows = ref.float()[0, 0, idx, 1 + idx % (dv - 1)]
    assert (rows >= 0.49).all(), rows.amin()


def test_flash_attention_refuses_other_head_dims(gen):
    from quantizers_tpu_torch.ops.flash import flash_attention

    q = torch.zeros((1, 2, 64, 384), dtype=torch.bfloat16, device="cuda")
    before = flash_attention.launches
    with pytest.raises(K.KernelUnsupported, match="built for"):
        flash_attention(q, q, q[..., :128], 0.05)
    assert flash_attention.launches == before


def _w8pc_case(gen, S, D, F, E, routing, scale_dtype=torch.float32):
    """K7's inputs: the fused w8pc stacks (codes over -128..127, -128
    among them), x and the slot ids under one of chip_smoke's routings."""
    from chip_smoke import slot_ids, w8pc_stacks

    gu, down = w8pc_stacks(gen, E, D, F, scale_dtype)
    assert all((el.weight == -128).any() for el in (gu, down))
    x = torch.randn((S, D), device="cuda", generator=gen).bfloat16()
    return (gu, down), x, slot_ids(gen, routing, S, E)


def _gu_against_plain(els, x, idx, rtol=1e-2):
    """One launch a call, each slot row within rtol of its largest |value|,
    the same bits on a second call; returns the kernel's and the plain
    version's outputs."""
    before = K.moe_slot_gu_ffn.launches
    got = K.moe_slot_gu_ffn(x, idx, *els)
    assert K.moe_slot_gu_ffn.launches == before + 1
    ref = K.moe_slot_gu_ffn_plain(x, idx, *els)
    _close_rows(got, ref, rtol)
    assert torch.equal(K.moe_slot_gu_ffn(x, idx, *els), got)
    return got, ref


@pytest.mark.parametrize("S,D,F,E,routing", SLOT_CASES)
def test_moe_slot_gu_ffn_matches_plain(gen, S, D, F, E, routing):
    """K7 under K6's routings: a group mixed with another's slots, a slot
    dropped from its group or a ragged 8-slot pass shows here."""
    _gu_against_plain(*_w8pc_case(gen, S, D, F, E, routing))


def _one_hot_rows(gen, S, D):
    """x whose slot s is the unit row at its own K row k_s (distinct)."""
    ks = torch.randperm(D, device="cuda", generator=gen)[:S]
    x = torch.zeros((S, D), dtype=torch.bfloat16, device="cuda")
    x[torch.arange(S, device="cuda"), ks] = 1.0
    return x


@pytest.mark.parametrize("routing", ["router", "one_expert"])
def test_moe_slot_gu_ffn_one_hot_readout(gen, routing):
    """Each slot's x is one-hot, so every gate and up sum is one exact
    product c * 1 and its f32 scale multiplies it once, as in the plain
    version: only silu, the rounding of a and the order of the down sums
    can differ, so each row is held ten times tighter (1e-3). A swapped gate
    or up half or a misplaced column shows here; a scale applied to the
    weights, in the read-out of a below."""
    els, _, idx = _w8pc_case(gen, 64, 2048, 768, 128, routing)
    _gu_against_plain(els, _one_hot_rows(gen, 64, 2048), idx, rtol=1e-3)


def test_moe_slot_gu_ffn_reads_out_a(gen):
    """One-hot x and a down stack that copies a out (code 1 on its diagonal,
    scale 1): y[:, :F] is a itself, bf16(silu(c_g s_g) * (c_u s_u)), and
    must equal the plain version's bit for bit except where silu's last f32
    bit rounds a the other way (at most 1 in 1,000, by one bf16 step). Codes
    multiplied by their scale in bf16 before the sum would move a in most
    places."""
    (gu, down), _, idx = _w8pc_case(gen, 64, 2048, 768, 128, "router")
    E, F, D = down.weight.shape
    eye = torch.zeros((F, D), dtype=torch.int8, device="cuda")
    eye[torch.arange(F), torch.arange(F)] = 1
    down = ExpertLinears(kind="w8", weight=eye.expand(E, F, D).contiguous(),
                         scale=torch.ones((E, 1, D), device="cuda"), meta=down.meta)
    got, ref = _gu_against_plain((gu, down), _one_hot_rows(gen, 64, 2048), idx)
    assert torch.equal(got[:, F:], torch.zeros_like(got[:, F:]))
    a, a_ref = got[:, :F], ref[:, :F]
    differ = a != a_ref
    assert differ.sum().item() <= max(2, a.numel() // 1000), differ.sum().item()
    assert ((a - a_ref).abs() <= 2 ** -7 * a_ref.abs()).all()
    assert (a_ref != 0).float().mean().item() > 0.9


def test_moe_slot_gu_ffn_widens_bf16_scales(gen):
    _gu_against_plain(*_w8pc_case(gen, 64, 2048, 768, 128, "router", torch.bfloat16))


def test_moe_slot_gu_ffn_out_of_range_id_gives_a_nan_row(gen):
    """Ids out of range (E, -1) give NaN rows there; the other slots, among
    them the rest of an expert's group, are as the plain version gives them."""
    els, x, idx = _w8pc_case(gen, 16, 256, 128, 8, "random")
    bad = idx.clone()
    bad[3], bad[9] = 8, -1
    got = K.moe_slot_gu_ffn(x, bad, *els)
    torch.cuda.synchronize()
    assert torch.isnan(got[[3, 9]]).all()
    ok = [i for i in range(16) if i not in (3, 9)]
    _close_rows(got[ok], K.moe_slot_gu_ffn_plain(x[ok], idx[ok], *els), 1e-2)


def test_moe_slot_gu_ffn_takes_an_offset_view(gen):
    """x at an unaligned base is copied to an aligned one before the launch:
    the same bits as the aligned call."""
    els, x, idx = _w8pc_case(gen, 64, 2048, 768, 128, "router")
    before = K.moe_slot_gu_ffn.launches
    got = K.moe_slot_gu_ffn(_offset_view(x), idx, *els)
    assert K.moe_slot_gu_ffn.launches == before + 1
    assert torch.equal(got, K.moe_slot_gu_ffn(x, idx, *els))


#: (m, k, n): the four FP8_BLOCK MLA decode calls (q_proj, o_proj, the fused
#: gate|up, down_proj), the batcher's row prefill width, small ragged m, the
#: kernel's row-group edges (m 16, 32, 64, 65: 8-row groups of 2, 4, 8 and
#: two 64-row tiles) and the no-cache window's m 512, one column tile
#: (n 128), fewer stages than a full cluster split (k 128, 384), and
#: kv_b_proj (k 512, n 4096), which the no-cache window reaches
FP8_SHAPES = [(8, 2048, 3072), (8, 2048, 2048), (8, 2048, 16384), (8, 8192, 2048),
              (128, 2048, 16384), (3, 384, 256), (130, 256, 384), (16, 1024, 256),
              (32, 768, 384), (64, 512, 384), (65, 2048, 128), (512, 2048, 3072),
              (8, 128, 512), (9, 384, 256), (8, 512, 4096)]


@pytest.mark.parametrize("m,k,n", FP8_SHAPES)
def test_fp8_kernel_matches_plain(gen, m, k, n):
    w = (torch.randn((k, n), device="cuda", generator=gen) * 100).clamp(-448, 448)
    lin = QuantLinear(kind="fp8", weight=w.to(torch.float8_e4m3fn),
                      scale=torch.rand((k // 128, n // 128), device="cuda", generator=gen) * 1e-4,
                      meta=(("k", k), ("n", n), ("strategy", "block"), ("block_k", 128),
                            ("block_n", 128)))
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = K.fp8_matmul.launches
    got = K.fp8_matmul(x, lin)
    assert K.fp8_matmul.launches == before + 1
    _close(got, K.fp8_matmul_plain(x, lin.weight, lin.scale), 1e-2)
    assert torch.equal(K.fp8_matmul(x, lin), got)


def test_fp8_kernel_reads_out_every_weight_exactly(gen):
    """One-hot rows of x read the dequantized weights out through the
    kernel: every non-NaN E4M3 code (254 of 256; 0x7F and 0xFF are NaN)
    times f32 block scales from 2^-20 up to the largest at which 448 x
    scale stays finite in bf16. The output must equal the plain version's
    bit for bit (a single product each, so no sum order enters), which pins
    the fragment mapping, the swizzle, the scale of each stage and the
    decode's two roundings (f32 product, then bf16)."""
    m, k, n = 8, 512, 256
    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8)
    w8 = codes[torch.arange(k * n).reshape(k, n) % len(codes)].view(torch.float8_e4m3fn).cuda()
    # 448 x s rounds to bf16 inf from (2 - 2^-8) 2^127 up: the top scale is
    # the largest f32 below (2 - 2^-8) 2^127 / 448 = 1.140625 x 2^119
    top = np.nextafter(np.float32(1.140625 * 2.0 ** 119), np.float32(0))
    rng = np.random.default_rng(7)
    mant = rng.uniform(1, 2, (k // 128, n // 128)).astype(np.float32)
    expo = np.array([[-20, -9], [-1, 30], [77, 100], [118, 0]])
    s = (mant * np.exp2(expo.astype(np.float32))).astype(np.float32)
    s[3, 1] = top
    scale = torch.from_numpy(s).cuda()
    lin = QuantLinear(kind="fp8", weight=w8, scale=scale,
                      meta=(("k", k), ("n", n), ("strategy", "block"), ("block_k", 128),
                            ("block_n", 128)))
    up = scale.repeat_interleave(128, dim=0).repeat_interleave(128, dim=1)
    wq = (w8.float() * up).bfloat16()
    assert torch.isfinite(wq.float()).all() and float(wq.float().abs().max()) > 2.0 ** 127
    rows = torch.arange(m, device="cuda")
    for r0 in range(0, k, m):
        x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
        x[rows, r0 + rows] = 1
        got = K.fp8_matmul(x, lin)
        ref = K.fp8_matmul_plain(x, w8, scale)
        assert torch.equal(ref, wq[r0:r0 + m])
        assert torch.equal(got, ref), (r0, (got != ref).nonzero()[:4].tolist())


#: (B, H, r, dp, S, fills): path E's shape and a narrow one with random
#: fills (row 0 empty, row 1 full); H 20 (a full and a padded tile of 16
#: heads); H 128 (8 tiles); the widest latent and rope at the most slots,
#: a row at L 8191; one batch of mixed fills: empty, the first chunk's
#: last position, the second's first, the ends and starts of shares of an
#: 8-rank split (L 31, 32: shares of 16; 127, 128: 16 and 32), full
MLA_CASES = [
    pytest.param(8, 16, 512, 128, 512, None, id="8-16-512-128-512"),
    pytest.param(3, 4, 128, 256, 64, None, id="3-4-128-256-64"),
    pytest.param(4, 20, 512, 128, 512, None, id="4-20-512-128-512"),
    pytest.param(2, 128, 512, 128, 512, None, id="2-128-512-128-512"),
    pytest.param(2, 16, 1024, 256, 8192, None, id="2-16-1024-256-8192"),
    pytest.param(8, 16, 512, 128, 512, (0, 15, 16, 31, 32, 127, 128, 511), id="mixed-fills"),
]


@pytest.mark.parametrize("B,H,r,dp,S,fills", MLA_CASES)
def test_mla_decode_attention_matches_plain(gen, B, H, r, dp, S, fills):
    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    qa, qp, nc, npe = rnd(B, H, r), rnd(B, H, dp), rnd(B, r), rnd(B, dp)
    cc, cp = rnd(B, 1, S, r), rnd(B, 1, S, dp)
    if fills is None:
        lengths = torch.randint(0, S + 8, (B,), dtype=torch.int32, device="cuda", generator=gen)
        lengths[0], lengths[1] = 0, S - 1
    else:
        lengths = torch.tensor(fills, dtype=torch.int32, device="cuda")
    # stale rows past each length hold NaN: they must never reach a product
    L = lengths.long().clamp(max=S - 1)
    stale = torch.arange(S, device="cuda")[None, :] > L[:, None]
    cc[stale[:, None, :, None].expand_as(cc)] = float("nan")
    cp[stale[:, None, :, None].expand_as(cp)] = float("nan")
    c1, p1, c2, p2 = cc.clone(), cp.clone(), cc.clone(), cp.clone()
    sm = 1 / math.sqrt(192)
    before = K.mla_decode_attention.launches
    got = K.mla_decode_attention(qa, qp, nc, npe, c1, p1, lengths, sm)
    assert K.mla_decode_attention.launches == before + 1
    ref = K.mla_decode_attention_plain(qa, qp, nc, npe, c2, p2, lengths, sm)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().amax(dim=2)
    assert (err <= 2e-2 * ref.float().abs().amax(dim=2)).all(), err.amax()
    same = lambda a, b: torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))  # noqa: E731
    assert same(c1, c2) and same(p1, p2)
    rows = torch.arange(B, device="cuda")
    assert torch.equal(c1[rows, 0, L], nc) and torch.equal(p1[rows, 0, L], npe)
    c3, p3 = cc.clone(), cp.clone()
    assert torch.equal(K.mla_decode_attention(qa, qp, nc, npe, c3, p3, lengths, sm), got)


def test_mla_decode_attention_one_hot_readout(gen):
    """p exactly one-hot reads out one latent row bit for bit. The first S
    columns of every valid latent row (and of new_c) are one-hot, row s at
    column s, the rest random; q_abs[b, h] = 4096 e_j, q_pe = 0: position
    j scores 4096 * sm_scale (about 296) and every other 0, so exp gives
    exactly 0 off j in f32 and ctx_lat[b, h] = C[j] (new_c at j = L). The
    heads take j at the first and last position of every 16-row chunk
    (every rank's share starts and ends at one, whatever the split) and at
    L; stale rows hold NaN."""
    B, H, r, dp, S = 4, 16, 512, 128, 256
    fills = (S - 1, S - 1, 100, 0)
    picks = []
    for L in fills:
        ends = sorted({p for k in range(0, L + 1, 16) for p in (k, min(k + 15, L))} | {L})
        picks.append(ends)
    # rows 0 and 1 share the 32 ends of L 255's chunks; row 2 pads with L
    picks = [picks[0][:16], picks[0][16:], (picks[2] + [100] * 16)[:16], [0] * 16]
    assert all(len(js) == H for js in picks) and 255 in picks[1]
    lengths = torch.tensor(fills, dtype=torch.int32, device="cuda")
    eye = torch.eye(S, device="cuda").bfloat16()
    cc = torch.randn((B, 1, S, r), device="cuda", generator=gen).bfloat16()
    cc[:, 0, :, :S] = eye
    cp = torch.randn((B, 1, S, dp), device="cuda", generator=gen).bfloat16()
    nc = torch.randn((B, r), device="cuda", generator=gen).bfloat16()
    nc[:, :S] = eye[lengths.long()]
    npe = torch.randn((B, dp), device="cuda", generator=gen).bfloat16()
    stale = (torch.arange(S, device="cuda")[None, :] > lengths[:, None])[:, None, :, None]
    cc, cp = cc.masked_fill(stale, float("nan")), cp.masked_fill(stale, float("nan"))
    j = torch.tensor(picks, device="cuda")
    qa = torch.zeros((B, H, r), dtype=torch.bfloat16, device="cuda")
    qa.scatter_(2, j[:, :, None], 4096.0)
    qp = torch.zeros((B, H, dp), dtype=torch.bfloat16, device="cuda")
    sm = 1 / math.sqrt(192)
    got = K.mla_decode_attention(qa, qp, nc, npe, cc.clone(), cp.clone(), lengths, sm)
    ref = K.mla_decode_attention_plain(qa, qp, nc, npe, cc.clone(), cp.clone(), lengths, sm)
    rows = torch.arange(B, device="cuda")[:, None]
    want = torch.where((j == lengths[:, None].long())[:, :, None], nc[:, None, :],
                       cc[rows, 0, j])
    torch.cuda.synchronize()
    assert torch.equal(ref, want)
    assert torch.equal(got, want), (got != want).nonzero()[:4].tolist()


@pytest.mark.parametrize("bits,strategy,group", [(4, "group", 32), (8, "channel", None),
                                                 (8, "block", None)])
def test_quantize_on_the_card_equals_the_cpu(gen, bits, strategy, group):
    """The scale solvers divide by tensors: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which moves scales (and
    then codes) by an ulp against the CPU and the JAX package."""
    from quantizers_tpu_torch.core import numerics as tn
    from quantizers_tpu_torch.core import scheme as ts

    kind = ts.QuantType.FLOAT if strategy == "block" else ts.QuantType.INT
    args = ts.QuantizationArgs(num_bits=bits, type=kind, strategy=ts.QuantStrategy(strategy),
                               group_size=group,
                               block_structure=(128, 128) if strategy == "block" else None)
    w = (torch.randn((512, 1024), device="cuda", generator=gen) * 0.02).bfloat16().float()
    card, cpu = tn.quantize(w, args), tn.quantize(w.cpu(), args)
    assert torch.equal(card.scale.cpu(), cpu.scale)
    assert torch.equal(card.values.cpu(), cpu.values)
