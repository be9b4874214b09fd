"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA card is present. On a machine
with one (and without JAX, which the repository's conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: for the matmuls 1e-2 of the plain output's
largest |value| (bf16 outputs, f32 sums in another order); for decode
attention 2e-2 of each (row, KV head)'s own largest |value| (f32 against
bf16-rounded probabilities), so that long rows, whose values are small,
are held as closely as short ones; for the slot FFNs 1e-2 of each slot
row's largest |value| (f32 outputs; a, rounded to bf16 on both sides, may
round the other way after sums in another order); for flash attention 2e-2
of each (b, h, t) row's largest |value| (p rounded to bf16 against a running
max over 64-key tiles in the kernel, 256-key tiles in the plain version).
The matmul, slot and flash kernels sum in a fixed order, so a second call
gives the same bits.
"""

import math

import pytest
import torch

from quantizers_tpu_torch.models.moe import ExpertLinears
from quantizers_tpu_torch.ops import kernels as K
from quantizers_tpu_torch.ops.linear import QuantLinear, nvfp4_packed_to_i8

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


@pytest.mark.parametrize("m,k,n,g", [(8, 2560, 6144, 32), (3, 1024, 384, 64),
                                     (40, 1024, 256, 32), (128, 9728, 2560, 32),
                                     (5, 768, 128, 48), (9, 2048, 256, 128)])
def test_w4_kernel_matches_plain(gen, m, k, n, g):
    lin = QuantLinear(
        kind="w4",
        weight=torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, device="cuda", generator=gen),
        scale=(torch.rand((k // g, n), device="cuda", generator=gen) * 0.01).bfloat16(),
        meta=(("k", k), ("n", n), ("group_size", g)))
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = K.w4_matmul.launches
    got = K.w4_matmul(x, lin)
    assert K.w4_matmul.launches == before + 1
    _close(got, K.w4_matmul_plain(x, lin.weight, lin.scale, g), 1e-2)
    assert torch.equal(K.w4_matmul(x, lin), got)


@pytest.mark.parametrize("m,k,n,g,sdt", [(8, 2560, 152064, None, torch.bfloat16),
                                         (5, 512, 256, 32, torch.bfloat16),
                                         (64, 2560, 1024, None, torch.bfloat16),
                                         (128, 2048, 1536, None, torch.float32),
                                         (128, 768, 2048, None, torch.float32),
                                         (3, 512, 256, 32, torch.float32)])
def test_w8_kernel_matches_plain(gen, m, k, n, g, sdt):
    rows = k // g if g else 1
    lin = QuantLinear(
        kind="w8",
        weight=torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen),
        scale=(torch.rand((rows, n), device="cuda", generator=gen) * 0.01).to(sdt),
        meta=(("k", k), ("n", n), ("group_size", g)))
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    got = K.w8_matmul(x, lin)
    _close(got, K.w8_matmul_plain(x, lin.weight, lin.scale, g), 1e-2)
    assert torch.equal(K.w8_matmul(x, lin), got)


@pytest.mark.parametrize("B,KV,rep,S", [(8, 8, 4, 512), (3, 2, 8, 64)])
def test_decode_attention_matches_plain(gen, B, KV, rep, S):
    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    q, nk, nv, ck, cv = rnd(B, KV, rep, 128), rnd(B, KV, 128), rnd(B, KV, 128), \
        rnd(B, KV, S, 128), rnd(B, KV, S, 128)
    lengths = torch.randint(0, S + 8, (B,), dtype=torch.int32, device="cuda", generator=gen)
    lengths[0] = 0
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got = K.decode_attention(q, nk, nv, k1, v1, lengths, 1 / math.sqrt(128))
    ref = K.decode_attention_plain(q, nk, nv, k2, v2, lengths, 1 / math.sqrt(128))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # each (row, KV head) against its own largest |value|
    err = (got.float() - ref.float()).abs().amax(dim=(2, 3))
    assert (err <= 2e-2 * ref.float().abs().amax(dim=(2, 3))).all(), err
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


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


@pytest.mark.parametrize("kind,layout,g", [("w4", "packed", 32), ("nvfp4", "packed", 16),
                                           ("nvfp4", "int8", 16)])
@pytest.mark.parametrize("S,D,F,E", [(64, 2048, 768, 128), (8, 256, 128, 4)])
def test_moe_slot_ffn_matches_plain(gen, kind, layout, g, S, D, F, E):
    els = [_stack(gen, kind, E, D, F, layout, g), _stack(gen, kind, E, D, F, layout, g),
           _stack(gen, kind, E, F, D, layout, g)]
    x = torch.randn((S, D), device="cuda", generator=gen).bfloat16()
    idx = torch.randint(0, E, (S,), device="cuda", generator=gen, dtype=torch.int32)
    before = K.moe_slot_ffn.launches
    got = K.moe_slot_ffn(x, idx, *els)
    assert K.moe_slot_ffn.launches == before + 1
    _close_rows(got, K.moe_slot_ffn_plain(x, idx, *els), 1e-2)
    assert torch.equal(K.moe_slot_ffn(x, idx, *els), got)


#: (B, H, KV, T, d, dv, causal): the perplexity path's shape, a single
#: ragged tile, Qwen3-30B-A3B's heads (rep 8), a non-causal call, and the
#: MLA prefill's padded qk head
FLASH_SHAPES = [(4, 32, 8, 2048, 128, 128, True), (1, 32, 8, 200, 128, 128, True),
                (2, 32, 4, 512, 128, 128, True), (1, 8, 8, 256, 128, 128, False),
                (1, 16, 16, 512, 256, 128, True)]


@pytest.mark.parametrize("B,H,KV,T,d,dv,causal", FLASH_SHAPES)
def test_flash_attention_matches_plain(gen, B, H, KV, T, d, dv, causal):
    from quantizers_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    # q as the transformer passes it: a transpose(1, 2) view of (B, T, H, d)
    q = torch.randn((B, T, H, d), device="cuda", generator=gen).bfloat16().transpose(1, 2)
    k = torch.randn((B, KV, T, d), device="cuda", generator=gen).bfloat16()
    v = torch.randn((B, KV, T, dv), device="cuda", generator=gen).bfloat16()
    sm = 1 / math.sqrt(d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, sm, causal)
    assert flash_attention.launches == before + 1 and got.shape == (B, H, T, dv)
    ref = flash_attention_plain(q, k, v, sm, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # each (b, h, t) row against its own largest |value|, so that the long
    # causal rows, whose values are small, are held as closely as the short
    # ones: the kernel rounds p to bf16 against a running max over 64-key
    # tiles, the plain version over 256-key tiles (at most 2^-9 of each term
    # apart), and each side rounds its output once
    err = (got.float() - ref.float()).abs().amax(dim=3)
    assert (err <= 2e-2 * ref.float().abs().amax(dim=3)).all(), err.amax()
    assert torch.equal(flash_attention(q, k, v, sm, causal), got)


def test_flash_attention_refuses_other_head_dims(gen):
    from quantizers_tpu_torch.ops.flash import flash_attention

    q = torch.zeros((1, 2, 64, 384), dtype=torch.bfloat16, device="cuda")
    before = flash_attention.launches
    with pytest.raises(K.KernelUnsupported, match="built for"):
        flash_attention(q, q, q[..., :128], 0.05)
    assert flash_attention.launches == before


@pytest.mark.parametrize("S,D,F,E", [(64, 2048, 768, 128), (8, 256, 128, 4)])
def test_moe_slot_gu_ffn_matches_plain(gen, S, D, F, E):
    def w8(k, n):
        return ExpertLinears(
            kind="w8", weight=torch.randint(-127, 128, (E, k, n), dtype=torch.int8, device="cuda",
                                            generator=gen),
            scale=torch.rand((E, 1, n), device="cuda", generator=gen) * 0.002 + 1e-4,
            meta=(("k", k), ("n", n), ("group_size", None)))
    gu, down = w8(D, 2 * F), w8(F, D)
    x = torch.randn((S, D), device="cuda", generator=gen).bfloat16()
    idx = torch.randint(0, E, (S,), device="cuda", generator=gen, dtype=torch.int32)
    before = K.moe_slot_gu_ffn.launches
    got = K.moe_slot_gu_ffn(x, idx, gu, down)
    assert K.moe_slot_gu_ffn.launches == before + 1
    _close_rows(got, K.moe_slot_gu_ffn_plain(x, idx, gu, down), 1e-2)
    assert torch.equal(K.moe_slot_gu_ffn(x, idx, gu, down), got)
