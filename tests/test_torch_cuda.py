"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA card is present. On a machine
with one (and without JAX, which the repository's conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: for the matmuls 1e-2 of the plain output's
largest |value| (bf16 outputs, f32 sums in another order); for decode
attention 2e-2 of each (row, KV head)'s own largest |value| (f32 against
bf16-rounded probabilities), so that long rows, whose values are small,
are held as closely as short ones. The matmul kernels sum in a fixed order,
so a second call gives the same bits.
"""

import math

import pytest
import torch

from quantizers_tpu_torch.ops import kernels as K
from quantizers_tpu_torch.ops.linear import QuantLinear

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


@pytest.mark.parametrize("m,k,n,g", [(8, 2560, 152064, None), (5, 512, 256, 32),
                                     (64, 2560, 1024, None)])
def test_w8_kernel_matches_plain(gen, m, k, n, g):
    rows = k // g if g else 1
    lin = QuantLinear(
        kind="w8",
        weight=torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen),
        scale=(torch.rand((rows, n), device="cuda", generator=gen) * 0.01).bfloat16(),
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
