"""Port parity for the W4A16 matmul: the w4 kernel's plain version (the
reference of the card tests in tests/test_torch_cuda.py) against the JAX
package's Pallas kernel in interpret mode, at the card tests' small shapes,
and the plain version's one-hot readout, which the card's one-hot test
holds the kernel to bit for bit.

Neither side rounds a weight: the JAX kernel dots the codes c with x and
takes 8 s times the group sums of x off (each group's f32 partial times its
f32 scale), the plain version multiplies x by (c - 8) s in f32. Both sum in
f32 in another order and round the output to bf16 once: each output row
within 1e-2 of its largest |value|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu.ops import kernels as JK
from quantizers_tpu.ops import linear as jl
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.ops import linear as tl
from test_torch_cuda import W4_SMALL, w4_one_hot_case


@pytest.mark.parametrize("m,k,n,g", W4_SMALL)
def test_w4_plain_matches_pallas_at_card_shapes(m, k, n, g):
    """Ragged M from 1 to 512 and groups 8, 16, 24, 32, 48, 64 and 128 (both
    kernel bodies on the card)."""
    rng = np.random.default_rng(m * k + g)
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    scale = torch.from_numpy(rng.random((k // g, n), dtype=np.float32) * 0.01 + 0.001).bfloat16()
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    meta = (("k", k), ("n", n), ("group_size", g))
    tlin = tl.QuantLinear(kind="w4", weight=torch.from_numpy(packed), scale=scale, meta=meta)
    jlin = jl.QuantLinear(kind="w4", weight=jnp.asarray(packed),
                          scale=jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16), meta=meta)
    assert TK._w4_reason(tlin) is None
    want = np.asarray(JK.w4_matmul(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jlin,
                                   interpret=True), np.float32)
    got = TK.w4_matmul_plain(x, tlin.weight, tlin.scale, g).float().numpy()
    assert got.shape == want.shape == (m, n)
    err = np.abs(got - want).max(axis=1)
    assert (err <= 1e-2 * np.abs(want).max(axis=1)).all(), err.max()


@pytest.mark.parametrize("g,k", [(32, 512), (16, 512), (48, 768), (8, 256)])
def test_w4_plain_reads_out_every_weight_exactly(g, k):
    """The identity as x reads the weights out through the plain version:
    bf16((c - 8) s) for every code in both nibbles and scales from bf16
    subnormals to the largest s with 8 s finite, the card test's
    expectation (test_w4_kernel_reads_out_every_weight_exactly)."""
    n = 256
    packed, scale, wq = w4_one_hot_case(k, n, g, seed=g)
    x = torch.eye(k, dtype=torch.bfloat16)
    got = TK.w4_matmul_plain(x, packed, scale, g)
    codes = torch.cat([(packed & 0xF), (packed >> 4)]).float() - 8  # the two planes
    want = (codes * scale.float().repeat_interleave(g, dim=0)).bfloat16()
    assert torch.equal(wq, want)
    assert torch.equal(got, want), (got != want).nonzero()[:4].tolist()
    # subnormal products and the largest ones are among them
    assert (want[:g].float().abs().min() == 0) and want.float().abs().max() > 2.0 ** 127
