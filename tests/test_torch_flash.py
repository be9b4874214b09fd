"""Port parity for kernel K4: the flash attention wrapper (its plain
PyTorch version on CPU tensors) against the JAX package's Pallas
``flash_attention`` in interpret mode, and the routing conditions.

Tolerance: 2^-7 (one bf16 ulp at 1) of each (b, h, t) row's largest
|value|. Both sides run the same recurrence over the same key blocks and
round p and the output to bf16 at the same points; their f32 sums run in
another order, which may move an output across a bf16 rounding boundary
(measured: at most one ulp, at about 0.1% of the outputs). One ulp of an
output is at most 2^-7 of its own |value|, so each row is held to its
own scale: the long causal rows, whose values are small, as closely as
the short ones.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu.ops.flash import flash_attention as jflash
from quantizers_tpu.ops.kernels import KernelUnsupported as JKU
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.ops.flash import flash_attention, flash_attention_plain, flash_reason

RTOL = 2.0 ** -7


def _inputs(B, H, KV, T, d, dv, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, T, d), (B, KV, T, d), (B, KV, T, dv))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    tx = [torch.as_tensor(np.asarray(a, np.float32)).bfloat16() for a in jx]
    return jx, tx


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max(axis=3)
    assert (err <= RTOL * np.abs(want).max(axis=3)).all(), err.max()


# (B, H, KV, T, d, dv, causal, block): rep 1/2/4; 64-row blocks over T 256
# (several key blocks per query block, the ones above the diagonal skipped
# by the JAX kernel); one ragged 200-row block; the MLA head (d 256, dv 128)
CASES = [
    (1, 2, 2, 256, 128, 128, True, 64),
    (1, 4, 2, 256, 128, 128, True, 64),
    (2, 4, 1, 256, 128, 128, True, 64),
    (1, 4, 2, 256, 128, 128, False, 64),
    (1, 4, 4, 200, 128, 128, True, 256),
    (1, 4, 2, 128, 256, 128, True, 64),
    (1, 4, 1, 128, 256, 128, False, 256),
]


@pytest.mark.parametrize("B,H,KV,T,d,dv,causal,block", CASES)
def test_plain_matches_jax_interpret(B, H, KV, T, d, dv, causal, block):
    (qj, kj, vj), (q, k, v) = _inputs(B, H, KV, T, d, dv, seed=T + H + d)
    sm = 1.0 / math.sqrt(d)
    want = jflash(qj, kj, vj, sm, causal=causal, block_q=block, block_k=block, interpret=True)
    got = flash_attention_plain(q, k, v, sm, causal, block_q=block, block_k=block)
    assert got.shape == (B, H, T, dv) and got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("drop", ["key 0 tile, rows >= 1984", "the diagonal key, rows >= 1024"])
def test_card_limit_holds_each_row(drop):
    # The card's check of K4 (tests/test_torch_cuda.py, chip_smoke.py) holds
    # each (b, h, t) row to 2e-2 of its own largest |value|. An attention
    # that drops keys from late causal rows only, whose values are small,
    # stays within 2e-2 of the whole (b, h) slice's largest |value| (set by
    # the first rows), and fails the per-row limit
    (_, (q, k, v)) = _inputs(1, 2, 1, 2048, 128, 128, seed=11)
    sm = 1.0 / math.sqrt(128)
    ref = flash_attention_plain(q, k, v, sm).float()
    rows, cols = torch.arange(2048)[:, None], torch.arange(2048)[None, :]
    lost = (cols < 64) & (rows >= 1984) if drop.startswith("key 0") else \
        (cols == rows) & (rows >= 1024)
    s = torch.einsum("bhtd,bsd->bhts", q.float(), k[:, 0].float()) * sm
    p = torch.softmax(s.masked_fill((cols > rows) | lost, -1e30), dim=-1)
    bad = torch.einsum("bhts,bsd->bhtd", p, v[:, 0].float()).bfloat16().float()
    err = (bad - ref).abs()
    assert (err.amax(dim=(2, 3)) <= 2e-2 * ref.abs().amax(dim=(2, 3))).all()
    assert not (err.amax(dim=3) <= 2e-2 * ref.abs().amax(dim=3)).all()


@pytest.mark.parametrize("B,H,KV,T,d,dv,causal", [(1, 4, 2, 256, 128, 128, True),
                                                  (1, 4, 4, 200, 128, 128, False)])
def test_cpu_wrapper_is_the_plain_version(B, H, KV, T, d, dv, causal):
    (qj, kj, vj), (q, k, v) = _inputs(B, H, KV, T, d, dv, seed=3)
    sm = 1.0 / math.sqrt(d)
    before = TK.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, sm, causal)
    assert TK.launch_counts()["flash_attention"] == before  # no kernel launch on the CPU
    assert torch.equal(got, flash_attention_plain(q, k, v, sm, causal))
    _close(got, jflash(qj, kj, vj, sm, causal=causal, interpret=True))


# (q shape, k shape, v shape): each refused by the JAX package, or taken
REASON_CASES = [
    ((1, 2, 6, 128), (1, 2, 6, 128), (1, 2, 6, 128)),        # T 6: 8 does not divide bq
    ((1, 2, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64)),           # d 64
    ((1, 2, 16, 128), (1, 2, 16, 128), (1, 2, 16, 64)),      # dv 64
    ((1, 3, 16, 128), (1, 2, 16, 128), (1, 2, 16, 128)),     # H % KV
    ((1, 2, 300, 128), (1, 2, 300, 128), (1, 2, 300, 128)),  # T 300: bq 256 does not divide T
    ((1, 2, 200, 128), (1, 2, 200, 128), (1, 2, 200, 128)),  # taken: bq = T = 200
    ((1, 4, 512, 256), (1, 2, 512, 256), (1, 2, 512, 128)),  # taken: the MLA head
]


@pytest.mark.parametrize("qs,ks,vs", REASON_CASES)
def test_flash_reason_matches_jax(qs, ks, vs):
    zeros = [jnp.zeros(s, jnp.bfloat16) for s in (qs, ks, vs)]
    try:
        jflash(*zeros, 0.1, interpret=True)
        jax_refuses = False
    except JKU:
        jax_refuses = True
    tz = [torch.zeros(s, dtype=torch.bfloat16) for s in (qs, ks, vs)]
    reason = flash_reason(*tz)
    assert (reason is not None) == jax_refuses, reason
    if jax_refuses:
        with pytest.raises(TK.KernelUnsupported):
            flash_attention(*tz, 0.1)
        with pytest.raises(TK.KernelUnsupported):
            flash_attention_plain(*tz, 0.1)


@pytest.mark.parametrize("T,block", [(200, 64), (256, 48), (256, 64)])
def test_plain_refuses_what_jax_refuses_at_its_blocks(T, block):
    # block_q and block_k enter only the shape conditions: bq = min(block, T)
    # must divide T and be a multiple of 8
    zeros = [jnp.zeros((1, 2, T, 128), jnp.bfloat16) for _ in range(3)]
    try:
        jflash(*zeros, 0.1, block_q=block, block_k=block, interpret=True)
        jax_refuses = False
    except JKU:
        jax_refuses = True
    tz = torch.zeros((1, 2, T, 128), dtype=torch.bfloat16)
    assert (flash_reason(tz, tz, tz, block, block) is not None) == jax_refuses
    if jax_refuses:
        with pytest.raises(TK.KernelUnsupported):
            flash_attention_plain(tz, tz, tz, 0.1, block_q=block, block_k=block)
    else:
        assert flash_attention_plain(tz, tz, tz, 0.1, block_q=block, block_k=block).shape == tz.shape


def test_kernel_view_copies_expanded_views():
    # The card kernel reads q, k and v through TMA, which takes no stride of
    # 0: an expanded view is copied, an aligned strided view is kept as it is
    from quantizers_tpu_torch.ops.flash import _kernel_view

    k = torch.zeros((2, 1, 64, 128), dtype=torch.bfloat16).expand(2, 4, 64, 128)
    got = _kernel_view(k)
    assert got.is_contiguous() and torch.equal(got, k)
    q = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16).transpose(1, 2)
    assert _kernel_view(q) is q


def test_kernel_view_copies_an_unaligned_base():
    # TMA needs a 16-byte aligned base: a contiguous view at element offset
    # 3 of a flat buffer is copied (.contiguous() would return it as it is)
    from quantizers_tpu_torch.ops.flash import _kernel_view

    buf = torch.from_numpy(np.random.default_rng(4).standard_normal(2 * 64 * 128 + 3)
                           .astype(np.float32)).bfloat16()
    q = buf[3:].view(1, 2, 64, 128)
    assert q.is_contiguous() and q.data_ptr() % 16 == 6
    got = _kernel_view(q)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, q)


def test_kernel_view_keeps_an_aligned_input():
    from quantizers_tpu_torch.ops.flash import _kernel_view

    q = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16)
    assert q.data_ptr() % 16 == 0
    assert _kernel_view(q).data_ptr() == q.data_ptr()
