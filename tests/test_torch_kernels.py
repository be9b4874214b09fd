"""Port parity: each CUDA kernel's plain PyTorch version against the JAX
package's Pallas kernel in interpret mode, the wrappers' routing of CPU
tensors, and their shape checks.

Tolerances: both sides accumulate in f32 in a different order and round
the output to bf16 once, so outputs agree within a few bf16 ulps
(rtol 1e-2 plus a small atol for values near zero). Decode attention
rounds the probabilities to bf16 before the value product on both sides;
each (row, KV head) is held to 1e-2 of its own largest |value|, so that the
long rows, whose values are small, are checked as closely as the short ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu.ops import kernels as JK
from quantizers_tpu.ops import linear as jl
from quantizers_tpu_torch.convert import params_from_numpy, to_tensor
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.ops import dispatch as td


#: the w8 Pallas kernel rounds each dequantized weight to bf16 before its
#: product (relative 2^-9 per weight), the plain version keeps it in f32;
#: the w4 kernel applies scales to f32 partial sums on both sides
ATOL = {4: 2e-3, 8: 6e-3}


def _lin(n, k, bits, strategy, group=None, sym=True, seed=0):
    args = js.QuantizationArgs(num_bits=bits, type=js.QuantType.INT, symmetric=sym,
                               strategy=js.QuantStrategy(strategy), group_size=group)
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05).astype(np.float32)
    jlin = jl.from_quantized(jn.quantize(jnp.asarray(w), args), args)
    return jlin, params_from_numpy(jlin, device="cpu")


def _x(shape, seed):
    xj = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * 0.5, jnp.bfloat16)
    return xj, to_tensor(np.asarray(xj), "cpu")


MATMULS = [
    # (n, k, bits, strategy, group, x shape)
    (256, 512, 4, "group", 32, (4, 512)),
    (128, 512, 4, "group", 32, (2, 3, 512)),
    (384, 1024, 4, "group", 64, (8, 1024)),
    (256, 256, 8, "channel", None, (4, 256)),
    (128, 512, 8, "group", 32, (8, 512)),
    # groups other than 32, one row, and more rows than one 8-row tile
    (128, 768, 4, "group", 48, (3, 768)),
    (256, 2048, 4, "group", 128, (5, 2048)),
    (128, 512, 4, "group", 32, (1, 512)),
    (256, 512, 4, "group", 32, (40, 512)),
    (128, 1024, 8, "group", 64, (3, 1024)),
    (256, 512, 8, "channel", None, (17, 512)),
    (128, 768, 8, "channel", None, (2, 768)),
    # w8 at the groups and row counts where the card kernel's bodies split:
    # g 8 (the CUDA-core body), 16 (a fold a k16 step), 64 (staged scale
    # rows), per channel; 8 rows (one 8-row tile) and 65 (a ragged 64-row tile)
    (256, 256, 8, "group", 8, (8, 256)),
    (128, 512, 8, "group", 8, (65, 512)),
    (256, 512, 8, "group", 16, (8, 512)),
    (128, 256, 8, "group", 16, (65, 256)),
    (256, 1024, 8, "group", 64, (8, 1024)),
    (128, 1024, 8, "group", 64, (65, 1024)),
    (256, 512, 8, "channel", None, (65, 512)),
]


@pytest.mark.parametrize("n,k,bits,strategy,group,xshape", MATMULS)
def test_plain_matmul_matches_pallas_interpret(n, k, bits, strategy, group, xshape):
    jlin, tlin = _lin(n, k, bits, strategy, group, seed=n + k)
    xj, xt = _x(xshape, k)
    want = np.asarray(JK.KERNELS[jlin.kind](xj, jlin, interpret=True), np.float32)
    TK.reset_launch_counts()
    got = TK.KERNELS[tlin.kind](xt, tlin)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=ATOL[bits])
    # a CPU tensor goes to the plain version, which is not a launch
    counts = TK.launch_counts()
    assert counts["w4_matmul"] == counts["w8_matmul"] == 0
    assert all(v == 0 for v in counts.values())


def test_dispatch_routes_cpu_tensors_to_the_plain_version():
    _, tlin = _lin(256, 512, 4, "group", 32, seed=3)
    _, xt = _x((4, 512), 4)
    plain = TK.w4_matmul_plain(xt, tlin.weight, tlin.scale, 32)
    torch.testing.assert_close(td.quant_matmul(xt, tlin), plain, rtol=0, atol=0)
    # more rows than the kernel threshold take the reference path
    _, xbig = _x((td.KERNEL_MAX_ROWS + 1, 512), 5)
    torch.testing.assert_close(td.quant_matmul(xbig, tlin),
                               td.reference_quant_matmul(xbig, tlin), rtol=0, atol=0)


REJECTED = [
    # shapes and layouts the JAX kernels refuse; the port refuses the same
    (192, 512, 4, "group", 32, True),     # 128 does not divide N
    (256, 96, 4, "group", 32, True),      # 2g does not divide K
    (256, 512, 4, "group", 32, False),    # asymmetric
    (256, 128, 8, "channel", None, True), # 256 does not divide K
    (192, 512, 8, "channel", None, True),
    (256, 768, 8, "group", 64, True),     # K=768 is no multiple of 8g
    (256, 64, 4, "group", 32, True),      # K/2 is no multiple of 8g
]


@pytest.mark.parametrize("n,k,bits,strategy,group,sym", REJECTED)
def test_rejects_what_the_pallas_kernel_rejects(n, k, bits, strategy, group, sym):
    jlin, tlin = _lin(n, k, bits, strategy, group, sym)
    xj, xt = _x((2, k), 1)
    with pytest.raises(JK.KernelUnsupported):
        JK.KERNELS[jlin.kind](xj, jlin, interpret=True)
    with pytest.raises(TK.KernelUnsupported):
        TK.KERNELS[tlin.kind](xt, tlin)
    assert not TK.supports(tlin)


def _decode_inputs(B, KV, rep, hd, S, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s) for s in
            ((B, KV, rep, hd), (B, KV, hd), (B, KV, hd), (B, KV, S, hd), (B, KV, S, hd))]
    return [jnp.asarray(a, jnp.bfloat16) for a in arrs]


@pytest.mark.parametrize("KV,rep,S", [(2, 2, 32), (4, 8, 64), (8, 4, 64), (2, 1, 32)])
def test_decode_attention_plain_matches_pallas_interpret(KV, rep, S):
    """The serving head groupings (slice 1: 8 KV heads x 4, path A: 4 x 8)
    and rep 1, against the JAX kernel in interpret mode."""
    B, hd = 4, 128
    q, nk, nv, ck, cv = _decode_inputs(B, KV, rep, hd, S)
    lengths = np.array([0, 13, S - 1, S + 3], np.int32)  # empty, mid, last, clamped
    ctx_j, k_j, v_j = JK.decode_attention(q, nk, nv, ck, cv, jnp.asarray(lengths),
                                          1.0 / np.sqrt(hd), interpret=True)
    t = [to_tensor(np.asarray(a), "cpu") for a in (q, nk, nv, ck, cv)]
    ctx_t = TK.decode_attention(*t, torch.from_numpy(lengths), 1.0 / np.sqrt(hd))
    got, want = ctx_t.float().numpy(), np.asarray(ctx_j, np.float32)
    err = np.abs(got - want).max(axis=(2, 3))
    assert (err <= 1e-2 * np.abs(want).max(axis=(2, 3))).all(), err
    # the caches were written in place, at min(length, S-1) only
    np.testing.assert_array_equal(t[3].float().numpy(), np.asarray(k_j, np.float32))
    np.testing.assert_array_equal(t[4].float().numpy(), np.asarray(v_j, np.float32))
    assert TK.decode_attention.launches == 0


def test_decode_attention_ignores_nan_in_stale_rows():
    B, KV, rep, hd, S = 2, 2, 4, 128, 16
    t = [to_tensor(np.asarray(a), "cpu") for a in _decode_inputs(B, KV, rep, hd, S, 1)]
    t[3][:, :, 6:] = float("nan")
    t[4][:, :, 6:] = float("nan")
    ctx = TK.decode_attention(*t, torch.tensor([5, 3], dtype=torch.int32), 0.1)
    assert torch.isfinite(ctx).all()


@pytest.mark.parametrize("dtype,hd,rep,S,reason", [
    (torch.float32, 128, 2, 16, "bf16"),
    (torch.bfloat16, 64, 2, 16, "128|head_dim"),
    (torch.bfloat16, 256, 2, 16, "built for head_dim"),
    (torch.bfloat16, 128, 16, 16, "query heads"),
    (torch.bfloat16, 128, 2, 12, "8|S"),
])
def test_decode_attention_rejects(dtype, hd, rep, S, reason):
    q = torch.zeros((1, 1, rep, hd), dtype=dtype)
    ck = torch.zeros((1, 1, S, hd), dtype=dtype)
    assert reason in TK.decode_reason(q, ck, ck)
    with pytest.raises(TK.KernelUnsupported):
        TK.decode_attention(q, q[:, :, 0], q[:, :, 0], ck, ck.clone(),
                            torch.zeros(1, dtype=torch.int32), 0.1)


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """A wrapper picks the plain version only for a CPU tensor: any other
    device goes to the kernel (here: no device type the wrapper knows)."""
    _, tlin = _lin(256, 512, 4, "group", 32)
    meta = torch.zeros((2, 512), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TK.w4_matmul(meta, tlin)


def _offset_view(shape):
    """A bf16 tensor of ``shape`` as a contiguous view at element offset 3
    of a flat buffer: its base is 6 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(np.random.default_rng(3).standard_normal(n + 3).astype(np.float32))
    view = buf.bfloat16()[3:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 6
    return view


def test_flatten_x_copies_an_unaligned_base():
    # The matmul kernels copy x 16 bytes at a time and refuse an unaligned
    # base; .contiguous() would hand such a view on as it is
    x = _offset_view((2, 4, 256))
    got, lead = TK._flatten_x(x, 256)
    assert got.data_ptr() % 16 == 0 and lead == (2, 4)
    assert torch.equal(got, x.reshape(8, 256))


def test_flatten_x_keeps_an_aligned_input():
    x = torch.zeros((8, 256), dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    got, lead = TK._flatten_x(x, 256)
    assert got.data_ptr() == x.data_ptr() and lead == (8,)
