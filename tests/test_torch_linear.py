"""Port parity: QuantLinear layouts, dequantize, fusion and the params
conversion, quantizers_tpu_torch vs quantizers_tpu."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu.ops import dispatch as jd
from quantizers_tpu.ops import linear as jl
from quantizers_tpu_torch.convert import params_from_numpy, to_tensor
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core import scheme as ts
from quantizers_tpu_torch.ops import dispatch as td
from quantizers_tpu_torch.ops import linear as tl


def _args(mod, bits, strategy, group_size=None, symmetric=True):
    return mod.QuantizationArgs(num_bits=bits, type=mod.QuantType.INT, symmetric=symmetric,
                                strategy=mod.QuantStrategy(strategy), group_size=group_size)


def _w(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)


def _both(w, bits, strategy, group=None, sym=True):
    """The same (N, K) weight laid out by each package from its own quantize."""
    ja, ta = _args(js, bits, strategy, group, sym), _args(ts, bits, strategy, group, sym)
    jlin = jl.from_quantized(jn.quantize(jnp.asarray(w), ja), ja)
    tlin = tl.from_quantized(tn.quantize(torch.from_numpy(w), ta), ta)
    return jlin, tlin


LAYOUTS = [
    ((64, 128), 4, "group", 32, True),
    ((16, 100), 4, "group", 32, True),    # K % g != 0: ragged tail group
    ((32, 64), 4, "group", 128, True),    # g > K: one group
    ((24, 64), 4, "group", 32, False),    # zero points
    ((64, 256), 8, "channel", None, True),
    ((64, 256), 8, "group", 32, True),
]


@pytest.mark.parametrize("shape,bits,strategy,group,sym", LAYOUTS)
def test_layout_and_dequantize_equal(shape, bits, strategy, group, sym):
    jlin, tlin = _both(_w(shape, sum(shape)), bits, strategy, group, sym)
    assert tlin.kind == jlin.kind and tlin.meta == tuple(jlin.meta)
    np.testing.assert_array_equal(tlin.weight.numpy(), np.asarray(jlin.weight))
    np.testing.assert_array_equal(tlin.scale.float().numpy(),
                                  np.asarray(jlin.scale.astype(jnp.float32)))
    np.testing.assert_array_equal(tlin.dequantize(torch.float32).numpy(),
                                  np.asarray(jlin.dequantize(jnp.float32)))


def test_dense_dequantize_and_reference_matmul_equal():
    w, b = _w((48, 64), 1), _w((48,), 2)
    jlin = jl.dense_linear(w, bias=b)
    tlin = tl.dense_linear(w, bias=b, device="cpu")
    np.testing.assert_array_equal(tlin.dequantize(torch.float32).numpy(),
                                  np.asarray(jlin.dequantize(jnp.float32)))
    x = _w((3, 64), 3) * 20
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = to_tensor(np.asarray(xj), "cpu")
    # f32 accumulation of exact bf16 products on both sides; bf16 output
    np.testing.assert_allclose(tlin.apply(xt, use_kernel=False).float().numpy(),
                               np.asarray(jlin.apply(xj, use_kernel=False), np.float32),
                               rtol=8e-3, atol=1e-3)


def test_reference_quant_matmul_matches_xla_path():
    jlin, tlin = _both(_w((128, 256), 4), 4, "group", 32)
    x = jnp.asarray(_w((5, 256), 5) * 20, jnp.bfloat16)
    got = td.reference_quant_matmul(to_tensor(np.asarray(x), "cpu"), tlin)
    want = np.asarray(jd.xla_quant_matmul(x, jlin), np.float32)
    # same bf16 weights and f32 sums; the order of the sums differs
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=1e-3)


def test_pack_nibbles_matches_from_quantized():
    vals = np.random.default_rng(6).integers(-8, 8, (64, 32))
    np.testing.assert_array_equal(tl._pack_nibbles_np(vals), jl._pack_nibbles_np(vals))
    np.testing.assert_array_equal(
        tl._unpack_nibbles(torch.from_numpy(tl._pack_nibbles_np(vals))).numpy(), vals)


def test_concat_linears_equal():
    parts = [_both(_w((n, 128), n), 4, "group", 32) for n in (64, 32, 32)]
    jcat = jl.concat_linears([p[0] for p in parts])
    tcat = tl.concat_linears([p[1] for p in parts])
    assert tcat.meta == tuple(jcat.meta)
    np.testing.assert_array_equal(tcat.weight.numpy(), np.asarray(jcat.weight))
    np.testing.assert_array_equal(tcat.dequantize(torch.float32).numpy(),
                                  np.asarray(jcat.dequantize(jnp.float32)))
    with pytest.raises(ValueError):
        tl.concat_linears([parts[0][1], tl.dense_linear(_w((8, 128), 0), device="cpu")])


def test_convert_round_trip():
    jlin, _ = _both(_w((64, 128), 8), 4, "group", 32)
    head_j = jl.QuantLinear(kind="w8", weight=jnp.zeros((128, 256), jnp.int8),
                            scale=jnp.ones((1, 256), jnp.bfloat16),
                            meta=(("k", jnp.asarray(128)), ("n", jnp.asarray(256)),
                                  ("group_size", None), ("orig_n", jnp.asarray(250))))
    tree = {"embed": jnp.asarray(_w((10, 8), 9), jnp.bfloat16),
            "layers": [{"q_proj": jlin, "norm": jnp.ones((8,), jnp.bfloat16)}],
            "lm_head": head_j,
            "as_dict": {"kind": "w4", "weight": np.asarray(jlin.weight),
                        "scale": np.asarray(jlin.scale), "meta": jlin.meta}}
    out = params_from_numpy(tree, device="cpu")
    assert out["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["embed"].float().numpy(),
                                  np.asarray(tree["embed"], np.float32))
    q = out["layers"][0]["q_proj"]
    assert isinstance(q, tl.QuantLinear) and q.weight.dtype == torch.uint8
    np.testing.assert_array_equal(q.dequantize(torch.float32).numpy(),
                                  np.asarray(jlin.dequantize(jnp.float32)))
    assert out["lm_head"].meta == (("k", 128), ("n", 256), ("group_size", None),
                                   ("orig_n", 250))
    assert all(type(v) is int for _, v in out["lm_head"].meta if v is not None)
    np.testing.assert_array_equal(out["as_dict"].weight.numpy(), q.weight.numpy())


def test_later_kinds_raise_not_implemented():
    # fp8 linears are ported (slice 5): a tensor-scaled one dequantizes as
    # the JAX package's does
    codes = np.array([[0.5, -1.0, 448.0, 0.0]] * 4, np.float32)
    lin = tl.QuantLinear(kind="fp8", weight=torch.from_numpy(codes).to(torch.float8_e4m3fn),
                         scale=torch.full((1, 1), 0.25),
                         meta=(("k", 4), ("n", 4), ("strategy", "tensor")))
    jlin = jl.QuantLinear(kind="fp8", weight=jnp.asarray(codes, jnp.float8_e4m3fn),
                          scale=jnp.full((1, 1), 0.25, jnp.float32), meta=lin.meta)
    np.testing.assert_array_equal(lin.dequantize(torch.float32).numpy(),
                                  np.asarray(jlin.dequantize(jnp.float32)))
    # a W8A8 linear carried over from the JAX package: its activation
    # quantization is not ported, so only the A16 oracle may run
    w8a8 = tl.QuantLinear(kind="w8", weight=torch.ones(256, 128, dtype=torch.int8),
                          scale=torch.ones(1, 128, dtype=torch.bfloat16),
                          meta=(("k", 256), ("n", 128), ("group_size", None),
                                ("act", "token_i8")))
    x = torch.ones(2, 256, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="item 13"):
        w8a8.apply(x)
    assert w8a8.apply(x, use_kernel=False).shape == (2, 128)
