"""Port parity: INT quantization numerics, quantizers_tpu_torch vs quantizers_tpu.

The JAX functions run eagerly here. Under ``jax.jit`` XLA may rewrite
``w / (absmax / d)`` as ``(w * d) / absmax``, which moves a few codes by
one; eager JAX and the port divide in the same order and agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core import scheme as ts


def _args(mod, bits, strategy, group_size=None, symmetric=True):
    return mod.QuantizationArgs(num_bits=bits, type=mod.QuantType.INT, symmetric=symmetric,
                                strategy=mod.QuantStrategy(strategy), group_size=group_size)


CASES = [
    (4, "group", 32, True),
    (4, "group", 128, True),   # group larger than K: one padded group
    (8, "channel", None, True),
    (8, "group", 32, True),
    (4, "group", 32, False),
    (8, "tensor", None, True),
]


@pytest.mark.parametrize("bits,strategy,group,sym", CASES)
def test_quantize_codes_and_scales_equal(bits, strategy, group, sym):
    w = (np.random.default_rng(bits + (group or 0)).standard_normal((48, 100)) * 0.05
         ).astype(np.float32)
    ja, ta = _args(js, bits, strategy, group, sym), _args(ts, bits, strategy, group, sym)
    jq = jn.quantize(jnp.asarray(w), ja)
    tq = tn.quantize(torch.from_numpy(w), ta)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    if sym:
        assert tq.zero_point is None and jq.zero_point is None
    else:
        np.testing.assert_array_equal(tq.zero_point.numpy(), np.asarray(jq.zero_point))
    # dequantize agrees exactly too (same f32 products)
    np.testing.assert_array_equal(tn.dequantize(tq, ta).numpy(),
                                  np.asarray(jn.dequantize(jq, ja)))


def test_round_half_away_from_zero_on_ties():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.49], np.float32)
    got = tn._round_half_away(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [-3, -2, -1, 1, 2, 3, 4, -3])
    np.testing.assert_array_equal(got, np.asarray(jn._round_half_away(jnp.asarray(x))))
    # torch.round would have rounded half to even
    assert torch.round(torch.tensor([0.5, 2.5])).tolist() == [0.0, 2.0]


def test_exact_ties_quantize_away_from_zero():
    """Weights placed on exact .5 steps of the int4 grid (scale 1/7.5)."""
    ta = _args(ts, 4, "channel")
    ja = _args(js, 4, "channel")
    w = np.array([[7.5, 0.5, -0.5, 1.5, -2.5, 6.5]], np.float32) / 7.5
    tq = tn.quantize(torch.from_numpy(w), ta, scale=torch.tensor([[1 / 7.5]]))
    jq = jn.quantize(jnp.asarray(w), ja, scale=jnp.asarray([[1 / 7.5]], jnp.float32))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))


@pytest.mark.parametrize("strategy", ["channel", "group"])
def test_minmax_and_scale_solver_equal(strategy):
    w = np.random.default_rng(7).standard_normal((16, 64)).astype(np.float32)
    ja, ta = _args(js, 8, strategy, 32, False), _args(ts, 8, strategy, 32, False)
    jmn, jmx = jn.minmax_along(jnp.asarray(w), ja)
    tmn, tmx = tn.minmax_along(torch.from_numpy(w), ta)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    js_, jz = jn.compute_scale_zp(jmn, jmx, ja)
    ts_, tz = tn.compute_scale_zp(tmn, tmx, ta)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_float_schemes_not_ported_yet():
    """FP8 weights are ported (slice 5): per-channel E4M3 codes and scales
    equal eager JAX's (every strategy: tests/test_torch_fp8.py)."""
    w = (np.random.default_rng(3).standard_normal((16, 64)) * 0.1).astype(np.float32)
    kw = dict(num_bits=8, strategy="channel")
    ta = ts.QuantizationArgs(type=ts.QuantType.FLOAT, **dict(kw, strategy=ts.QuantStrategy.CHANNEL))
    ja = js.QuantizationArgs(type=js.QuantType.FLOAT, **dict(kw, strategy=js.QuantStrategy.CHANNEL))
    tq, jq = tn.quantize(torch.from_numpy(w), ta), jn.quantize(jnp.asarray(w), ja)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
