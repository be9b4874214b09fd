"""Port parity for FP8 E4M3 weights: the numerics of every strategy, the
``fp8`` QuantLinear, its serving layout, and the FP8 block matmul
kernel's plain version against the JAX package's Pallas kernel in
interpret mode.

Everything up to the matmul is exact: the same f32 operations in the same
order (E4M3 snapping through ``torch.float8_e4m3fn``, clipped to +-448
first, which rounds to nearest even as ml_dtypes does). The matmul rounds
each scaled weight to bf16 once on both sides and sums in f32 in another
order: outputs agree within one bf16 ulp of each value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu.ops import dispatch as jd
from quantizers_tpu.ops import kernels as JK
from quantizers_tpu.ops import linear as jl
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core import scheme as ts
from quantizers_tpu_torch.models import ModelSpec
from quantizers_tpu_torch.ops import dispatch as td
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.ops import linear as tl
from quantizers_tpu_torch.serve import serving_layout

STRATEGIES = {"tensor": {}, "channel": {}, "group": {"group_size": 128},
              "block": {"block_structure": (128, 128)}}


def _args(mod, strategy, symmetric=True):
    return mod.QuantizationArgs(num_bits=8, type=mod.QuantType.FLOAT, symmetric=symmetric,
                                strategy=mod.QuantStrategy(strategy), **STRATEGIES[strategy])


def _w(shape, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    # heavy tails, so that blocks differ widely in scale
    return (rng.standard_t(3, shape) * scale).astype(np.float32)


def _linears(strategy, n, k, seed=0):
    """The same weight quantized by both packages: (port, JAX device form,
    JAX host form)."""
    w = _w((n, k), seed)
    ja, ta = _args(js, strategy), _args(ts, strategy)
    jq = jn.quantize(jnp.asarray(w), ja)
    host = jn.QuantizedTensor(np.asarray(jq.values), np.asarray(jq.scale), None, None, jq.shape)
    return (tl.from_quantized(tn.quantize(torch.from_numpy(w), ta), ta),
            jl.from_quantized(jq, ja), jl.from_quantized(host, ja))


def _ulps_apart(t: torch.Tensor, j) -> float:
    """The largest |t - j| in bf16 ulps of the larger magnitude."""
    a, b = t.float().numpy(), np.asarray(j, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((np.abs(a - b) / ulp).max())


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_fp8_codes_and_scales_equal(strategy, sym):
    w = _w((200, 300), 1)
    w[3, 5], w[7] = 1e-9, 0.0  # a subnormal and an all-zero row
    ja, ta = _args(js, strategy, sym), _args(ts, strategy, sym)
    jq = jn.quantize(jnp.asarray(w), ja)
    tq = tn.quantize(torch.from_numpy(w), ta)
    assert tq.values.dtype == torch.float32 and tq.shape == jq.shape
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    if sym:
        assert tq.zero_point is None
    else:
        np.testing.assert_array_equal(tq.zero_point.numpy(), np.asarray(jq.zero_point))
    np.testing.assert_array_equal(tn.dequantize(tq, ta).numpy(),
                                  np.asarray(jn.dequantize(jq, ja)))


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_from_quantized_and_dequantize_equal(strategy):
    tlin, jdev, jhost = _linears(strategy, 384, 256)
    assert tlin.kind == "fp8" and tlin.weight.dtype == torch.float8_e4m3fn
    assert tlin.meta == jdev.meta == jhost.meta
    assert tlin.scale.dtype == torch.float32 and tuple(tlin.scale.shape) == jhost.scale.shape
    for jlin in (jdev, jhost):  # both forms of the JAX package's from_quantized
        conv = params_from_numpy({"l": jlin}, device="cpu")["l"]  # fp8 bits carried across
        assert conv.weight.dtype == torch.float8_e4m3fn
        assert torch.equal(conv.weight.view(torch.uint8), tlin.weight.view(torch.uint8))
        np.testing.assert_array_equal(conv.scale.numpy(), tlin.scale.numpy())
    np.testing.assert_array_equal(tlin.dequantize(torch.float32).numpy(),
                                  np.asarray(jdev.dequantize(jnp.float32)))
    np.testing.assert_array_equal(tlin.dequantize().float().numpy(),
                                  np.asarray(jdev.dequantize().astype(jnp.float32)))


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_concat_linears_equal(strategy):
    a, ja, _ = _linears(strategy, 256, 256, seed=2)
    b, jb, _ = _linears(strategy, 128, 256, seed=3)
    if strategy == "tensor":
        for concat, lins in ((tl.concat_linears, [a, b]), (jl.concat_linears, [ja, jb])):
            with pytest.raises(ValueError, match="tensor-scaled"):
                concat(lins)
        return
    got, want = tl.concat_linears([a, b]), jl.concat_linears([ja, jb])
    assert got.meta == want.meta and got.out_features == 384
    np.testing.assert_array_equal(got.dequantize(torch.float32).numpy(),
                                  np.asarray(want.dequantize(jnp.float32)))


@pytest.mark.parametrize("m", [1, 8, 130])
@pytest.mark.parametrize("k,n", [(128, 256), (256, 384), (384, 128)])
def test_fp8_matmul_plain_matches_pallas_interpret(m, k, n):
    tlin, jlin, _ = _linears("block", n, k, seed=k + n)
    x = (np.random.default_rng(m).standard_normal((m, k))).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    want = JK.fp8_matmul(jnp.asarray(x, jnp.bfloat16), jlin, interpret=True)
    got = TK.fp8_matmul(xt, tlin)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.equal(got, TK.fp8_matmul_plain(xt, tlin.weight, tlin.scale))
    assert _ulps_apart(got, want) <= 1.0
    # the reference path rounds the same weights at the same point
    assert _ulps_apart(td.reference_quant_matmul(xt, tlin), want) <= 1.0


ROUTES = {  # (strategy, block, n, k): does the Pallas kernel take it?
    "block_128": ("block", (128, 128), 256, 384),
    "block_ragged_k": ("block", (128, 128), 256, 200),
    "block_ragged_n": ("block", (128, 128), 200, 256),
    "block_64": ("block", (64, 64), 256, 256),
    "channel": ("channel", None, 256, 256),
    "group": ("group", None, 256, 256),
}


_plain = TK.fp8_matmul_plain


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_takes_what_the_pallas_kernel_takes(case, monkeypatch):
    strategy, block, n, k = ROUTES[case]
    extra = {"block_structure": block} if block else dict(STRATEGIES[strategy])
    ja = js.QuantizationArgs(num_bits=8, type=js.QuantType.FLOAT,
                             strategy=js.QuantStrategy(strategy), **extra)
    ta = ts.QuantizationArgs(num_bits=8, type=ts.QuantType.FLOAT,
                             strategy=ts.QuantStrategy(strategy), **extra)
    w = _w((n, k), 5)
    jlin = jl.from_quantized(jn.quantize(jnp.asarray(w), ja), ja)
    tlin = tl.from_quantized(tn.quantize(torch.from_numpy(w), ta), ta)
    x = torch.ones((4, k), dtype=torch.bfloat16)
    try:
        JK.fp8_matmul(jnp.ones((4, k), jnp.bfloat16), jlin, interpret=True)
        jax_takes = True
    except JK.KernelUnsupported:
        jax_takes = False
    assert (TK._fp8_reason(tlin) is None) == jax_takes == (case == "block_128")
    assert td.kernels.supports(tlin) == jax_takes
    calls = []

    def counting(*a):
        calls.append(1)
        return _plain(*a)

    monkeypatch.setattr(TK, "fp8_matmul_plain", counting)
    y = td.quant_matmul(x, tlin)
    assert len(calls) == int(jax_takes)
    np.testing.assert_array_equal(y.float().numpy(),
                                  td.reference_quant_matmul(x, tlin).float().numpy())
    if jax_takes:  # above KERNEL_MAX_ROWS the reference path, as in JAX
        calls.clear()
        td.quant_matmul(torch.ones((td.KERNEL_MAX_ROWS + 1, k), dtype=torch.bfloat16), tlin)
        assert not calls




def test_fp8_kernel_refuses_other_payloads():
    tlin, _, _ = _linears("block", 256, 256)
    bad = tl.QuantLinear(kind="fp8", weight=tlin.weight, scale=tlin.scale.bfloat16(),
                         meta=tlin.meta)
    assert "f32" in TK._fp8_reason(bad)
    with pytest.raises(TK.KernelUnsupported):
        TK.fp8_matmul(torch.ones((2, 256), dtype=torch.bfloat16), bad)
    assert TK.fp8_matmul.launches == 0  # the CPU never launches


def _fp8_tree():
    out = {}
    for i, strategy in enumerate(("block", "channel")):
        out[strategy] = _linears(strategy, 256, 256, seed=10 + i)
    return out


@pytest.mark.parametrize("dense", [True, False], ids=["hoisted", "resident"])
def test_fp8_device_layout_both_ways(dense, monkeypatch):
    lins = _fp8_tree()
    tree = {"layers": [{"q_proj": lins["block"][0], "o_proj": lins["channel"][0],
                        "norm": torch.ones(4)}]}
    jtree = {"layers": [{"q_proj": lins["block"][1], "o_proj": lins["channel"][1],
                         "norm": jnp.ones(4)}]}
    # the JAX package converts only on a TPU: run its conversion here as it
    # runs there
    monkeypatch.setattr(jd, "_on_tpu", lambda: True)
    want = jl.i4_device_layout(jtree, fp8_dense=None if dense else False, nvfp4_int8=dense)
    got = tl.fp8_device_layout(tree, fp8_dense=dense)
    for name in ("q_proj", "o_proj"):
        g, w = got["layers"][0][name], want["layers"][0][name]
        assert g.kind == w.kind == ("dense" if dense else "fp8") and g.meta == w.meta
        np.testing.assert_array_equal(g.dequantize(torch.float32).numpy(),
                                      np.asarray(w.dequantize(jnp.float32)))
    if not dense:
        assert got is tree


def test_serving_layout_fp8_choice_and_capacity_plan(monkeypatch):
    lins = _fp8_tree()
    spec = ModelSpec.tiny(hidden_size=256, intermediate_size=256, head_dim=64)
    params = {"embed": torch.zeros((256, 256), dtype=torch.bfloat16), "final_norm": torch.ones(256),
              "lm_head": None,
              "layers": [{"mlp": {"down_proj": lins["block"][0]}}]}
    monkeypatch.delenv("QTPU_FP8_LAYOUT", raising=False)
    resident = serving_layout(spec, params, device="cpu")
    assert resident["layers"][0]["mlp"]["down_proj"].kind == "fp8"  # the default
    auto = serving_layout(spec, params, device="cpu", fp8_layout="auto")
    assert auto["layers"][0]["mlp"]["down_proj"].kind == "dense"
    monkeypatch.setenv("QTPU_FP8_LAYOUT", "auto")
    assert serving_layout(spec, params, device="cpu")["layers"][0]["mlp"]["down_proj"].kind == \
        "dense"
    monkeypatch.setenv("QTPU_NVFP4_LAYOUT", "packed")  # the plan's decision says no hoist
    assert serving_layout(spec, params, device="cpu")["layers"][0]["mlp"]["down_proj"].kind == \
        "fp8"
    monkeypatch.setenv("QTPU_FP8_LAYOUT", "dense")
    with pytest.raises(ValueError, match="qtpu_fp8_layout"):
        serving_layout(spec, params, device="cpu")
    # the capacity plan counts one more byte per fp8 weight, as the JAX plan
    jparams = {"layers": [{"mlp": {"down_proj": lins["block"][1]}}], "embed": jnp.zeros((256, 256),
               jnp.bfloat16)}
    tparams = {"layers": [{"mlp": {"down_proj": lins["block"][0]}}],
               "embed": torch.zeros((256, 256), dtype=torch.bfloat16)}
    for hbm in (10**6, 2 * 10**5):
        assert tl.nvfp4_capacity_plan(tparams, hbm_bytes=hbm) == \
            jl.nvfp4_capacity_plan(jparams, hbm_bytes=hbm)


def test_fp8_expert_stacks_gather_and_dequantize_as_jax():
    """FP8_BLOCK expert stacks (the real GLM-4.7-Flash / DeepSeek-V2-Lite
    experts) go through the gathered reference: ``_slot_dequant`` equals
    the JAX package's exactly."""
    from quantizers_tpu.models import moe as jmoe
    from quantizers_tpu_torch.models import moe as tmoe

    experts = [_linears("block", 256, 128, seed=20 + e) for e in range(4)]
    jel = jmoe.ExpertLinears.stack([e[1] for e in experts])
    tel = params_from_numpy({"s": jel}, device="cpu")["s"]
    assert isinstance(tel, tmoe.ExpertLinears) and tel.weight.dtype == torch.float8_e4m3fn
    idx = np.array([3, 0, 3, 1], np.int32)
    want = jmoe._slot_dequant(jel, jnp.asarray(idx))
    got = tmoe._slot_dequant(tel, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
