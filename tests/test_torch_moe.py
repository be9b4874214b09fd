"""Port parity for the MoE block: routing, the expert serving layouts, the
slot-FFN kernels' plain versions against the JAX package's Pallas kernels
in interpret mode, ``moe_forward`` in both regimes, the NVFP4 capacity plan
and the carrying of expert stacks across.

Tolerances: the slot FFNs round each dequantized weight (K6) and the
activation a (both) to bf16 at the same points on both sides and sum in
f32 in another order; a single bf16 rounding of a that falls the other way
moves an output by up to 2^-8 of that term. Outputs are held to 1e-2 of the
largest |y| (measured: below 3e-7 of it). ``moe_forward`` returns bf16:
held to two bf16 ulps of its largest |value| (measured: at most half of
one).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core.scheme import PRESET_SCHEMES as JPRESETS
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import moe as jm
from quantizers_tpu.ops import kernels as JK
from quantizers_tpu.ops import linear as jl
from quantizers_tpu_torch.convert import params_from_numpy, to_tensor
from quantizers_tpu_torch.models import ModelSpec, moe as tm
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.ops import linear as tl


def _stack(kind, E, k_in, n_out, seed):
    """A JAX expert stack of E random (n_out, k_in) weights under NVFP4 or
    W4A16 g32."""
    args = JPRESETS["NVFP4" if kind == "nvfp4" else "W4A16_G32"].weights
    rng = np.random.default_rng(seed)
    lins = [jl.from_quantized(jn.quantize(jnp.asarray(rng.standard_normal((n_out, k_in))
                                                      * 0.2, jnp.float32), args), args)
            for _ in range(E)]
    return jm.ExpertLinears.stack(lins)


def _to_i8(el):
    return dataclasses.replace(el, weight=jl.nvfp4_packed_to_i8(el.weight),
                               scale=(el.scale.astype(jnp.float32) * 0.5).astype(el.scale.dtype))


def _experts(kind, E, D, Fe, seed, layout="packed"):
    els = [_stack(kind, E, D, Fe, seed), _stack(kind, E, D, Fe, seed + 1),
           _stack(kind, E, Fe, D, seed + 2)]
    return [_to_i8(el) for el in els] if layout == "int8" else els


def _slots(S, D, E, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((S, D)), jnp.bfloat16)
    idx = rng.integers(0, E, S).astype(np.int32)
    idx[:2] = idx[2]  # a repeated expert
    return x, jnp.asarray(idx), to_tensor(np.asarray(x), "cpu"), torch.from_numpy(idx)


def _close_rel(got, want, rtol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scoring,bias,scaling,norm", [
    ("softmax", False, 1.0, True), ("softmax", False, 1.0, False),
    ("sigmoid", True, 2.5, True), ("sigmoid", False, 1.0, False)])
def test_route_topk_sparse_and_dense_equal(scoring, bias, scaling, norm):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 16)).astype(np.float32)  # no ties
    b = rng.standard_normal(16).astype(np.float32) * 0.1 if bias else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    ji, jv = jm.route_topk_sparse(jnp.asarray(logits), 4, norm, scoring, jb, scaling)
    ti, tv = tm.route_topk_sparse(torch.from_numpy(logits), 4, norm, scoring, tb, scaling)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    dense_j = jm.route_topk(jnp.asarray(logits), 4, norm, scoring, jb, scaling)
    dense_t = tm.route_topk(torch.from_numpy(logits), 4, norm, scoring, tb, scaling)
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the expert serving layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,layout", [("nvfp4", "packed"), ("nvfp4", "int8"),
                                         ("w4", "packed")])
def test_experts_to_w8pc_codes_exact_against_eager_jax(kind, layout):
    jel = _experts(kind, 5, 256, 128, 10, layout)[0]
    tel = params_from_numpy(jel, device="cpu")
    got = tl.experts_to_w8pc(tel, chunk=2)  # chunks of 2: the last one ragged
    # the body of jl.experts_to_w8pc, run eagerly expert by expert
    # (jl.experts_to_w8pc itself runs it compiled, under lax.map)
    eager_w, eager_s = [], []
    for e in range(jel.num_experts):
        W = jel.expert(e).dequantize(jnp.float32)
        sc = jnp.max(jnp.abs(W), axis=0, keepdims=True) / 127.0 + 1e-12
        eager_w.append(np.asarray(jnp.clip(jnp.round(W / sc), -127, 127).astype(jnp.int8)))
        eager_s.append(np.asarray(sc))
    assert got.kind == "w8" and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.weight.numpy(), np.stack(eager_w))
    np.testing.assert_array_equal(got.scale.numpy(), np.stack(eager_s))
    # compiled, XLA may rewrite W / sc: at most one code apart
    want = jl.experts_to_w8pc(jel)
    assert got.meta == want.meta and got.weight.shape == want.weight.shape
    diff = np.abs(got.weight.numpy().astype(np.int32) - np.asarray(want.weight, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6, atol=0)


def test_moe_w8pc_layout_structure_and_fusion():
    g, u, d = _experts("nvfp4", 4, 256, 128, 20)
    jtree = {"layers": [{"moe": {"router": jl.dense_linear(np.zeros((4, 256), np.float32)),
                                 "gate_proj": g, "up_proj": u, "down_proj": d}}]}
    want = jl.moe_w8pc_layout(jtree)["layers"][0]["moe"]
    got = tl.moe_w8pc_layout(params_from_numpy(jtree, device="cpu"))["layers"][0]["moe"]
    assert sorted(got) == sorted(want) == ["down_proj", "gate_up_proj", "router"]
    for key in ("gate_up_proj", "down_proj"):
        assert isinstance(got[key], tm.ExpertLinears) and got[key].meta == want[key].meta
        # the JAX layout requantizes under lax.map, compiled: one code apart
        # at most (the eager codes are checked exactly above)
        diff = got[key].weight.numpy().astype(np.int32) - np.asarray(want[key].weight, np.int32)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01
        np.testing.assert_allclose(got[key].scale.numpy(), np.asarray(want[key].scale),
                                   rtol=1e-6, atol=0)
    assert got["gate_up_proj"].weight.shape == (4, 256, 256)


@pytest.mark.parametrize("budget_of_int8", [2.0, 1.0, 0.999])
def test_nvfp4_capacity_plan_matches_jax(budget_of_int8):
    g, u, d = _experts("nvfp4", 4, 256, 128, 30)
    head = jl.from_quantized(jn.quantize(jnp.ones((256, 256)) * 0.1, JPRESETS["NVFP4"].weights),
                             JPRESETS["NVFP4"].weights)
    jtree = {"embed": jnp.zeros((100, 256), jnp.bfloat16), "head": head,
             "moe": {"gate_proj": g, "up_proj": u, "down_proj": d}}
    ttree = params_from_numpy(jtree, device="cpu")
    int8_bytes = jl.nvfp4_capacity_plan(jtree, hbm_bytes=10 ** 9)["int8_bytes"]
    hbm = int(int8_bytes * budget_of_int8 / 0.75)
    for shards in (1, 2):
        want = jl.nvfp4_capacity_plan(jtree, hbm_bytes=hbm, expert_shards=shards)
        got = tl.nvfp4_capacity_plan(ttree, hbm_bytes=hbm, expert_shards=shards)
        assert got == want
        if shards == 1 and budget_of_int8 != 1.0:  # 1.0 sits on the rounding edge
            assert got["int8_ok"] == (budget_of_int8 > 1.0)


def test_device_hbm_bytes_needs_a_cuda_device():
    with pytest.raises(ValueError, match="no CUDA device"):
        tl.device_hbm_bytes("cpu")
    assert tl.infer_expert_shards({}) == 1


def test_converted_expert_stacks():
    """JAX ExpertLinears (and dicts with a stacked weight) become the port's
    ExpertLinears; 2-D linears stay QuantLinears."""
    g = _experts("nvfp4", 3, 256, 128, 40)[0]
    tree = {"stack": g, "lin": g.expert(1),
            "as_dict": {"kind": "nvfp4", "weight": np.asarray(g.weight),
                        "scale": np.asarray(g.scale, np.float32), "meta": g.meta}}
    got = params_from_numpy(tree, device="cpu")
    for key in ("stack", "as_dict"):
        el = got[key]
        assert isinstance(el, tm.ExpertLinears) and el.num_experts == 3
        assert el.kind == "nvfp4" and el.meta == tuple((a, int(b)) for a, b in g.meta)
        np.testing.assert_array_equal(el.weight.numpy(), np.asarray(g.weight))
    assert isinstance(got["lin"], tl.QuantLinear) and got["lin"].weight.shape == (128, 128)
    np.testing.assert_array_equal(got["stack"].expert(1).dequantize(torch.float32).numpy(),
                                  np.asarray(g.expert(1).dequantize(jnp.float32)))
    np.testing.assert_array_equal(got["stack"].dequantize(torch.float32)[2].numpy(),
                                  np.asarray(g.expert(2).dequantize(jnp.float32)))


# ---------------------------------------------------------------------------
# the slot-FFN kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

_SLOT_PAYLOADS = [("w4", "packed"), ("nvfp4", "packed"), ("nvfp4", "int8")]


@pytest.mark.parametrize(
    "kind,layout,routing",
    [pytest.param(k, lay, "mixed", id=f"{k}-{lay}") for k, lay in _SLOT_PAYLOADS]
    + [pytest.param(k, lay, r, id=f"{k}-{lay}-{r}")
       for r in ("one_expert", "all_distinct") for k, lay in _SLOT_PAYLOADS])
def test_moe_slot_ffn_plain_matches_pallas_interpret(kind, layout, routing):
    """The routings: uniform draws with a repeated expert, every slot on one
    expert, and every slot on its own expert (E 8), through the JAX kernel's
    expert sort."""
    E, D, Fe, S = (8 if routing == "all_distinct" else 4), 256, 128, 8
    jels = _experts(kind, E, D, Fe, 50, layout)
    tels = [params_from_numpy(el, device="cpu") for el in jels]
    xj, ij, xt, it = _slots(S, D, E, 1)
    if routing != "mixed":
        ids = np.full(S, 2, np.int32) if routing == "one_expert" else \
            np.random.default_rng(4).permutation(E).astype(np.int32)
        ij, it = jnp.asarray(ids), torch.from_numpy(ids)
    want = JK.moe_slot_ffn(xj, ij, *jels, interpret=True)
    TK.reset_launch_counts()
    got = TK.moe_slot_ffn(xt, it, *tels)
    assert got.dtype == torch.float32 and got.shape == (S, D)
    _close_rel(got, want, 1e-2)
    assert all(v == 0 for v in TK.launch_counts().values())
    # the gather reference (what moe_forward takes when the kernel cannot)
    gw, uw, dw = (tm._slot_dequant(el, it) for el in tels)
    g, u = tm._slot_matmul(xt, gw), tm._slot_matmul(xt, uw)
    ref = tm._slot_matmul((torch.nn.functional.silu(g) * u).bfloat16(), dw)
    _close_rel(ref, want, 1e-2)


@pytest.mark.parametrize("routing", ["mixed", "one_expert", "all_distinct"])
def test_moe_slot_gu_ffn_plain_matches_pallas_interpret(routing):
    """The routings of the K6 test above, through the JAX kernel's expert
    sort."""
    E, D, Fe, S = (8 if routing == "all_distinct" else 4), 256, 128, 8
    g, u, d = _experts("nvfp4", E, D, Fe, 60)
    jmoe = jl.moe_w8pc_layout({"gate_proj": g, "up_proj": u, "down_proj": d})
    tmoe = params_from_numpy(jmoe, device="cpu")
    xj, ij, xt, it = _slots(S, D, E, 2)
    if routing != "mixed":
        ids = np.full(S, 2, np.int32) if routing == "one_expert" else \
            np.random.default_rng(4).permutation(E).astype(np.int32)
        ij, it = jnp.asarray(ids), torch.from_numpy(ids)
    want = JK.moe_slot_gu_ffn(xj, ij, jmoe["gate_up_proj"], jmoe["down_proj"], interpret=True)
    got = TK.moe_slot_gu_ffn(xt, it, tmoe["gate_up_proj"], tmoe["down_proj"])
    assert got.dtype == torch.float32 and got.shape == (S, D)
    _close_rel(got, want, 1e-2)
    assert TK.moe_slot_gu_ffn.launches == 0


@pytest.mark.parametrize("S,D,Fe,fused", [(6, 256, 128, False), (8, 192, 128, False),
                                          (8, 256, 96, False), (6, 256, 128, True),
                                          (8, 256, 64, True)])
def test_slot_kernels_reject_what_the_pallas_kernels_reject(S, D, Fe, fused):
    E = 4
    g, u, d = _experts("nvfp4", E, D, Fe, 70)
    xj, ij, xt, it = _slots(S, D, E, 3)
    if fused:
        jmoe = jl.moe_w8pc_layout({"gate_proj": g, "up_proj": u, "down_proj": d})
        tmoe = params_from_numpy(jmoe, device="cpu")
        with pytest.raises(JK.KernelUnsupported):
            JK.moe_slot_gu_ffn(xj, ij, jmoe["gate_up_proj"], jmoe["down_proj"], interpret=True)
        assert TK.moe_slot_gu_reason(xt, tmoe["gate_up_proj"], tmoe["down_proj"])
        with pytest.raises(TK.KernelUnsupported):
            TK.moe_slot_gu_ffn(xt, it, tmoe["gate_up_proj"], tmoe["down_proj"])
        return
    tels = [params_from_numpy(el, device="cpu") for el in (g, u, d)]
    with pytest.raises(JK.KernelUnsupported):
        JK.moe_slot_ffn(xj, ij, g, u, d, interpret=True)
    assert TK.moe_slot_ffn_reason(xt, *tels)
    with pytest.raises(TK.KernelUnsupported):
        TK.moe_slot_ffn(xt, it, *tels)


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

def _moe_block(jspec, layout, seed):
    E, D, Fe = jspec.num_experts, jspec.hidden_size, jspec.moe_intermediate_size
    rng = np.random.default_rng(seed)
    g, u, d = _experts("nvfp4", E, D, Fe, seed, "int8" if layout == "int8" else "packed")
    moe = {"router": jl.dense_linear(rng.standard_normal((E, D)).astype(np.float32) * 0.5,
                                     dtype=jnp.float32),
           "gate_proj": g, "up_proj": u, "down_proj": d}
    return jl.moe_w8pc_layout(moe) if layout == "w8pc" else moe


@pytest.mark.parametrize("layout", ["packed", "int8", "w8pc"])
@pytest.mark.parametrize("B,T,regime", [(4, 1, "gathered"), (4, 12, "scan")])
def test_moe_forward_matches_jax(layout, B, T, regime):
    kw = dict(moe=True, hidden_size=256, num_experts=16, moe_intermediate_size=128)
    jspec, spec = JSpec.tiny(**kw), ModelSpec.tiny(**kw)
    jmoe = _moe_block(jspec, layout, 80)
    tmoe = params_from_numpy(jmoe, device="cpu")
    x = np.random.default_rng(B * T).standard_normal((B, T, 256)).astype(np.float32)
    want = np.asarray(jm.moe_forward(jmoe, jspec, jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = tm.moe_forward(tmoe, spec, to_tensor(np.asarray(jnp.asarray(x, jnp.bfloat16)), "cpu"))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 256)
    # two bf16 ulps of the largest |value|
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * ulp)
    # gathered (N*k = 8 < 16 experts) or the loop over every expert
    TK.reset_launch_counts()
    all_e = tm.moe_forward(tmoe, spec, got, all_experts=True)
    assert all_e.shape == got.shape and all(v == 0 for v in TK.launch_counts().values())


def test_moe_forward_below_the_kernel_conditions_takes_the_gather_reference(monkeypatch):
    """D = 192 fails the slot kernels' 128|D: both packages go through the
    gathered dequantized weights, and the port never calls the kernel."""
    kw = dict(moe=True, hidden_size=192, num_experts=16, moe_intermediate_size=128)
    jspec, spec = JSpec.tiny(**kw), ModelSpec.tiny(**kw)
    for layout in ("packed", "w8pc"):
        jmoe = _moe_block(jspec, layout, 90)
        tmoe = params_from_numpy(jmoe, device="cpu")
        x = jnp.asarray(np.random.default_rng(5).standard_normal((4, 1, 192)), jnp.bfloat16)
        want = np.asarray(jm.moe_forward(jmoe, jspec, x), np.float32)

        def never(*a, **k):
            raise AssertionError("the slot kernel was called")
        monkeypatch.setattr(TK, "moe_slot_ffn", never)
        monkeypatch.setattr(TK, "moe_slot_gu_ffn", never)
        got = tm.moe_forward(tmoe, spec, to_tensor(np.asarray(x), "cpu"))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * ulp)
        monkeypatch.undo()


def test_shared_experts_and_sigmoid_router():
    kw = dict(moe=True, hidden_size=256, num_experts=16, moe_intermediate_size=128,
              num_shared_experts=1, scoring_func="sigmoid", routed_scaling_factor=2.5)
    jspec, spec = JSpec.tiny(**kw), ModelSpec.tiny(**kw)
    jmoe = _moe_block(jspec, "packed", 95)
    rng = np.random.default_rng(6)
    jmoe["e_score_correction_bias"] = jnp.asarray(rng.standard_normal(16) * 0.1, jnp.float32)
    jmoe["shared_experts"] = {
        name: jl.dense_linear(rng.standard_normal(shape).astype(np.float32) * 0.05)
        for name, shape in (("gate_proj", (128, 256)), ("up_proj", (128, 256)),
                            ("down_proj", (256, 128)))}
    tmoe = params_from_numpy(jmoe, device="cpu")
    for T in (1, 12):
        x = jnp.asarray(rng.standard_normal((4, T, 256)), jnp.bfloat16)
        want = np.asarray(jm.moe_forward(jmoe, jspec, x), np.float32)
        got = tm.moe_forward(tmoe, spec, to_tensor(np.asarray(x), "cpu"))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * ulp)
