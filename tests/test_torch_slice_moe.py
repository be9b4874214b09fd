"""Port parity for the MoE serving slice: a tiny qwen3_moe model with NVFP4
experts through both packages, in each expert layout.

``ModelSpec.tiny(moe=True, hidden_size=256, num_experts=16,
moe_intermediate_size=128, head_dim=128, vocab_size=1500)``: its shapes
pass the slot kernels' conditions (128 | D and F, 256 | 2F), so a decode
step at batch 4 with top-2 (S = 8 slots < 16 experts) takes the gathered
path: the JAX package's interpreted slot kernels against the port's plain
versions. Prefill (N = 48 tokens) takes the loop over every expert. The
weights follow the NVFP4 recipe (``recipe_moe_rtn_nvfp4``): NVFP4 experts,
bf16 attention and an f32 router, with the int8 head of
``serving_layout(head_bits=8)``. The JAX side is laid out eagerly
(``moe_w8pc_layout``, or the int8-doubled NVFP4 relayout) and carried
across; the port's own ``serving_layout`` builds the same arrays.

Logits are held to 1.6e-2 absolute: two bf16 ulps at |logit| in [1, 2)
(the logits reach about 1.4); measured at most one ulp, 7.8e-3. Both sides
round at the same points, but f32 sums run in other orders. Greedy tokens
are compared with JAX run op by op, as in ``tests/test_torch_slice.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.core.numerics import quantize as jquantize
from quantizers_tpu.core.scheme import PRESET_SCHEMES as JPRESETS
from quantizers_tpu.models import KVCache as JKVCache
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.models.moe import ExpertLinears as JExpertLinears
from quantizers_tpu.ops import linear as jl
from quantizers_tpu.serve.session import serving_layout as jserving_layout
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core.scheme import PRESET_SCHEMES as TPRESETS
from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
from quantizers_tpu_torch.ops import linear as tl
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.serve import ContinuousBatcher, generate, prefill, serving_layout

ATOL = 1.6e-2
TARGS = TPRESETS["NVFP4"].weights
SPEC_ARGS = dict(moe=True, hidden_size=256, num_experts=16, moe_intermediate_size=128,
                 head_dim=128, vocab_size=1500)
LAYOUTS = ["packed", "int8", "w8pc"]
EXPERTS = ("gate_proj", "up_proj", "down_proj")


def _nvfp4_experts(raw):
    args = JPRESETS["NVFP4"].weights
    for layer in raw["layers"]:
        for key in EXPERTS:
            el = layer["moe"][key]
            layer["moe"][key] = JExpertLinears.stack([
                jl.from_quantized(jquantize(el.expert(e).dequantize(jnp.float32).T, args), args)
                for e in range(el.num_experts)])
    return raw


def _jax_layout(jparams, layout):
    """The JAX serving params in ``layout``, converted eagerly."""
    if layout == "packed":
        return jparams
    out = dict(jparams)
    layers = []
    for layer in jparams["layers"]:
        moe = dict(layer["moe"])
        if layout == "w8pc":
            moe = jl.moe_w8pc_layout(moe)
        else:
            for key in EXPERTS:
                el = moe[key]
                moe[key] = dataclasses.replace(
                    el, weight=jl.nvfp4_packed_to_i8(el.weight),
                    scale=(el.scale.astype(jnp.float32) * 0.5).astype(el.scale.dtype))
        layers.append(dict(layer, moe=moe))
    out["layers"] = layers
    return out


@pytest.fixture(scope="module")
def base():
    jspec = JSpec.tiny(**SPEC_ARGS)
    raw = _nvfp4_experts(jinit(jspec, jax.random.PRNGKey(0)))
    return {"jspec": jspec, "spec": ModelSpec.tiny(**SPEC_ARGS), "jraw": raw,
            "jserved": jserving_layout(jspec, raw, head_bits=8), "layouts": {}}


def _models(base, layout):
    if layout not in base["layouts"]:
        jp = _jax_layout(base["jserved"], layout)
        base["layouts"][layout] = {"jparams": jp, "params": params_from_numpy(jp, device="cpu")}
    return dict(base, **base["layouts"][layout])


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(1, SPEC_ARGS["vocab_size"], shape)


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_serving_layout_builds_the_jax_arrays(base, layout):
    m = _models(base, layout)
    own = serving_layout(m["spec"], params_from_numpy(m["jraw"], device="cpu"), head_bits=8,
                         device="cpu", moe_layout=layout)
    for lt, lj in zip(own["layers"], m["jparams"]["layers"]):
        assert sorted(lt["moe"]) == sorted(lj["moe"])
        assert "qkv_proj" in lt and lt["qkv_proj"].kind == "dense"
        for key, el in lj["moe"].items():
            if key == "router":
                continue
            got, want = lt["moe"][key], el
            assert got.kind == want.kind and got.meta == want.meta
            assert got.weight.dtype == {"packed": torch.uint8, "int8": torch.int8,
                                        "w8pc": torch.int8}[layout]
            diff = np.abs(got.weight.numpy().astype(np.int32) - np.asarray(want.weight, np.int32))
            # w8pc: the JAX requantization runs compiled (one code apart at
            # most, as tests/test_torch_moe.py checks); the others are exact
            assert diff.max() <= (1 if layout == "w8pc" else 0)
            np.testing.assert_allclose(got.scale.float().numpy(),
                                       np.asarray(want.scale.astype(jnp.float32)),
                                       rtol=1e-6 if layout == "w8pc" else 0, atol=0)


def test_layout_arguments_and_their_environment(base, monkeypatch):
    raw = params_from_numpy(base["jraw"], device="cpu")
    spec = base["spec"]
    monkeypatch.setenv("QTPU_MOE_LAYOUT", "int8")
    assert serving_layout(spec, raw, device="cpu")["layers"][0]["moe"]["gate_proj"].weight.dtype \
        == torch.int8
    # an argument wins over the environment
    p = serving_layout(spec, raw, device="cpu", moe_layout="packed")
    assert p["layers"][0]["moe"]["gate_proj"].weight.dtype == torch.uint8
    monkeypatch.delenv("QTPU_MOE_LAYOUT")
    assert "gate_up_proj" in serving_layout(spec, raw, device="cpu")["layers"][1]["moe"]
    # NVFP4 linears outside the experts (here the first layer's o_proj)
    # follow nvfp4_layout, then QTPU_NVFP4_LAYOUT, then the plan
    lin = tl.from_quantized(tn.quantize(torch.randn(256, 512) * 0.1, TARGS), TARGS)
    tree = dict(raw, layers=[dict(raw["layers"][0], o_proj=lin)] + raw["layers"][1:])
    o_proj = lambda p: p["layers"][0]["o_proj"].weight.dtype  # noqa: E731
    assert o_proj(serving_layout(spec, tree, device="cpu")) == torch.int8
    monkeypatch.setenv("QTPU_NVFP4_LAYOUT", "packed")
    assert o_proj(serving_layout(spec, tree, device="cpu")) == torch.uint8
    assert o_proj(serving_layout(spec, tree, device="cpu", nvfp4_layout="int8")) == torch.int8
    monkeypatch.delenv("QTPU_NVFP4_LAYOUT")
    monkeypatch.setenv("QTPU_KEEP_PACKED_NVFP4", "1")
    assert o_proj(serving_layout(spec, tree, device="cpu")) == torch.uint8
    monkeypatch.delenv("QTPU_KEEP_PACKED_NVFP4")
    with pytest.raises(ValueError, match="moe_layout"):
        serving_layout(spec, raw, device="cpu", moe_layout="int4")
    with pytest.raises(ValueError, match="nvfp4_layout"):
        serving_layout(spec, raw, device="cpu", nvfp4_layout="w8pc")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_and_teacher_forced_decode_logits(base, layout):
    m = _models(base, layout)
    jspec, spec = m["jspec"], m["spec"]
    ids = _ids((4, 16), 2)
    jc = JKVCache.init(jspec, 4, 32)
    tc = KVCache.init(spec, 4, 32, device="cpu")
    lj, jc = jforward(m["jparams"], jspec, jnp.asarray(ids[:, :12], jnp.int32), caches=jc)
    lt, tc = prefill(m["params"], spec, torch.as_tensor(ids[:, :12]), tc)
    _close(lt, lj[:, -1])
    TK.reset_launch_counts()
    for t in range(12, 16):  # one token at a time: the gathered slot path
        lj, jc = jforward(m["jparams"], jspec, jnp.asarray(ids[:, t:t + 1], jnp.int32),
                          caches=jc)
        with torch.no_grad():
            lt, tc = forward(m["params"], spec, torch.as_tensor(ids[:, t:t + 1]), caches=tc)
        _close(lt, lj)
    assert tc[0].length.tolist() == [16] * 4
    assert all(v == 0 for v in TK.launch_counts().values())


def _jax_greedy(m, prompts, n, gaps=None):
    """Greedy decoding through the JAX package op by op (``forward`` with
    caches, argmax): jitted decoding may move bf16 logits by an ulp. With a
    list ``gaps``, each step's gap between the top two logits (B,) in bf16
    ulps of the top one is appended to it."""
    jspec, jp = m["jspec"], m["jparams"]
    caches = JKVCache.init(jspec, prompts.shape[0], 64)
    logits, caches = jforward(jp, jspec, jnp.asarray(prompts, jnp.int32), caches=caches)
    out = []
    for _ in range(n):
        if gaps is not None:
            top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)[:, -2:]
            ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 1]))) - 7)
            gaps.append((top2[:, 1] - top2[:, 0]) / ulp)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, caches = jforward(jp, jspec, tok[:, None], caches=caches)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_greedy_generate_tokens_equal(base, layout):
    m = _models(base, layout)
    prompts = _ids((4, 5), 4)
    want = _jax_greedy(m, prompts, 6)
    got = generate(m["spec"], m["params"], prompts, max_new_tokens=6, device="cpu")
    assert got.dtype == np.int32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_greedy_tokens_part_only_at_near_ties(base, layout):
    """The tiny random model has exact and one-ulp ties between its top two
    logits (bf16 logits about 1.4 at most, 1500 of them): other prompts
    than the ones above make the greedy paths part. Where a row's tokens
    first differ, the JAX logits' top two lie within two bf16 ulps."""
    m = _models(base, layout)
    for seed in (3, 5, 10):
        prompts = _ids((4, 5), seed)
        gaps = []
        want = _jax_greedy(m, prompts, 6, gaps)
        got = generate(m["spec"], m["params"], prompts, max_new_tokens=6, device="cpu")
        for row in range(4):
            diff = np.nonzero(got[row] != want[row])[0]
            if diff.size:
                assert gaps[diff[0]][row] <= 2, (seed, row, diff[0], gaps[diff[0]][row])


def test_continuous_batcher_matches_jax_greedy(base):
    """Mixed-length requests through the batcher (row prefills take the loop
    over every expert, decode steps the slot path) give each request the
    tokens that JAX's op-by-op greedy decoding gives it alone."""
    m = _models(base, "w8pc")
    reqs = [([1, 2, 3, 4], 5), ([9, 8, 7], 4), ([5, 5, 5, 5, 5, 5], 3), ([11, 12], 4)]
    s = ContinuousBatcher(m["spec"], m["params"], max_batch=2, max_len=64,
                          prefill_buckets=(8, 16), device="cpu")
    rids = [s.submit(p, n) for p, n in reqs]
    res = s.run()
    for rid, (prompt, n) in zip(rids, reqs):
        want = _jax_greedy(m, np.asarray([prompt]), n)[0].tolist()
        assert res[rid] == want and len(res[rid]) == n
