"""Port parity for the FP8_BLOCK MLA serving slice: a tiny DeepSeek-style
MLA model with FP8_BLOCK 128 x 128 weights through both packages.

The spec's widths are multiples of 128 where the kernels need them
(hidden 256, FFN 256, ``kv_lora_rank`` 128, 4 heads of nope 24 / rope 8 /
v 32: q_proj 256 -> 128, o_proj 128 -> 256), so the port's CPU run reaches
the plain versions of both kernels of the slice: the FP8 block matmul for
q_proj, o_proj, the fused gate|up and down_proj, and the MLA decode kernel
at every one-token step; kv_b_proj (N 224) takes the reference path, as
in JAX. ``kv_a_proj_with_mqa`` stays bf16 (the recipe's sensitive-layer
policy, ``configs/recipes/recipe_fp8_block_mla.yaml``). Vocab 1500: the
int8 head is padded to 1536.

Tolerance for logits: 8e-3 absolute, two bf16 ulps of the logits (within
about 1 of 0); both sides round at the same points and sum in f32 in other
orders. Greedy tokens are compared against JAX run op by op and may part
only where the JAX logits' top two lie within two bf16 ulps.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu import formats as jf
from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core.scheme import PRESET_SCHEMES as JPRESETS
from quantizers_tpu.models import KVCache as JKVCache
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.models import loader as jloader
from quantizers_tpu.ops import linear as jl
from quantizers_tpu.serve.session import ContinuousBatcher as JBatcher
from quantizers_tpu.serve.session import serving_layout as jserving_layout
from quantizers_tpu_torch import formats as tf
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core import quantize
from quantizers_tpu_torch.core.scheme import PRESET_SCHEMES as TPRESETS
from quantizers_tpu_torch.models import KVCache, ModelSpec, forward, load_compressed_model
from quantizers_tpu_torch.models import loader as tloader
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.serve import ContinuousBatcher, generate, serving_layout

ATOL = 8e-3
TIE_ULPS = 2
SPEC_ARGS = dict(mla=True, q_lora_rank=0, hidden_size=256, intermediate_size=256,
                 kv_lora_rank=128, num_heads=4, num_kv_heads=4, qk_nope_head_dim=24,
                 qk_rope_head_dim=8, v_head_dim=32, vocab_size=1500, num_layers=2)
FP8_TARGETS = ("q_proj", "kv_b_proj", "o_proj")
MLP = ("gate_proj", "up_proj", "down_proj")
IGNORE = ["lm_head", "re:.*kv_a_proj_with_mqa$"]


@pytest.fixture(scope="module")
def models():
    jspec, spec = JSpec.tiny(**SPEC_ARGS), ModelSpec.tiny(**SPEC_ARGS)
    args = JPRESETS["FP8_BLOCK"].weights
    raw = jinit(jspec, jax.random.PRNGKey(0))
    ws, qts = {}, {}  # HF prefix -> the bf16 weight (N, K) and its JAX QuantizedTensor
    for i, lyr in enumerate(raw["layers"]):
        for where, names, pre in ((lyr, FP8_TARGETS, "self_attn"), (lyr["mlp"], MLP, "mlp")):
            for name in names:
                prefix = f"model.layers.{i}.{pre}.{name}"
                ws[prefix] = np.asarray(where[name].dequantize(jnp.float32)).T
                qts[prefix] = jn.quantize(jnp.asarray(ws[prefix]), args)
                where[name] = jl.from_quantized(qts[prefix], args)
    jparams = jserving_layout(jspec, raw, head_bits=8)
    return {"jspec": jspec, "spec": spec, "jraw": raw, "jparams": jparams, "ws": ws, "qts": qts,
            "raw": params_from_numpy(raw, device="cpu"),
            "params": params_from_numpy(jparams, device="cpu")}


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(1, SPEC_ARGS["vocab_size"], shape)


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0, atol=ATOL)


def _same_fp8(a, b):
    assert a.kind == b.kind == "fp8" and a.meta == b.meta
    assert torch.equal(a.weight.view(torch.uint8), b.weight.view(torch.uint8))
    assert torch.equal(a.scale, b.scale)


def test_layout_matches(models):
    p, jp = models["params"], models["jparams"]
    own = serving_layout(models["spec"], models["raw"], head_bits=8, device="cpu")
    assert set(own["layers"][0]) == set(jp["layers"][0]) == set(p["layers"][0])
    lyr, jlyr = own["layers"][0], p["layers"][0]
    for name in FP8_TARGETS:  # resident fp8, as the JAX package serves off a TPU
        _same_fp8(lyr[name], jlyr[name])
    _same_fp8(lyr["mlp"]["gateup_proj"], jlyr["mlp"]["gateup_proj"])
    assert lyr["kv_a_proj_with_mqa"].kind == "dense"
    for key in ("w_uk_t", "w_uv"):
        assert torch.equal(lyr["mla_absorb"][key], jlyr["mla_absorb"][key])
    assert own["lm_head"].out_features == 1536 and own["lm_head"].meta_dict["orig_n"] == 1500
    # the JAX head was quantized under jit (a code may move by one)
    diff = own["lm_head"].weight.int() - p["lm_head"].weight.int()
    assert diff.abs().max() <= 1


def _count_plain(monkeypatch):
    calls = {"fp8": 0, "mla": 0}
    fp8, mla = TK.fp8_matmul_plain, TK.mla_decode_attention_plain

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(TK, "fp8_matmul_plain", count("fp8", fp8))
    monkeypatch.setattr(TK, "mla_decode_attention_plain", count("mla", mla))
    return calls


def test_prefill_and_decode_logits_and_kernel_calls(models, monkeypatch):
    jspec, spec = models["jspec"], models["spec"]
    calls = _count_plain(monkeypatch)
    ids = _ids((2, 20), 2)
    jc = JKVCache.init(jspec, 2, 32)
    tc = KVCache.init(spec, 2, 32, device="cpu")
    lj, jc = jforward(models["jparams"], jspec, jnp.asarray(ids[:, :12], jnp.int32), caches=jc)
    with torch.no_grad():
        lt, tc = forward(models["params"], spec, torch.as_tensor(ids[:, :12]), caches=tc)
    _close(lt, lj)
    L = spec.num_layers
    # the prefill (m = 24 rows): four fp8 calls a layer, no MLA decode step
    assert calls == {"fp8": 4 * L, "mla": 0}
    for t in range(12, 20):
        lj, jc = jforward(models["jparams"], jspec, jnp.asarray(ids[:, t:t + 1], jnp.int32),
                          caches=jc)
        with torch.no_grad():
            lt, tc = forward(models["params"], spec, torch.as_tensor(ids[:, t:t + 1]), caches=tc)
        _close(lt, lj)
    assert calls == {"fp8": 4 * L * 9, "mla": L * 8}
    assert tc[0].length.tolist() == [20, 20]
    np.testing.assert_allclose(tc[1].k.float().numpy(), np.asarray(jc[1].k, np.float32),
                               rtol=1e-2, atol=3e-2)


def _jax_greedy(models, prompts, n):
    """Greedy tokens of the JAX package run op by op, with each step's logits."""
    jspec, jp = models["jspec"], models["jparams"]
    caches = JKVCache.init(jspec, prompts.shape[0], 64)
    logits, caches = jforward(jp, jspec, jnp.asarray(prompts, jnp.int32), caches=caches)
    toks, steps = [], []
    for _ in range(n):
        last = np.asarray(logits[:, -1], np.float32)
        tok = last.argmax(-1).astype(np.int32)
        toks.append(tok)
        steps.append(last)
        logits, caches = jforward(jp, jspec, jnp.asarray(tok)[:, None], caches=caches)
    return np.stack(toks, 1), np.stack(steps, 1)


def _agree_up_to_near_ties(got, want, logits):
    for b in range(got.shape[0]):
        differ = np.nonzero(got[b] != want[b])[0]
        if differ.size:
            top2 = np.sort(logits[b, differ[0]])[-2:]
            ulp = 2.0 ** (np.floor(np.log2(abs(top2[1]))) - 7)
            assert top2[1] - top2[0] <= TIE_ULPS * ulp, (b, differ[0], top2)


def test_greedy_generate_tokens_equal_up_to_near_ties(models):
    prompts = _ids((3, 5), 3)
    want, logits = _jax_greedy(models, prompts, 10)
    got = generate(models["spec"], models["params"], prompts, max_new_tokens=10, device="cpu")
    assert got.dtype == np.int32 and got.shape == (3, 10)
    _agree_up_to_near_ties(got, want, logits)


def test_continuous_batcher_matches_jax(models):
    reqs = [([1, 2, 3, 4], 6), ([9, 8, 7], 5), ([5, 5, 5, 5, 5, 5], 4)]
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(8, 16))
    js = JBatcher(models["jspec"], models["jraw"], **kw)
    ts = ContinuousBatcher(models["spec"], models["raw"], device="cpu", **kw)
    jr = [js.submit(p, n) for p, n in reqs]
    tr = [ts.submit(p, n) for p, n in reqs]
    jres, tres = js.run(), ts.run()
    for a, b, (prompt, n) in zip(jr, tr, reqs):
        assert len(tres[b]) == n
        want, logits = _jax_greedy(models, np.asarray([prompt]), n)
        _agree_up_to_near_ties(np.asarray([tres[b]]), want, logits)
        _agree_up_to_near_ties(np.asarray([jres[a]]), want, logits)


def test_fp8_checkpoint_round_trip_between_the_packages(models, tmp_path):
    jspec, spec, raw = models["jspec"], models["spec"], models["jraw"]
    jscheme, tscheme = JPRESETS["FP8_BLOCK"], TPRESETS["FP8_BLOCK"]
    plain = jloader.model_plain_tensors(jspec, raw)
    for prefix, lin in jloader.iter_model_linears(jspec, raw):
        if lin.kind == "dense":  # kv_a_proj_with_mqa and the head stay bf16
            plain[f"{prefix}.weight"] = np.asarray(lin.dequantize(), ml_dtypes.bfloat16).T
    quant = {p: jf.CompressedParam(qt, jscheme.weights) for p, qt in models["qts"].items()}
    jf.save_compressed_model(tmp_path / "jax", plain, quant, {"group_0": jscheme}, IGNORE,
                             base_config=jspec.to_hf_config())
    # the JAX package's checkpoint in the port: the same fp8 linears
    spec2, loaded = load_compressed_model(tmp_path / "jax", device="cpu")
    assert spec2 == spec
    assert torch.equal(loaded["lm_head"].weight, models["raw"]["lm_head"].weight)
    for lyr, ref in zip(loaded["layers"], models["raw"]["layers"]):
        for name in FP8_TARGETS:
            _same_fp8(lyr[name], ref[name])
        for name in MLP:
            _same_fp8(lyr["mlp"][name], ref["mlp"][name])
        assert torch.equal(lyr["kv_a_proj_with_mqa"].weight, ref["kv_a_proj_with_mqa"].weight)
    # the port's own quantization of the same weights, in the JAX package
    tplain = tloader.model_plain_tensors(spec, models["raw"])
    tquant = {}
    for prefix, lin in tloader.iter_model_linears(spec, models["raw"]):
        if lin.kind == "dense":
            tplain[f"{prefix}.weight"] = lin.weight.t().contiguous()
        else:
            w = torch.from_numpy(models["ws"][prefix].copy())
            tquant[prefix] = tf.CompressedParam(quantize(w, tscheme.weights), tscheme.weights)
    tf.save_compressed_model(tmp_path / "port", tplain, tquant, {"group_0": tscheme}, IGNORE,
                             base_config=spec.to_hf_config())
    _, jloaded = jloader.load_compressed_model(tmp_path / "port")
    back = params_from_numpy(jloaded, device="cpu")
    for lyr, ref in zip(back["layers"], models["raw"]["layers"]):
        for name in FP8_TARGETS:
            _same_fp8(lyr[name], ref[name])
    ids = _ids((1, 8), 9)
    with torch.no_grad():
        a, _ = forward(loaded, spec, torch.as_tensor(ids))
        b, _ = forward(back, spec, torch.as_tensor(ids))
    assert torch.equal(a, b)
