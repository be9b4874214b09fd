"""Port parity for the serving slice: a tiny W4A16 Qwen3-style model through
both packages, from the same quantized weights.

``ModelSpec.tiny(head_dim=128, vocab_size=1500)``: with head_dim 128 the
JAX decode reaches the (interpreted) ``decode_attention`` kernel and the
port its plain version; with vocab 1500 the int8 head is padded to 1536, so
the ``orig_n`` slice is exercised. Weights are w4 g32, quantized on the JAX
side and laid out by its ``serving_layout(head_bits=8)``; the port serves
the converted arrays.

Tolerance for logits: 8e-3 absolute. The logits lie within about 0.65 of 0
(std about 0.16), where a bf16 ulp is at most 2^-8 = 3.9e-3: the limit is
two such ulps, 5% of the logits' std. Both sides round at the same points,
but f32 sums may run in another order, and the JAX prefill runs under jit,
where XLA may keep fused bf16 intermediates in f32; the eager forward
agrees exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _quantize_params_rtn
from quantizers_tpu.models import KVCache as JKVCache
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.serve.engine import prefill as jprefill
from quantizers_tpu.serve.session import ContinuousBatcher as JBatcher
from quantizers_tpu.serve.session import serving_layout as jserving_layout
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
from quantizers_tpu_torch.serve import ContinuousBatcher, generate, prefill, serving_layout
from quantizers_tpu_torch.serve.engine import _decode_scan

ATOL = 8e-3
#: cached K is post-norm, post-rope (|k| up to ~4, a bf16 ulp up to 2^-6)
KV_RTOL, KV_ATOL = 1e-2, 3e-2
SPEC_ARGS = dict(head_dim=128, vocab_size=1500)


@pytest.fixture(scope="module")
def models():
    jspec = JSpec.tiny(**SPEC_ARGS)
    raw = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(0)))
    jparams = jserving_layout(jspec, raw, head_bits=8)
    spec = ModelSpec.tiny(**SPEC_ARGS)
    return {"jspec": jspec, "jraw": raw, "jparams": jparams, "spec": spec,
            "raw": params_from_numpy(raw, device="cpu"),
            "params": params_from_numpy(jparams, device="cpu")}


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(1, SPEC_ARGS["vocab_size"], shape)


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0, atol=ATOL)


def test_layout_matches(models):
    p, jp = models["params"], models["jparams"]
    assert set(p["layers"][0]) == set(jp["layers"][0])
    assert p["lm_head"].meta_dict["orig_n"] == 1500 and p["lm_head"].out_features == 1536
    # the port's own serving_layout builds the same head: the JAX head was
    # quantized under jit, where XLA reorders w / (absmax / 127.5) and moves
    # a few codes by one; the port divides as eager JAX does
    own = serving_layout(models["spec"], models["raw"], head_bits=8, device="cpu")
    np.testing.assert_array_equal(own["lm_head"].scale.float().numpy(),
                                  np.asarray(jp["lm_head"].scale.astype(jnp.float32)))
    diff = own["lm_head"].weight.int().numpy() - np.asarray(jp["lm_head"].weight, np.int32)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.02
    assert set(own["layers"][0]) == set(jp["layers"][0])


def test_forward_logits(models):
    ids = _ids((2, 12), 1)
    lj, _ = jforward(models["jparams"], models["jspec"], jnp.asarray(ids, jnp.int32))
    lt, _ = forward(models["params"], models["spec"], torch.as_tensor(ids))
    assert lt.shape == (2, 12, 1500)
    _close(lt, lj)


def test_prefill_and_teacher_forced_decode_logits(models):
    jspec, spec = models["jspec"], models["spec"]
    ids = _ids((2, 20), 2)
    jc = JKVCache.init(jspec, 2, 32)
    tc = KVCache.init(spec, 2, 32, device="cpu")
    lj, jc = jprefill(models["jparams"], jspec, jnp.asarray(ids[:, :12], jnp.int32), jc)
    lt, tc = prefill(models["params"], spec, torch.as_tensor(ids[:, :12]), tc)
    _close(lt, lj)
    for t in range(12, 20):  # one token at a time: the decode-attention path
        lj, jc = jforward(models["jparams"], jspec, jnp.asarray(ids[:, t:t + 1], jnp.int32),
                          caches=jc)
        with torch.no_grad():
            lt, tc = forward(models["params"], spec, torch.as_tensor(ids[:, t:t + 1]), caches=tc)
        _close(lt, lj)
    assert tc[0].length.tolist() == [20, 20]
    np.testing.assert_allclose(tc[1].k.float().numpy(), np.asarray(jc[1].k, np.float32),
                               rtol=KV_RTOL, atol=KV_ATOL)


def _jax_greedy(models, prompts, n):
    """Greedy decoding through the JAX package op by op (``forward`` with
    caches, argmax). The jitted ``generate`` is not the reference here:
    under jit XLA may keep fused bf16 intermediates in f32, which moves
    logits by an ulp, and this tiny random model has exact top-2 ties."""
    jspec, jp = models["jspec"], models["jparams"]
    caches = JKVCache.init(jspec, prompts.shape[0], 64)
    logits, caches = jforward(jp, jspec, jnp.asarray(prompts, jnp.int32), caches=caches)
    out = []
    for _ in range(n):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, caches = jforward(jp, jspec, tok[:, None], caches=caches)
    return np.stack(out, axis=1)


def test_greedy_generate_tokens_equal(models):
    prompts = _ids((2, 4), 3)
    want = _jax_greedy(models, prompts, 8)
    got = generate(models["spec"], models["params"], prompts, max_new_tokens=8, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_decode_scan_updates_caches_in_place(models):
    spec, params = models["spec"], models["params"]
    caches = KVCache.init(spec, 2, 64, device="cpu")
    last, caches = prefill(params, spec, torch.as_tensor(_ids((2, 6), 4)), caches)
    first = last.argmax(-1)
    start = [c.clone() for c in caches]
    a, _ = _decode_scan(params, spec, [c.clone() for c in start], first, None,
                        steps=5, temperature=0.0, top_k=0)
    b, out = _decode_scan(params, spec, caches, first, None, steps=5, temperature=0.0, top_k=0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[0] is caches[0] and caches[0].length.tolist() == [11, 11]
    assert start[0].length.tolist() == [6, 6]


def test_sampling_reproducible_by_seed(models):
    spec, params = models["spec"], models["params"]
    prompts = _ids((1, 4), 5)
    a = generate(spec, params, prompts, max_new_tokens=6, temperature=1.0, seed=7, device="cpu")
    b = generate(spec, params, prompts, max_new_tokens=6, temperature=1.0, seed=7, device="cpu")
    c = generate(spec, params, prompts, max_new_tokens=6, temperature=1.0, top_k=5, seed=8,
                 device="cpu")
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and ((0 <= c) & (c < 1500)).all()


def test_continuous_batcher_matches_jax(models):
    reqs = [([1, 2, 3, 4], 6), ([9, 8, 7], 5), ([5, 5, 5, 5, 5, 5], 4)]
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(8, 16))
    js = JBatcher(models["jspec"], models["jparams"], **kw)
    ts = ContinuousBatcher(models["spec"], models["params"], device="cpu", **kw)
    jr = [js.submit(p, n) for p, n in reqs]
    tr = [ts.submit(p, n) for p, n in reqs]
    jres, tres = js.run(), ts.run()
    for a, b, (_, n) in zip(jr, tr, reqs):
        assert tres[b] == jres[a] and len(tres[b]) == n
