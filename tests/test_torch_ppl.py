"""Port parity for the perplexity path: the no-cache forward (flash
attention where the JAX package takes it, the einsum elsewhere) and
``perplexity``, from the same W4A16 weights in both packages.

``ModelSpec.tiny(hidden_size=256, head_dim=128)``: with head dim 128 a
no-cache forward at 8 | T reaches the JAX package's flash kernel (in
interpret mode) and the port's plain flash version; at T = 15 both take
the einsum.

Tolerances: logits 1.6e-2 absolute. They lie within about 1.4 of 0, where
a bf16 ulp is at most 2^-7 = 7.8e-3: the limit is two such ulps (both sides
round at the same points, with f32 sums in another order; measured: at
most 8.8e-3, on the flash and the einsum path alike). Perplexity 1e-3
relative: the JAX package scores under jit, where XLA may keep fused bf16
intermediates in f32; the NLL mean moves by far less than a logit ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _quantize_params_rtn
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.serve import perplexity as jperplexity
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.ops import flash as TF
from quantizers_tpu_torch.serve import perplexity
from quantizers_tpu_torch.serve.engine import token_logprobs

ATOL = 1.6e-2
PPL_RTOL = 1e-3
SPEC_ARGS = dict(hidden_size=256, head_dim=128, intermediate_size=256, vocab_size=512)


@pytest.fixture(scope="module")
def models():
    jspec = JSpec.tiny(**SPEC_ARGS)
    jparams = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(3)))
    return {"jspec": jspec, "jparams": jparams, "spec": ModelSpec.tiny(**SPEC_ARGS),
            "params": params_from_numpy(jparams, device="cpu")}


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(1, SPEC_ARGS["vocab_size"], shape)


@pytest.mark.parametrize("T,flash", [(32, True), (16, True), (15, False)])
def test_no_cache_forward_logits(models, T, flash, monkeypatch):
    ids = _ids((2, T), T)
    lj, _ = jforward(models["jparams"], models["jspec"], jnp.asarray(ids, jnp.int32))
    calls = []
    plain = TF.flash_attention_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(TF, "flash_attention_plain", spy)
    with torch.no_grad():
        lt, _ = forward(models["params"], models["spec"], torch.as_tensor(ids))
    # the flash branch fires in every layer exactly where the JAX package's does
    assert len(calls) == (models["spec"].num_layers if flash else 0)
    assert lt.shape == (2, T, SPEC_ARGS["vocab_size"])
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32), rtol=0, atol=ATOL)


def test_token_logprobs_match_a_full_log_softmax(models):
    ids = torch.as_tensor(_ids((2, 24), 5))
    lp = token_logprobs(models["params"], models["spec"], ids)
    with torch.no_grad():
        logits, _ = forward(models["params"], models["spec"], ids)
    want = torch.gather(torch.log_softmax(logits[:, :-1].float(), dim=-1), -1,
                        ids[:, 1:, None])[..., 0]
    assert lp.shape == (2, 23) and torch.equal(lp, want)


def test_perplexity_matches_jax(models):
    rng = np.random.default_rng(11)
    batches = []
    for B, T in ((2, 32), (3, 16), (1, 15)):
        ids = _ids((B, T), B * T).astype(np.int32)
        mask = np.ones((B, T), np.float32)
        mask[:, : rng.integers(0, T // 2)] = 0.0  # context-only positions
        mask[-1, T - 3:] = 0.0  # padding
        batches.append((ids, mask))
    want = jperplexity(models["jspec"], models["jparams"], batches)
    got = perplexity(models["spec"], models["params"], batches, device="cpu")
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) <= PPL_RTOL * want, (got, want)
