"""Port parity for the training slice: ``models/fit.py`` (``fit_lm``,
``lm_loss``, the optimizer) and ``make_tiny_model --fit-corpus``, against
the JAX package's ``fit_lm`` and optax, on tiny models.

Tolerances:

* The optimizer alone, against ``optax.adamw(optax.cosine_decay_schedule(
  lr, steps))``: each element within 1e-6 of its leaf's largest |value|
  after every step (both sides round in f32 in other orders, a few f32
  ulps of the leaf's scale after 10 steps; an element near 0 carries the
  roundings of the larger values it passed through, so a relative limit
  per element cannot hold). A weight decay of 1e-2 (torch's default) or a
  schedule one step off moves elements by 1e-4 of their scale.
* The learning rate: within 2 f32 ulps of the initial rate of optax's
  schedule, which optax computes in f32 (cos near pi rounds to 2^-24);
  the port's is the same formula in float64.
* ``lm_loss`` against ``jax.value_and_grad`` of the JAX ``fit.py`` loss on
  the same f32 weights: the loss within 1e-3 relative, each leaf's
  gradient within 2e-2 of its own largest |value| (both sides round the
  activations to bf16 at the same points, with f32 sums in other orders).
* ``fit_lm`` against the JAX ``fit_lm``, 30 steps on the same windows:
  the fitted models' perplexities on the corpus within 1e-2 relative.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from quantizers_tpu.data.simple_tokenizer import ByteTokenizer as JByteTokenizer
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.models.fit import fit_lm as jfit_lm
from quantizers_tpu.models.loader import load_hf_model as jload_hf_model
from quantizers_tpu.models.transformer import forward as jforward
from quantizers_tpu.serve import perplexity as jperplexity
from quantizers_tpu_torch.cli import make_tiny_model
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core.scheme import PRESET_SCHEMES
from quantizers_tpu_torch.data.simple_tokenizer import ByteTokenizer
from quantizers_tpu_torch.models import ModelSpec, init_params, load_hf_model
from quantizers_tpu_torch.models import fit as TFIT
from quantizers_tpu_torch.models.moe import ExpertLinears
from quantizers_tpu_torch.ops import flash as TF
from quantizers_tpu_torch.ops import kernels as K
from quantizers_tpu_torch.ops.linear import QuantLinear, from_quantized
from quantizers_tpu_torch.serve import perplexity

FIT = dict(steps=30, batch_size=4, seq_len=32, lr=3e-3, seed=0)


def chain_text(n: int = 6000, seed: int = 0) -> str:
    """An order-1 Markov chain over 32 ASCII symbols, about 4 successors a
    state: the perplexity protocol's corpus (``benchmarks/ppl_protocol.py``),
    shorter."""
    rng = np.random.default_rng(seed)
    syms = [chr(ord("a") + i) for i in range(26)] + list(".,;: !")
    trans = np.zeros((32, 32))
    for i in range(32):
        trans[i, rng.choice(32, size=4, replace=False)] = rng.dirichlet([1.0] * 4)
    r = np.random.default_rng(seed + 1)
    out = [int(r.integers(32))]
    for _ in range(n - 1):
        out.append(int(r.choice(32, p=trans[out[-1]])))
    return "".join(syms[i] for i in out)


def _flat(tree, path=""):
    """(path, tensor or array) of every leaf of either package's params,
    dict keys sorted, a linear's fields by name."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif hasattr(tree, "kind") and hasattr(tree, "weight"):
        for field in ("weight", "scale", "zero_point", "bias"):
            if getattr(tree, field) is not None:
                yield from _flat(getattr(tree, field), f"{path}.{field}")
    elif tree is not None:
        yield path, tree


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _windows(ids, T=128):
    n = (len(ids) // T) * T
    x = np.asarray(ids[:n], np.int32).reshape(-1, T)
    return [(x, np.ones_like(x, np.float32))]


# ---------------------------------------------------------------------------
# the optimizer and its schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr,steps", [(3e-3, 10), (2e-3, 7)])
def test_optimizer_matches_optax_adamw(lr, steps):
    rng = np.random.default_rng(0)
    shapes = [(16, 8), (8,), (3, 5, 7)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    leaves = [torch.tensor(p, requires_grad=True) for p in p0]
    opt, sched = TFIT.make_optimizer(leaves, lr, steps)
    ref = optax.adamw(optax.cosine_decay_schedule(lr, steps))
    jp = [jnp.asarray(p) for p in p0]
    state = ref.init(jp)
    for _ in range(steps):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for leaf, g in zip(leaves, grads):
            leaf.grad = torch.tensor(g)
        opt.step()
        sched.step()
        updates, state = ref.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, want in zip(leaves, jp):
            want = np.asarray(want)
            np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("lr,steps", [(3e-3, 300), (2e-3, 2500), (3e-3, 1)])
def test_learning_rate_follows_optax_cosine_decay(lr, steps):
    opt, sched = TFIT.make_optimizer([torch.zeros(2, requires_grad=True)], lr, steps)
    want = np.asarray(jax.vmap(optax.cosine_decay_schedule(lr, steps))(
        np.arange(steps + 3)), np.float64)
    got = []
    for _ in range(steps + 3):
        got.append(sched.get_last_lr()[0])
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(lr)))
    assert opt.param_groups[0]["weight_decay"] == 1e-4
    assert opt.param_groups[0]["betas"] == (0.9, 0.999) and opt.param_groups[0]["eps"] == 1e-8


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

def _jax_loss(jspec):
    # the loss of quantizers_tpu/models/fit.py's train_step
    def loss_fn(p, batch):
        logits, _ = jforward(p, jspec, batch[:, :-1])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        tgt = batch[:, 1:]
        return -jnp.take_along_axis(logp, tgt[..., None], axis=-1).mean()
    return loss_fn


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_lm_loss_and_gradients_match_jax(moe):
    jspec = JSpec.tiny(moe=moe)
    jparams = _f32(jinit(jspec, jax.random.PRNGKey(1)))
    batch = np.random.default_rng(2).integers(1, jspec.vocab_size, (2, 17)).astype(np.int32)
    jl, jg = jax.value_and_grad(_jax_loss(jspec))(jparams, jnp.asarray(batch))

    params32, leaves = TFIT.trainable(params_from_numpy(jparams, device="cpu"))
    loss = TFIT.lm_loss(ModelSpec.tiny(moe=moe), params32, torch.as_tensor(batch))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-3 * abs(float(jl))

    got = dict(_flat(params32))
    want = dict(_flat(jg))
    assert sorted(got) == sorted(want) and len(got) == len(leaves)
    for path, leaf in got.items():
        g = leaf.grad
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, path
        ref = np.asarray(want[path], np.float32)
        err = np.abs(g.numpy() - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), (path, err, np.abs(ref).max())


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_attention_under_autograd_takes_the_einsum(mla, monkeypatch):
    # head dim 128 (MLA: a 192-wide qk head padded to 256, v 128) at T 64:
    # a shape the flash branch takes in a no-grad forward
    spec = (ModelSpec.tiny(mla=True, hidden_size=128, qk_nope_head_dim=128,
                           qk_rope_head_dim=64, v_head_dim=128) if mla
            else ModelSpec.tiny(head_dim=128, hidden_size=128))
    params = init_params(spec, seed=0, device="cpu")
    calls = []
    plain = TF.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(TF, "flash_attention", spy)
    batch = torch.as_tensor(np.random.default_rng(0).integers(1, 256, (2, 65)))
    params32, _ = TFIT.trainable(params)
    loss = TFIT.lm_loss(spec, params32, batch)
    loss.backward()
    assert calls == []
    q = params32["layers"][0]["q_a_proj" if mla else "q_proj"].weight
    assert q.grad is not None and q.grad.abs().max() > 0
    with torch.no_grad():
        TFIT.lm_loss(spec, params32, batch)
    assert len(calls) == spec.num_layers


# ---------------------------------------------------------------------------
# every kernel wrapper refuses an input that requires grad
# ---------------------------------------------------------------------------

def _lin(scheme, n=128, k=512, seed=0):
    """A linear quantized by the port with a preset scheme (W8A8's meta
    records its per-token activations)."""
    scheme = PRESET_SCHEMES[scheme]
    w = torch.randn((n, k), generator=torch.Generator().manual_seed(seed)) * 0.05
    return from_quantized(tn.quantize(w, scheme.weights), scheme.weights,
                          act_args=scheme.input_activations)


def _bf16(*shape, grad=False):
    t = torch.randn(shape).bfloat16()
    return t.requires_grad_(grad)


def _nvfp4_i8():
    from quantizers_tpu_torch.ops.linear import nvfp4_packed_to_i8

    lin = _lin("NVFP4", k=256)
    return dataclasses.replace(lin, weight=nvfp4_packed_to_i8(lin.weight),
                               scale=(lin.scale.float() / 2).bfloat16())


def _stack(scheme, n, k):
    return ExpertLinears.stack([_lin(scheme, n=n, k=k, seed=e) for e in range(4)])


def _w8pc():
    gu = ExpertLinears.stack([_lin("W8A16", n=256, k=128, seed=e) for e in range(4)])
    down = ExpertLinears.stack([_lin("W8A16", n=128, k=128, seed=e) for e in range(4)])
    return (dataclasses.replace(gu, scale=gu.scale.float()),
            dataclasses.replace(down, scale=down.scale.float()))


def _slot_ffn(x):
    return K.moe_slot_ffn(x, torch.arange(8) % 4, _stack("W4A16_G32", 128, 128),
                          _stack("W4A16_G32", 128, 128), _stack("W4A16_G32", 128, 128))


def _gptq(w):
    return K.gptq_block(w, torch.eye(8) + 0.1 * torch.ones(8, 8).triu(1), torch.full((16, 1), 0.1),
                        None, torch.zeros(8, dtype=torch.int64), -8.0, 7.0)


def _mla(q):
    return K.mla_decode_attention(q, _bf16(2, 4, 128), _bf16(2, 128), _bf16(2, 128),
                                  _bf16(2, 1, 16, 128), _bf16(2, 1, 16, 128),
                                  torch.tensor([3, 5], dtype=torch.int32), 0.1)


#: name -> (a function of the input that may require grad, that input)
GUARDED = {
    "w4_matmul": (lambda x: K.w4_matmul(x, _lin("W4A16_G32")), lambda: _bf16(4, 512)),
    "w8_matmul": (lambda x: K.w8_matmul(x, _lin("W8A16", k=256)), lambda: _bf16(4, 256)),
    "w8a8_token_matmul": (lambda x: K.w8a8_token_matmul(x, _lin("W8A8", k=256)),
                          lambda: _bf16(4, 256)),
    "w8a8_matmul": (lambda s: K.w8a8_matmul(torch.ones((4, 256), dtype=torch.int8), s,
                                            _lin("W8A8", k=256)), lambda: torch.rand(4, 1)),
    "nvfp4_matmul": (lambda x: K.nvfp4_matmul(x, _lin("NVFP4", k=256)), lambda: _bf16(4, 256)),
    "nvfp4_i8_matmul": (lambda x: K.nvfp4_i8_matmul(x, _nvfp4_i8()), lambda: _bf16(4, 256)),
    "fp8_matmul": (lambda x: K.fp8_matmul(x, _lin("FP8_BLOCK", k=256)), lambda: _bf16(4, 256)),
    "decode_attention": (lambda q: K.decode_attention(
        q, _bf16(2, 2, 128), _bf16(2, 2, 128), _bf16(2, 2, 16, 128), _bf16(2, 2, 16, 128),
        torch.tensor([3, 5], dtype=torch.int32), 0.1), lambda: _bf16(2, 2, 4, 128)),
    "mla_decode_attention": (_mla, lambda: _bf16(2, 4, 128)),
    "moe_slot_ffn": (_slot_ffn, lambda: _bf16(8, 128)),
    "moe_slot_gu_ffn": (lambda x: K.moe_slot_gu_ffn(x, torch.arange(8) % 4, *_w8pc()),
                        lambda: _bf16(8, 128)),
    "flash_attention": (lambda q: TF.flash_attention(q, _bf16(1, 2, 16, 128),
                                                     _bf16(1, 2, 16, 128), 0.1),
                        lambda: _bf16(1, 4, 16, 128)),
    "gptq_block": (_gptq, lambda: torch.randn(16, 8)),
}


def test_every_kernel_wrapper_is_guarded():
    assert sorted(GUARDED) == sorted(K.launch_counts())


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernel_wrappers_refuse_an_input_that_requires_grad(name):
    torch.manual_seed(0)
    call, make = GUARDED[name]
    x = make()
    out = call(x)  # no input requires grad: the plain version runs
    assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
        call(x.clone().requires_grad_(True))
    with torch.no_grad():
        call(x.clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# fit_lm against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    """One JAX fit and one port fit of the tiny dense model, from the same
    weights on the same corpus and windows."""
    text = chain_text()
    ids = np.asarray(JByteTokenizer()(text)["input_ids"], np.int32)
    assert np.array_equal(ids, ByteTokenizer()(text)["input_ids"])
    jspec = JSpec.tiny()
    jparams = jinit(jspec, jax.random.PRNGKey(0))
    jfit = jfit_lm(jspec, jparams, ids, log_every=0, **FIT)
    spec = ModelSpec.tiny()
    params = params_from_numpy(jparams, device="cpu")
    before = {path: t.clone() for path, t in _flat(params)}
    out = TFIT.fit_lm(spec, params, ids, log_every=0, **FIT)
    return dict(ids=ids, jspec=jspec, jparams=jparams, jfit=jfit, spec=spec, params=params,
                before=before, fit=out)


def test_fit_lm_matches_jax_fit_lm(fitted):
    batches = _windows(fitted["ids"][:2048])
    spec = fitted["spec"]
    ppl = perplexity(spec, fitted["fit"], batches, device="cpu")
    jppl = jperplexity(fitted["jspec"], fitted["jfit"], batches)
    unfitted = perplexity(spec, fitted["params"], batches, device="cpu")
    assert abs(ppl - jppl) <= 1e-2 * jppl, (ppl, jppl)
    assert ppl < unfitted and jppl < unfitted, (ppl, jppl, unfitted)


def test_fit_lm_keeps_dtypes_and_structure(fitted):
    params, out = fitted["params"], fitted["fit"]
    got, orig = dict(_flat(out)), dict(_flat(params))
    assert sorted(got) == sorted(orig)
    for path, t in got.items():
        assert t.dtype == orig[path].dtype and t.shape == orig[path].shape, path
        assert not t.requires_grad, path
        # the input params are left as they were
        assert torch.equal(orig[path], fitted["before"][path]), path
    q, q0 = out["layers"][0]["q_proj"], params["layers"][0]["q_proj"]
    assert type(q) is QuantLinear and q.kind == q0.kind and q.meta == q0.meta
    assert not torch.equal(q.weight, q0.weight)


def test_fit_lm_refuses_a_short_corpus_and_quantized_linears():
    spec = ModelSpec.tiny()
    params = init_params(spec, seed=0, device="cpu")
    with pytest.raises(ValueError, match="corpus too short"):
        TFIT.fit_lm(spec, params, np.arange(33), seq_len=32, steps=1)
    layers = [dict(lyr) for lyr in params["layers"]]
    layers[1]["q_proj"] = _lin("W4A16_G32", n=spec.q_dim, k=64)
    with pytest.raises(ValueError, match="dense params"):
        TFIT.fit_lm(spec, dict(params, layers=layers), np.arange(200) % 100, steps=1)


def test_make_tiny_model_fits_a_corpus(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(chain_text(4000, seed=3))
    common = ["--vocab", "300", "--device", "cpu"]
    assert make_tiny_model.main([str(tmp_path / "raw")] + common) == 0
    assert make_tiny_model.main([str(tmp_path / "fit")] + common + [
        "--fit-corpus", str(corpus), "--fit-steps", "40", "--fit-batch", "4",
        "--fit-seq", "32"]) == 0
    ids = ByteTokenizer()(corpus.read_text())["input_ids"]
    batches = _windows(ids[:2048])
    spec, raw = load_hf_model(tmp_path / "raw", device="cpu")
    _, fit = load_hf_model(tmp_path / "fit", device="cpu")
    assert perplexity(spec, fit, batches, device="cpu") < perplexity(spec, raw, batches,
                                                                     device="cpu")
    jspec, jparams = jload_hf_model(tmp_path / "fit")
    assert jspec.vocab_size == spec.vocab_size == 300
    np.testing.assert_array_equal(np.asarray(jparams["embed"], np.float32),
                                  fit["embed"].float().numpy())
    assert json.loads((tmp_path / "fit" / "config.json").read_text())["num_hidden_layers"] == 2
