"""Port parity for AutoRound (slice 7f) against the JAX package on the CPU.

Inputs are made by numpy from seeds and handed to both packages. The JAX
package's loss and gradient are its ``_autoround_solve`` body written out
with its own ``_round_ste`` (``_jax_loss``), tied to the function itself by
the loss at V = 0 (its ``_autoround_solve`` at ``iters=0``). Tolerances:

* ``wq_of(V)`` equal, bit for bit (the same elementwise f32 operations in
  the same order); the loss at a fixed V within LOSS_RTOL (a mean of f32
  products, summed in another order);
* one step's gradient: the same sign wherever ``|g| > 1e-4 max|g|``, the
  clip's edges included (JAX's ``jnp.clip`` gives 0.5 there, the port 1;
  outside the range both give 0);
* ``autoround_quantize``: scales and zero points within SCALE_RTOL (the
  same min/max formula on the same weights); the best loss at most RTN's
  x 1.001 (JAX's ``test_autoround_beats_rtn``) and within LOSS_RTOL of the
  JAX package's; at most CODE_SHARE of the codes apart (a near-zero
  gradient may take the other sign in another library's f32 sums; none
  differs at these sizes);
* ``oneshot`` on the tiny models, the JAX side's calibration forwards op by
  op (``jax.disable_jit``; its solve stays jitted, because its
  ``fori_loop`` takes a traced counter): the same record keys, layer 0's
  losses within LOSS_RTOL (both packages see the same activations there),
  the codes apart in at most CODE_SHARE of them, the logits within
  LOGIT_RTOL of the JAX package's quantized logits' largest |value|;
* with no calibration batch every site solves on unit rows and warns, in
  both packages: the codes equal.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.core.numerics import compute_scale_zp as jcompute_scale_zp
from quantizers_tpu.core.numerics import minmax_along as jminmax_along
from quantizers_tpu.core.scheme import QuantizationArgs as JArgs
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.oneshot import autoround as JA
from quantizers_tpu.oneshot import make_batches as jmake_batches
from quantizers_tpu.oneshot import oneshot as joneshot
from quantizers_tpu.recipes import parse_recipe as jparse
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core.numerics import dequantize, fake_quantize
from quantizers_tpu_torch.core.scheme import QuantizationArgs
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.oneshot import AutoRoundModifier, autoround_quantize, oneshot
from quantizers_tpu_torch.oneshot import autoround as TA
from quantizers_tpu_torch.recipes import parse_recipe

LOSS_RTOL = 1e-5
SCALE_RTOL = 1e-6
CODE_SHARE = 1e-3
LOGIT_RTOL = 2e-2
IDS = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)

#: JAX's test_autoround_beats_rtn (w3 g16), an asymmetric and a per-channel case
CASES = {
    "beats_rtn_w3g16": ({"num_bits": 3, "type": "int", "symmetric": True, "strategy": "group",
                         "group_size": 16}, 100),
    "asym_w4g16": ({"num_bits": 4, "type": "int", "symmetric": False, "strategy": "group",
                    "group_size": 16}, 100),
    "channel_w4": ({"num_bits": 4, "type": "int", "symmetric": True, "strategy": "channel"},
                   100),
}


def _problem(N=16, K=32, rows=128, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, K)).astype(np.float32),
            rng.normal(size=(rows, K)).astype(np.float32))


def _jax_qparams(W, d):
    args = JArgs.from_dict(d)
    mn, mx = jminmax_along(jnp.asarray(W), args)
    scale, zp = jcompute_scale_zp(mn, mx, args)
    if scale.ndim == 1:
        scale, zp = scale.reshape(-1, 1), zp.reshape(-1, 1)
    return args, scale, (None if args.symmetric else zp)


def _jax_solve(W, X, d, iters, lr=0.05):
    args, scale, zp = _jax_qparams(W, d)
    qmin, qmax = args.qrange
    return JA._autoround_solve(jnp.asarray(W), jnp.asarray(X), scale, zp, iters=iters,
                               group_size=d.get("group_size") or W.shape[1], qmin=float(qmin),
                               qmax=float(qmax), sym=args.symmetric, lr=lr)


def _jax_loss(W, X, d):
    """The JAX package's ``wq_of`` and ``loss_fn`` (``_autoround_solve``'s
    body) for the weights W, rows X and scheme d, with its ``_round_ste``."""
    args, scale, zp = _jax_qparams(W, d)
    K = W.shape[1]
    g = d.get("group_size") or K
    qmin, qmax = args.qrange
    Wj, Xj = jnp.asarray(W), jnp.asarray(X)
    s = jnp.repeat(scale, g, axis=1)[:, :K]

    def wq_of(V):
        x = Wj / s + V
        if zp is not None:
            x = x + jnp.repeat(zp, g, axis=1)[:, :K]
        q = jnp.clip(JA._round_ste(x), qmin, qmax)
        if zp is not None:
            q = q - jnp.repeat(zp, g, axis=1)[:, :K]
        return q * s

    y_ref = Xj @ Wj.T

    def loss_fn(V):
        return jnp.mean((Xj @ wq_of(V).T - y_ref) ** 2)

    return wq_of, loss_fn


def _port_problem(W, X, d):
    args = QuantizationArgs.from_dict(d)
    scale, zp, g = TA._qparams(torch.from_numpy(W), args)
    qmin, qmax = args.qrange
    return TA._Problem(torch.from_numpy(W), torch.from_numpy(X), scale, zp, g, float(qmin),
                       float(qmax))


def _edge_v(W, d, seed=3):
    """A V in [-0.5, 0.5] with many rounded values on the clip's edges and
    some beyond: random, for every weight within reach the offset that puts
    ``W / s + V`` (+ zp) on qmax or qmin exactly, and 0.5 where that lands
    above qmax."""
    p = _port_problem(W, W[:1], d)
    x0 = p.grid(torch.zeros_like(p.W)).numpy()
    rng = np.random.default_rng(seed)
    V = rng.uniform(-0.5, 0.5, size=W.shape).astype(np.float32)
    edge = np.where(x0 > 0, p.qmax, p.qmin).astype(np.float32)
    pick = np.abs(edge - x0) <= 0.5
    V[pick] = (edge - x0)[pick]
    V[x0 >= p.qmax] = 0.5
    return V


@pytest.mark.parametrize("case", sorted(CASES))
def test_wq_and_loss_match_jax(case):
    d, _ = CASES[case]
    W, X = _problem()
    wq_of, loss_fn = _jax_loss(W, X, d)
    # the transcription is the JAX package's function: its loss at V = 0
    _, l0 = _jax_solve(W, X, d, iters=0)
    assert float(loss_fn(jnp.zeros(W.shape, jnp.float32))) == pytest.approx(float(l0), rel=1e-6)
    p = _port_problem(W, X, d)
    V = np.random.default_rng(1).uniform(-0.5, 0.5, size=W.shape).astype(np.float32)
    np.testing.assert_array_equal(p.wq(torch.from_numpy(V)).numpy(),
                                  np.asarray(wq_of(jnp.asarray(V))))
    want = float(loss_fn(jnp.asarray(V)))
    assert float(p.loss(torch.from_numpy(V))) == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_sign_matches_jax_at_the_clip_edges(case):
    d, _ = CASES[case]
    W, X = _problem()
    _, loss_fn = _jax_loss(W, X, d)
    V = _edge_v(W, d)
    jl, jg = jax.value_and_grad(loss_fn)(jnp.asarray(V))
    jg = np.asarray(jg)
    p = _port_problem(W, X, d)
    loss, g = p.loss_and_grad(torch.from_numpy(V))
    g = g.numpy()
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    r = np.round(p.grid(torch.from_numpy(V)).numpy())
    on_edge = (r == p.qmin) | (r == p.qmax)
    outside = (r < p.qmin) | (r > p.qmax)
    assert on_edge.sum() >= 8 and outside.any()
    big = np.abs(jg) > 1e-4 * np.abs(jg).max()
    assert (big & on_edge).sum() > 0
    np.testing.assert_array_equal(np.sign(g[big]), np.sign(jg[big]))
    # the zero outside the range, a nonzero value at its edges
    assert not g[outside].any() and not jg[outside].any()
    assert (g[big & on_edge] != 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_autoround_quantize_matches_jax(case):
    """JAX's test_autoround_beats_rtn problem (and its asymmetric and
    per-channel twins): the port beats RTN as the JAX package does, with its
    scales, its best loss and its codes."""
    d, iters = CASES[case]
    W, X = _problem()
    args = QuantizationArgs.from_dict(d)
    qt = autoround_quantize(torch.from_numpy(W), X, args, iters=iters)
    jq, jloss = _jax_solve(W, X, d, iters)
    _, jscale, jzp = _jax_qparams(W, d)
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(jscale), rtol=SCALE_RTOL)
    if jzp is None:
        assert qt.zero_point is None
    else:
        np.testing.assert_allclose(qt.zero_point.numpy(), np.asarray(jzp), rtol=SCALE_RTOL)
    assert qt.values.dtype == torch.int8
    assert float((qt.values.numpy() != np.asarray(jq)).mean()) <= CODE_SHARE
    p = _port_problem(W, X, d)
    V = torch.zeros_like(p.W)
    _, best, first = TA._autoround_solve(p.W, p.X, *TA._qparams(p.W, args)[:2], iters=iters,
                                         group_size=d.get("group_size") or W.shape[1],
                                         qmin=p.qmin, qmax=p.qmax, lr=0.05)
    assert float(best) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(best) <= float(first) == float(p.loss(V))
    # the codes' loss: at most RTN's (round half away, fake_quantize) x 1.001
    Wt, Xt = torch.from_numpy(W), torch.from_numpy(X)
    w_ar = dequantize(qt, args)
    err_ar = float(torch.mean((Xt @ w_ar.t() - Xt @ Wt.t()) ** 2))
    err_rtn = float(torch.mean((Xt @ fake_quantize(Wt, args).t() - Xt @ Wt.t()) ** 2))
    assert err_ar <= err_rtn * 1.001, (err_ar, err_rtn)


@pytest.mark.parametrize("lr", [0.05, 0.005])
def test_trajectory_matches_jax_when_it_leaves_rtn(lr):
    """At the recipe's lr (0.05) the best V of these problems is V = 0; at
    0.005 the solve improves on RTN, and the two packages' trajectories
    still end on the same loss and codes."""
    d = {"num_bits": 4, "type": "int", "symmetric": True, "strategy": "group", "group_size": 32}
    W, X = _problem(N=64, K=256, rows=512, seed=11)
    jq, jloss = _jax_solve(W, X, d, 200, lr=lr)
    args = QuantizationArgs.from_dict(d)
    scale, zp, g = TA._qparams(torch.from_numpy(W), args)
    q, best, first = TA._autoround_solve(torch.from_numpy(W), torch.from_numpy(X), scale, zp,
                                         iters=200, group_size=g, qmin=-8.0, qmax=7.0, lr=lr)
    assert float(best) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float((q.numpy() != np.asarray(jq)).mean()) <= CODE_SHARE
    assert (float(best) < float(first)) == (lr < 0.05)


def test_step_sizes_are_the_jax_f32_numbers():
    steps = TA._steps(200, 0.05)
    want = [np.float32(0.05) * (np.float32(1.0) - np.float32(i) / np.float32(200))
            for i in range(200)]
    assert steps.dtype == np.float32
    np.testing.assert_array_equal(steps, np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the modifier through oneshot
# ---------------------------------------------------------------------------

W4G32 = {"targets": ["Linear"], "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                                            "strategy": "group", "group_size": 32}}


def _recipe(parse, iters=8):
    return parse({"quant_stage": {"quant_modifiers": {"AutoRoundModifier": {
        "iters": iters, "ignore": ["lm_head"], "config_groups": {"group_0": W4G32}}}}})


def _batches(vocab, n=4, T=16):
    rng = np.random.default_rng(0)
    samples = [list(rng.integers(1, vocab, size=rng.integers(T // 2, T))) for _ in range(n)]
    return jmake_batches(samples, max_seq_length=T, batch_size=2, pad_to_multiple=8)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw, seed in (("dense", {}, 0), ("moe", {"moe": True}, 1)):
        jspec = JSpec.tiny(**kw)
        out[name] = (jspec, jinit(jspec, jax.random.PRNGKey(seed)), ModelSpec.tiny(**kw))
    return out


@pytest.fixture
def solves(monkeypatch):
    """Every solve's best loss and row count, in order, of each package; the
    JAX package's jitted even under ``jax.disable_jit``."""
    log_ = {"jax": [], "port": []}
    jorig, torig = JA._autoround_solve, TA._autoround_solve

    def jsolve(W, X, *a, **kw):
        with jax.disable_jit(False):
            q, loss = jorig(W, X, *a, **kw)
        log_["jax"].append((float(loss), X.shape[0]))
        return q, loss

    def tsolve(W, X, *a, **kw):
        q, loss, first = torig(W, X, *a, **kw)
        log_["port"].append((float(loss), X.shape[0]))
        return q, loss, first
    monkeypatch.setattr(JA, "_autoround_solve", jsolve)
    monkeypatch.setattr(TA, "_autoround_solve", tsolve)
    return log_


def _clone(params):
    return jax.tree_util.tree_map(lambda x: x, params)


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_autoround_oneshot_matches_jax(model, models, solves):
    """The port of JAX's test_autoround_oneshot_runs, held against the JAX
    package: the records, layer 0's losses, the codes, the logits."""
    jspec, jparams, spec = models[model]
    batches = _batches(jspec.vocab_size)
    with jax.disable_jit():
        jres = joneshot(jspec, _clone(jparams), _recipe(jparse), batches)
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"), _recipe(parse_recipe),
                  batches, device="cpu")
    assert sorted(res.records) == sorted(jres.records)
    # the dense model's 7 linears a layer; the MoE's 4 attention linears,
    # its router and 3 per expert
    n_sites = 7 if model == "dense" else 5 + 3 * spec.num_experts
    assert len(res.records) == spec.num_layers * n_sites
    assert len(solves["port"]) == len(solves["jax"]) == len(res.records)
    for (got, rows), (want, jrows) in zip(solves["port"][:n_sites], solves["jax"][:n_sites]):
        assert rows == jrows and got == pytest.approx(want, rel=LOSS_RTOL)
    apart = sum(int((cp.qt.values.numpy() != np.asarray(jres.records[k].qt.values)).sum())
                for k, cp in res.records.items())
    cells = sum(cp.qt.values.numel() for cp in res.records.values())
    assert apart <= CODE_SHARE * cells, (apart, cells)
    out = forward(res.params, spec, torch.as_tensor(IDS).long())[0].float().numpy()
    want = np.asarray(jforward(jres.params, jspec, jnp.asarray(IDS))[0], np.float32)
    assert np.abs(out - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_unit_rows_when_a_site_saw_nothing(models, solves, caplog):
    """No calibration batch: every site solves on one row of ones and warns,
    in both packages, with the same codes."""
    jspec, jparams, spec = models["dense"]
    jres = joneshot(jspec, _clone(jparams), _recipe(jparse), [])
    with caplog.at_level(logging.WARNING, logger=TA.__name__):
        res = oneshot(spec, params_from_numpy(jparams, device="cpu"), _recipe(parse_recipe), [],
                      device="cpu")
    warned = [r.getMessage() for r in caplog.records
              if r.name == TA.__name__ and "using unit rows" in r.getMessage()]
    assert len(warned) == len(res.records) == spec.num_layers * 7
    assert all(rows == 1 for _, rows in solves["port"] + solves["jax"])
    for k, cp in res.records.items():
        np.testing.assert_array_equal(cp.qt.values.numpy(), np.asarray(jres.records[k].qt.values),
                                      err_msg=k)


def test_modifier_keeps_at_most_max_rows_of_valid_tokens(models):
    """The row budget counts valid rows: padded rows never enter it, and no
    site keeps more than MAX_ROWS."""
    from quantizers_tpu_torch.oneshot.modifiers import LayerCtx
    from quantizers_tpu_torch.oneshot.sites import layer_sites

    _, jparams, spec = models["dense"]
    params = params_from_numpy(jparams, device="cpu")
    layer = params["layers"][0]
    sites = layer_sites(spec, 0, layer)
    mod = AutoRoundModifier(_recipe(parse_recipe).modifiers[0])
    state = mod.begin_layer(LayerCtx(spec=spec, layer_idx=0, layer=layer, sites=sites), [])
    site = sites[0]
    x = torch.randn(2, 700, site.get().weight.shape[0])
    mask = torch.zeros(2, 700)
    mask[0, :650] = 1.0
    mask[1, :500] = 1.0
    mod.observe(state, site, x, mask, {"_valid_rows": 1150})
    assert state["rows"][site.prefix] == 1024
    mod.observe(state, site, x, mask, {"_valid_rows": 1150})
    assert state["rows"][site.prefix] == TA.MAX_ROWS
    rows = mod._rows_for(state, site.prefix, site.get().weight.shape[0], torch.device("cpu"))
    assert rows.shape == (TA.MAX_ROWS, site.get().weight.shape[0])
    valid = torch.cat([x[0, :650], x[1, :500]])
    assert all(any(torch.equal(r, v) for v in valid) for r in rows[::97])
