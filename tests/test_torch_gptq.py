"""Port parity for GPTQ (slice 7d) against the JAX package on the CPU.

Inputs are made by numpy from seeds and handed to both packages. On the
CPU the port's elimination takes K11's plain version
(``ops/kernels.py:gptq_block_plain``); the card tests
(``tests/test_torch_cuda.py``, marker ``cuda``) hold K11 against it bit for
bit. Tolerances:

* the solve, given the same factor U (the JAX package's ``_ufactor``
  output handed to both): codes equal, bit for bit (each column's
  operations are the JAX loop's, each rounded once; the tail product sums
  in another order but lands on the same codes at these sizes);
* the factors: ``_ufactor`` and ``_ufactor_host`` within 1e-5 of the
  largest |U| of the JAX package's (f64 LAPACK, rounded to f32, against
  XLA's f32 blocked solve: a few ulps), and ``_ufactor`` within one ulp of
  ``_ufactor_host`` (both f64, so every device's U is the same);
* ``gptq_quantize`` end to end: codes within one step of the JAX package's
  (the two packages' factors differ by ulps, and an ulp can move a code
  sitting on a rounding tie, which GPTQ then carries along its row), the
  objective tr((W - W^) H (W - W^)^T) within 1e-3 relative, the scales
  and zero points within 1e-6 relative (the same min/max formula on the
  same weights, bit for bit where no code moved), ``g_idx`` equal;
* oneshot on the tiny models, the JAX side op by op (``jax.disable_jit``:
  jitted XLA keeps some bf16 intermediates of the calibration forwards in
  f32, so its activations past the first attention differ from the eager
  ones by a bf16 ulp, which moves GPTQ's codes by up to 6 steps here):
  ``g_idx`` equal; layer 0's codes equal; a later layer's apart in at most
  CODE_SHARE of them (the tiny MoE's expert combine sums in another order,
  so layer 1's inputs may differ by a bf16 ulp, and GPTQ carries a moved
  code along its row: 104 of 36,864 codes, up to 2 steps, with the
  symmetric g32 recipe; the dense model's codes are all equal); the logits
  within 2e-2 of the JAX package's quantized logits' largest |value|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.core.numerics import dequantize as jdequantize
from quantizers_tpu.core.numerics import fake_quantize as jfake_quantize
from quantizers_tpu.core.scheme import QuantizationArgs as JArgs
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.oneshot import gptq as JG
from quantizers_tpu.oneshot import make_batches as jmake_batches
from quantizers_tpu.oneshot import oneshot as joneshot
from quantizers_tpu.oneshot.engine import _capture_alias_map as jalias_map
from quantizers_tpu.oneshot.engine import _capture_jit as jcapture
from quantizers_tpu.oneshot.modifiers import LayerCtx as JLayerCtx
from quantizers_tpu.oneshot.sites import layer_sites as jlayer_sites
from quantizers_tpu.ops.linear import from_quantized as jfrom_quantized
from quantizers_tpu.recipes import parse_recipe as jparse
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core.numerics import dequantize, fake_quantize
from quantizers_tpu_torch.core.scheme import QuantizationArgs
from quantizers_tpu_torch.formats.checkpoint import CompressedModelReader, save_compressed_model
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.models.loader import iter_model_linears, model_plain_tensors
from quantizers_tpu_torch.oneshot import GPTQModifier, gptq_quantize, oneshot
from quantizers_tpu_torch.oneshot import gptq as TG
from quantizers_tpu_torch.oneshot.engine import _capture_alias_map, _capture_layer
from quantizers_tpu_torch.oneshot.modifiers import LayerCtx
from quantizers_tpu_torch.oneshot.sites import layer_sites
from quantizers_tpu_torch.ops import kernels as K
from quantizers_tpu_torch.ops.linear import from_quantized
from quantizers_tpu_torch.recipes import parse_recipe
from test_torch_cuda import GPTQ_EDGES, gptq_edge_block

U_ATOL = 1e-5  # of the largest |U|
OBJ_RTOL = 1e-3
SCALE_RTOL = 1e-6
LOGIT_RTOL = 2e-2
#: oneshot on the tiny models: the share of codes that may lie one step apart
CODE_SHARE = 2e-2
W4G32 = {"targets": ["Linear"], "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                                            "strategy": "group", "group_size": 32}}
IDS = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)


def _args(sym=True, g=32, actorder=None, bits=4):
    d = {"num_bits": bits, "type": "int", "symmetric": sym,
         "strategy": "group" if g else "channel", "group_size": g, "actorder": actorder}
    return JArgs.from_dict(d), QuantizationArgs.from_dict(d)


def _problem(K_, N, seed, rows=512, loud_every=3):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(N, K_)).astype(np.float32)
    X = rng.normal(size=(rows, K_)).astype(np.float32)
    X[:, ::loud_every] *= 10.0
    return W, X, (2.0 * X.T @ X).astype(np.float32)


def _recipe(parse, modifier="GPTQModifier", weights=None, extra=None, ignore=("lm_head",)):
    group = dict(W4G32) if weights is None else {"targets": ["Linear"], "weights": weights}
    body = {"config_groups": {"group_0": group}, "ignore": list(ignore), **(extra or {})}
    return parse({"quant_stage": {"quant_modifiers": {modifier: body}}})


def _batches(vocab, n=4, T=16):
    rng = np.random.default_rng(0)
    samples = [list(rng.integers(1, vocab, size=rng.integers(T // 2, T))) for _ in range(n)]
    return jmake_batches(samples, max_seq_length=T, batch_size=2, pad_to_multiple=8)


def _clone(params):
    return jax.tree_util.tree_map(lambda x: x, params)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _dequant(values, scale, zp, g, g_idx=None):
    """(N, K) weights of integer codes with per-group scales, the group of
    column j being g_idx[j] (None: j // g): what GPTQ solved."""
    values, scale = np.asarray(values, np.float64), np.asarray(scale, np.float64)
    cols = np.arange(values.shape[1]) // g if g_idx is None else np.asarray(g_idx)
    q = values - (0.0 if zp is None else np.asarray(zp, np.float64)[:, cols])
    return q * scale[:, cols]


def _objective(W, What, H):
    D = np.asarray(W, np.float64) - What
    return float(np.trace(D @ np.asarray(H, np.float64) @ D.T))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw, seed in (("dense", {}, 0), ("moe", {"moe": True}, 1)):
        jspec = JSpec.tiny(**kw)
        out[name] = (jspec, jinit(jspec, jax.random.PRNGKey(seed)), ModelSpec.tiny(**kw))
    return out


# ---------------------------------------------------------------------------
# the solve, the factors, gptq_quantize
# ---------------------------------------------------------------------------

def _solve_inputs(K_, sym, g, actorder, N=16, block_size=128):
    """The elimination's inputs as the JAX package's gptq_quantize builds
    them (its _ufactor and _solve_qparams), padded to a block multiple."""
    W, _, H = _problem(K_, N, seed=K_ + 7 * (g or 1))
    jargs, _ = _args(sym, g, actorder)
    perm = None
    if actorder:
        perm = np.argsort(-np.diag(H), kind="stable")
        Wp, Hp = W[:, perm], H[perm][:, perm]
    else:
        Wp, Hp = W, H
    U = np.asarray(JG._ufactor(jnp.asarray(Hp), jnp.float32(0.01)))
    gs = g or K_
    if actorder == "weight":
        scale, zp, _ = JG._solve_qparams(jnp.asarray(W), jargs)
        cg = perm // gs
    else:
        scale, zp, _ = JG._solve_qparams(jnp.asarray(Wp), jargs)
        cg = np.arange(K_) // gs
    scale, zp = np.asarray(scale), np.asarray(zp)
    bs = min(block_size, K_)
    pad = (-K_) % bs
    n_groups = scale.shape[1]
    if pad:
        Wp = np.pad(Wp, ((0, 0), (0, pad)))
        U = np.pad(U, ((0, pad), (0, pad)))
        U[np.arange(K_, K_ + pad), np.arange(K_, K_ + pad)] = 1.0
        scale = np.pad(scale, ((0, 0), (0, 1)), constant_values=1.0)
        zp = np.pad(zp, ((0, 0), (0, 1)))
        cg = np.concatenate([cg, np.full((pad,), n_groups)])
    qmin, qmax = jargs.qrange
    return dict(W=Wp, U=U, scale=scale, zp=zp, cg=cg.astype(np.int32),
                kw=dict(block_size=bs, qmin=float(qmin), qmax=float(qmax), sym=sym))


@pytest.mark.parametrize("actorder", [None, "group", "weight"])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("K_", [64, 256, 300])
def test_solve_matches_jax_given_the_same_factor(K_, sym, g, actorder):
    a = _solve_inputs(K_, sym, g, actorder)
    want = np.asarray(JG._gptq_solve(jnp.asarray(a["W"]), jnp.asarray(a["U"]),
                                     jnp.asarray(a["scale"]), jnp.asarray(a["zp"]),
                                     jnp.asarray(a["cg"]), **a["kw"]))
    t = {k: torch.from_numpy(a[k]) for k in ("W", "U", "scale", "zp", "cg")}
    plain = TG.gptq_solve_plain(t["W"], t["U"], t["scale"], t["zp"], t["cg"], **a["kw"])
    routed = TG._gptq_solve(t["W"], t["U"], t["scale"], t["zp"], t["cg"], **a["kw"])
    np.testing.assert_array_equal(plain.numpy(), want)
    assert torch.equal(routed, plain)
    assert K.gptq_block.launches == 0  # the CPU never launches


@pytest.mark.parametrize("case", ["jax_qparams", *GPTQ_EDGES])
def test_block_plain_is_the_jax_column_loop(case):
    """One block by hand: the plain version's column loop against the
    formula of the JAX package's col_step, written out in float32 numpy, on
    the block of a JAX-made solve (``jax_qparams``) and on each input that
    the card tests hold K11 to (``tests/test_torch_cuda.py:GPTQ_EDGES``:
    row counts, 128 groups in a block, zero points, narrow blocks, NaN,
    infinities and a zero scale)."""
    if case == "jax_qparams":
        a = _solve_inputs(64, False, 32, None)
        W, U, s, z, cg = (a[k] for k in ("W", "U", "scale", "zp", "cg"))
        qmin, qmax = -8.0, 7.0
    else:
        W, U, s, z, cg, qmin, qmax = gptq_edge_block(case)
    q, err = K.gptq_block_plain(torch.from_numpy(W), torch.from_numpy(U), torch.from_numpy(s),
                                None if z is None else torch.from_numpy(z),
                                torch.from_numpy(cg), qmin, qmax)
    w = W.copy()
    with np.errstate(all="ignore"):  # the zero scale and the infinities
        for i in range(W.shape[1]):
            g = cg[i]
            zf = None if z is None else z[:, g].astype(np.float32)
            x = w[:, i] / s[:, g]
            if zf is not None:
                x = x + zf
            qi = np.clip(np.round(x), np.float32(qmin), np.float32(qmax)).astype(np.float32)
            e = (w[:, i] - (qi if zf is None else qi - zf) * s[:, g]) / U[i, i]
            w[:, i + 1:] -= e[:, None] * U[i, i + 1:][None, :]
            np.testing.assert_array_equal(q[:, i].numpy(), qi)
            np.testing.assert_array_equal(err[:, i].numpy(), e)


@pytest.mark.parametrize("n", [1, 3])
def test_block_plain_leaves_its_input_alone(n):
    """The plain version works on a copy of W: with one row, W's transpose
    is contiguous, and ``.t().contiguous()`` would hand back a view that the
    elimination then writes into."""
    W, U, s, z, cg, qmin, qmax = gptq_edge_block("n1")
    W = np.repeat(W, n, axis=0)
    w = torch.from_numpy(W.copy())
    K.gptq_block_plain(w, torch.from_numpy(U), torch.from_numpy(np.repeat(s, n, axis=0)), None,
                       torch.from_numpy(cg), qmin, qmax)
    np.testing.assert_array_equal(w.numpy(), W)


def test_block_refuses_what_the_kernel_does_not_take():
    w = torch.zeros((4, 130))
    with pytest.raises(K.KernelUnsupported, match="128"):
        K.gptq_block(w, torch.eye(130), torch.ones((4, 5)), None, torch.zeros(130, dtype=torch.int32),
                     -8.0, 7.0)


@pytest.mark.parametrize("K_", [64, 300])
def test_ufactor_matches_jax(K_):
    _, _, H = _problem(K_, 4, seed=K_)
    want = np.asarray(JG._ufactor(jnp.asarray(H), jnp.float32(0.01)))
    want_host = JG._ufactor_host(H, 0.01)
    got = TG._ufactor(torch.from_numpy(H), 0.01)
    got_host = TG._ufactor_host(H, 0.01)
    assert got.dtype == torch.float32 and got_host.dtype == np.float32
    top = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= U_ATOL * top
    assert np.abs(got_host - want_host).max() <= U_ATOL * top
    assert np.abs(got_host - want).max() <= U_ATOL * top
    # upper-triangular, and H_damped^-1 = U^T U
    assert np.array_equal(np.triu(got.numpy()), got.numpy())


@pytest.mark.parametrize("K_", [64, 300])
def test_ufactor_is_the_f64_factor_rounded_to_f32(K_):
    """``_ufactor`` takes the factor in f64 and rounds it to f32, so that
    every device's U is the same: against the host's f64 LAPACK factor, at
    most 0.1% of the entries apart and none by more than one f32 ulp of the
    largest |U|. An f32 factor differs from it in most entries (84-91% here),
    and GPTQ carries such a difference into codes several steps apart."""
    _, _, H = _problem(K_, 4, seed=K_)
    got = TG._ufactor(torch.from_numpy(H), 0.01).numpy()
    want = TG._ufactor_host(H, 0.01)
    assert (got != want).mean() <= 1e-3
    assert np.abs(got - want).max() <= np.spacing(np.abs(want).max())


def test_ufactor_not_positive_definite_gives_the_identity_like_jax():
    H = -np.eye(16, dtype=np.float32)
    H[3, 5] = H[5, 3] = 0.5
    want = np.asarray(JG._ufactor(jnp.asarray(H), jnp.float32(0.01)))
    np.testing.assert_array_equal(want, np.eye(16, dtype=np.float32))
    np.testing.assert_array_equal(TG._ufactor(torch.from_numpy(H), 0.01).numpy(), want)
    np.testing.assert_array_equal(TG._ufactor_host(H, 0.01), JG._ufactor_host(H, 0.01))


CASES = {"sym_g32": (64, True, 32, None), "asym_g128_group": (256, False, 128, "group"),
         "sym_g32_weight": (300, True, 32, "weight"), "asym_g32_group": (300, False, 32, "group"),
         "sym_channel": (128, True, None, None), "asym_g32_dead": (96, False, 32, "group")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gptq_quantize_matches_jax(case):
    K_, sym, g, actorder = CASES[case]
    W, _, H = _problem(K_, 24, seed=len(case))
    if case.endswith("dead"):
        H[:, 7] = H[7, :] = 0.0  # no activation mass: the column is zeroed
    jargs, targs = _args(sym, g, actorder)
    jqt, jg = JG.gptq_quantize(jnp.asarray(W), jnp.asarray(H), jargs, block_size=128)
    qt, g_idx = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs, block_size=128)
    jv, tv = np.asarray(jqt.values).astype(int), qt.values.numpy().astype(int)
    assert qt.values.dtype == torch.int8 and tv.shape == jv.shape == (24, K_)
    assert np.abs(jv - tv).max() <= 1
    for a, b in ((qt.scale, jqt.scale), (qt.zero_point, jqt.zero_point)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(_np(a), _np(b), rtol=SCALE_RTOL)
    assert (g_idx is None) == (jg is None) == (actorder != "group")
    if jg is not None:
        assert g_idx.dtype == torch.int32 and g_idx.device.type == "cpu"
        np.testing.assert_array_equal(g_idx.numpy(), jg)
    gs = g or K_
    zp = None if sym else _np(qt.zero_point)
    got = _objective(W, _dequant(tv, _np(qt.scale), zp, gs, g_idx), H)
    want = _objective(W, _dequant(jv, np.asarray(jqt.scale), None if sym else
                                  np.asarray(jqt.zero_point), gs, jg), H)
    assert abs(got - want) <= OBJ_RTOL * want, (got, want)
    if case.endswith("dead"):  # a zeroed column nothing propagates into: code 0, or zp
        grp = 7 // gs if g_idx is None else int(g_idx[7])
        np.testing.assert_array_equal(tv[:, 7], 0 if sym else _np(qt.zero_point)[:, grp])


def test_factor_cache_and_forced_host_path(monkeypatch):
    W, _, H = _problem(64, 8, seed=3)
    _, targs = _args()
    cache = {}
    qt, _ = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs, ufactor_cache=cache,
                          cache_key=("site", None))
    assert list(cache) == [(("site", None), targs.actorder, 0.01)]
    _, _, H2 = _problem(64, 8, seed=13)  # another Hessian under the same key
    again, _ = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H2), targs,
                             ufactor_cache=cache, cache_key=("site", None))
    other, _ = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H2), targs)
    assert torch.equal(again.values, qt.values)  # the cached factor, not H2's
    assert not torch.equal(other.values, qt.values)
    monkeypatch.setenv("QTPU_GPTQ_FACTOR", "host")
    host, _ = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs)
    assert np.abs(host.values.numpy().astype(int) - qt.values.numpy().astype(int)).max() <= 1


def test_failed_device_factor_falls_back_to_the_host_and_caches_nothing(monkeypatch):
    W, _, H = _problem(64, 8, seed=4)
    _, targs = _args()
    want, _ = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs)

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(torch.linalg, "cholesky_ex", boom)
    before, cache = TG.host_factor_fallbacks, {}
    got, _ = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs, ufactor_cache=cache,
                           cache_key=("site", None))
    assert TG.host_factor_fallbacks == before + 1 and cache == {}
    assert np.abs(got.values.numpy().astype(int) - want.values.numpy().astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# the JAX package's own GPTQ cases (tests/test_oneshot.py), on both packages
# ---------------------------------------------------------------------------

def test_gptq_beats_rtn_in_hessian_metric():
    rng = np.random.default_rng(5)
    K_, N, rows = 64, 16, 512
    W = rng.normal(size=(N, K_)).astype(np.float32)
    X = rng.normal(size=(rows, K_)).astype(np.float32)
    X[:, : K_ // 4] *= 8.0  # anisotropic inputs
    H = 2.0 * X.T @ X
    jargs, targs = _args()
    y_ref = X @ W.T
    jqt, jg = JG.gptq_quantize(jnp.asarray(W), jnp.asarray(H), jargs, block_size=32)
    qt, g_idx = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs, block_size=32)
    assert g_idx is None and jg is None
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(jqt.values))
    for w_q, w_rtn in ((dequantize(qt, targs).numpy(), fake_quantize(torch.from_numpy(W), targs)),
                       (np.asarray(jdequantize(jqt, jargs)), jfake_quantize(jnp.asarray(W), jargs))):
        err_gptq = float(np.mean((X @ w_q.T - y_ref) ** 2))
        err_rtn = float(np.mean((X @ np.asarray(w_rtn).T - y_ref) ** 2))
        assert err_gptq < err_rtn, (err_gptq, err_rtn)


def test_gptq_actorder_group_emits_gidx():
    rng = np.random.default_rng(6)
    K_, N = 64, 8
    W = rng.normal(size=(N, K_)).astype(np.float32)
    X = rng.normal(size=(128, K_)).astype(np.float32)
    X[:, ::3] *= 10
    H = 2.0 * X.T @ X
    jargs, targs = _args(g=16, actorder="group")
    qt, g_idx = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs, block_size=32)
    _, jg = JG.gptq_quantize(jnp.asarray(W), jnp.asarray(H), jargs, block_size=32)
    assert g_idx is not None and g_idx.shape == (K_,)
    vals, counts = np.unique(g_idx.numpy(), return_counts=True)
    assert list(vals) == list(range(K_ // 16)) and all(c == 16 for c in counts)
    np.testing.assert_array_equal(g_idx.numpy(), jg)


def _codes_close(res, jres, share=CODE_SHARE):
    """The port's records against the JAX package's: the keys and g_idx
    equal; layer 0's codes equal (both packages see the same activations
    there); a later layer's apart in at most ``share`` of them."""
    assert sorted(res.records) == sorted(jres.records) and res.records
    by_layer = {}
    for key, cp in res.records.items():
        jcp = jres.records[key]
        d = np.abs(cp.qt.values.numpy().astype(int) - np.asarray(jcp.qt.values).astype(int))
        layer = int(key.split(".")[2])
        assert layer > 0 or d.max() == 0, key
        cells, apart = by_layer.get(layer, (0, 0))
        by_layer[layer] = (cells + d.size, apart + int((d > 0).sum()))
        assert (cp.g_idx is None) == (jcp.g_idx is None), key
        if cp.g_idx is not None:
            np.testing.assert_array_equal(cp.g_idx.numpy(), jcp.g_idx, err_msg=key)
    for layer, (cells, apart) in by_layer.items():
        assert apart <= share * cells, (layer, apart, cells)


def _rel_to_bf16(spec, params, ref):
    out = forward(params, spec, torch.as_tensor(IDS).long())[0].float().numpy()
    return np.abs(ref - out).mean() / (np.abs(ref).mean() + 1e-9), out


@pytest.mark.parametrize("offload", ["device", "host"])
def test_gptq_oneshot_runs(offload, models):
    jspec, jparams, spec = models["dense"]
    ref = np.asarray(jforward(jparams, jspec, jnp.asarray(IDS))[0], np.float32)
    batches = _batches(jspec.vocab_size)
    with jax.disable_jit():
        jres = joneshot(jspec, _clone(jparams), _recipe(jparse), batches)
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"), _recipe(parse_recipe), batches,
                  offload=offload, device="cpu")
    assert len(res.records) == spec.num_layers * 7
    _codes_close(res, jres)
    rel, out = _rel_to_bf16(spec, res.params, ref)
    assert rel < 0.3
    want = np.asarray(jforward(jres.params, jspec, jnp.asarray(IDS))[0], np.float32)
    assert np.abs(out - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_gptq_repo_recipe_records_g_idx_and_writes_it(models, tmp_path):
    """The repository's GPTQ recipe (W4A16 g128 asymmetric, actorder group)
    on the tiny dense model: each record's g_idx equals the JAX package's
    and reaches the checkpoint as ``weight_g_idx``."""
    jspec, jparams, spec = models["dense"]
    weights = {"num_bits": 4, "type": "int", "symmetric": False, "strategy": "group",
               "group_size": 32, "actorder": "group"}
    batches = _batches(jspec.vocab_size)
    with jax.disable_jit():
        jres = joneshot(jspec, _clone(jparams), _recipe(jparse, weights=weights), batches)
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"),
                  _recipe(parse_recipe, weights=weights), batches, device="cpu")
    _codes_close(res, jres)
    assert all(cp.g_idx is not None for cp in res.records.values())
    plain = model_plain_tensors(spec, res.params)
    for prefix, lin in iter_model_linears(spec, res.params):
        if prefix not in res.records:
            plain[f"{prefix}.weight"] = lin.dequantize(torch.float32).t()
    save_compressed_model(tmp_path, plain, res.records, config_groups=res.config_groups,
                          ignore=res.ignore, base_config=spec.to_hf_config())
    with CompressedModelReader(tmp_path) as r:
        for key, cp in res.records.items():
            np.testing.assert_array_equal(r.g_idx(key).numpy(), cp.g_idx.numpy(), err_msg=key)


def test_gptq_hessian_shared_across_same_input_sites(models):
    jspec, jparams, spec = models["dense"]
    layer = params_from_numpy(jparams, device="cpu")["layers"][0]
    sites = {s.name: s for s in layer_sites(spec, 0, layer)}
    mspec = _recipe(parse_recipe).modifiers[0]
    scheme = next(iter(mspec.config_groups.values()))
    mod = GPTQModifier(mspec)
    ctx = LayerCtx(spec=spec, layer_idx=0, layer=layer, sites=list(sites.values()))
    names = ("q_proj", "k_proj", "v_proj")
    state = mod.begin_layer(ctx, [(sites[n], "group_0", scheme) for n in names])
    x_np = np.random.default_rng(0).normal(size=(2, 4, spec.hidden_size)).astype(np.float32)
    # the JAX package on the same inputs
    jlayer = _clone(jparams)["layers"][0]
    jsites = {s.name: s for s in jlayer_sites(jspec, 0, jlayer)}
    jmspec = _recipe(jparse).modifiers[0]
    jmod = JG.GPTQModifier(jmspec)
    jstate = jmod.begin_layer(JLayerCtx(spec=jspec, layer_idx=0, layer=jlayer,
                                        sites=list(jsites.values())),
                              [(jsites[n], "group_0", next(iter(jmspec.config_groups.values())))
                               for n in names])
    x2 = x_np.astype(np.float64).reshape(-1, spec.hidden_size)
    want = 2.0 * x2.T @ x2
    for bi, xb in enumerate((x_np, x_np + 1.0)):
        x, jx = torch.from_numpy(xb), jnp.asarray(xb)
        for n in names:
            mod.observe(state, sites[n], x, None, {"_batch_idx": bi})
            jmod.observe(jstate, jsites[n], jx, None, {"_batch_idx": bi})
        # ONE Hessian accumulated; the others alias to it
        assert len(state["H"]) == 1
        canon = next(iter(state["H"]))
        assert all(state["alias"][sites[n].prefix] == canon for n in names)
        if bi:
            x2b = (xb.astype(np.float64)).reshape(-1, spec.hidden_size)
            want = want + 2.0 * x2b.T @ x2b
        np.testing.assert_allclose(state["H"][canon].numpy(), want, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(state["H"][canon].numpy(), np.asarray(jstate["H"][canon]),
                                   rtol=1e-5, atol=1e-4)


def test_gptq_moe_expert_hessians(models):
    """GPTQ on a MoE model: gate/up expert sites capture the SHARED 2-D
    pre-routing hidden (one Hessian, exact for every expert), down_proj
    gets stacked per-expert (E, C, C) Hessians with padding rows masked."""
    jspec, jparams, spec = models["moe"]
    ref = np.asarray(jforward(jparams, jspec, jnp.asarray(IDS))[0], np.float32)
    batches = _batches(jspec.vocab_size)
    recipe = {"ignore": ("lm_head", "re:.*mlp\\.gate$")}
    with jax.disable_jit():
        jres = joneshot(jspec, _clone(jparams), _recipe(jparse, **recipe), batches,
                        moe_calibrate_all_experts=True)
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"), _recipe(parse_recipe, **recipe),
                  batches, moe_calibrate_all_experts=True, device="cpu")
    E = spec.num_experts
    assert sum("experts" in k for k in res.records) == spec.num_layers * 3 * E
    _codes_close(res, jres)
    rel, _ = _rel_to_bf16(spec, res.params, ref)
    assert np.isfinite(rel) and rel < 0.3, rel

    # internals: a shared 2-D Hessian for gate/up (aliased), 3-D for down
    layer = params_from_numpy(jparams, device="cpu")["layers"][0]
    sites = {s.name: s for s in layer_sites(spec, 0, layer)}
    mspec = _recipe(parse_recipe).modifiers[0]
    scheme = next(iter(mspec.config_groups.values()))
    mod = GPTQModifier(mspec)
    experts = [n for n, s in sites.items() if s.is_expert]
    state = mod.begin_layer(LayerCtx(spec=spec, layer_idx=0, layer=layer,
                                     sites=list(sites.values())),
                            [(sites[n], "group_0", scheme) for n in experts])
    rng = np.random.default_rng(0)
    D, Fe = spec.hidden_size, spec.moe_intermediate_size or spec.intermediate_size
    h2 = torch.from_numpy(rng.normal(size=(8, D)).astype(np.float32))
    down_in = rng.normal(size=(E, 8, Fe)).astype(np.float32)
    mask = np.ones((2, 4), np.float32)
    mask[1, 2:] = 0.0  # 6 valid rows
    cap = {"_batch_idx": 0}
    m = torch.from_numpy(mask)
    mod.observe(state, sites["gate_proj"], h2, m, cap)
    mod.observe(state, sites["up_proj"], h2, m, cap)
    mod.observe(state, sites["down_proj"], torch.from_numpy(down_in), m, cap)
    H_gu = mod._H_for(state, sites["gate_proj"].prefix)
    assert H_gu is not None and H_gu.shape == (D, D)
    assert mod._H_for(state, sites["up_proj"].prefix) is H_gu  # aliased
    H_dn = mod._H_for(state, sites["down_proj"].prefix)
    assert H_dn.shape == (E, Fe, Fe)
    for e in range(E):  # padding rows contribute nothing
        x_np = down_in[e].astype(np.float64)[mask.reshape(-1) > 0]
        np.testing.assert_allclose(H_dn[e].numpy(), 2.0 * x_np.T @ x_np, rtol=1e-4, atol=1e-3)


def test_gptq_hessians_dedup_through_real_capture(models):
    """Through the engine's capture: one Hessian for q/k/v, one for gate/up:
    4 accumulators for 7 sites, as the JAX package's (its alias map read
    off the jaxpr), each equal to the JAX package's op-by-op capture within
    1e-5 of its largest |value|."""
    jspec, jparams, spec = models["dense"]
    layer = params_from_numpy(jparams, device="cpu")["layers"][0]
    sites = {s.name: s for s in layer_sites(spec, 0, layer)}
    mspec = _recipe(parse_recipe).modifiers[0]
    scheme = next(iter(mspec.config_groups.values()))
    mod = GPTQModifier(mspec)
    state = mod.begin_layer(LayerCtx(spec=spec, layer_idx=0, layer=layer,
                                     sites=list(sites.values())),
                            [(s, "group_0", scheme) for s in sites.values()])
    jlayer = _clone(jparams)["layers"][0]
    jsites = {s.name: s for s in jlayer_sites(jspec, 0, jlayer)}
    jmspec = _recipe(jparse).modifiers[0]
    jmod = JG.GPTQModifier(jmspec)
    jstate = jmod.begin_layer(JLayerCtx(spec=jspec, layer_idx=0, layer=jlayer,
                                        sites=list(jsites.values())),
                              [(s, "group_0", next(iter(jmspec.config_groups.values())))
                               for s in jsites.values()])
    h_np = np.full((2, 8, spec.hidden_size), 0.1, np.float32)
    h_np += np.random.default_rng(1).normal(size=h_np.shape).astype(np.float32) * 0.5
    h = torch.from_numpy(h_np).bfloat16()
    jh = jnp.asarray(h_np).astype(jnp.bfloat16)
    pos = torch.arange(8)[None, :].expand(2, 8)
    jpos = jnp.broadcast_to(jnp.arange(8)[None, :], (2, 8))
    jamap = jalias_map(jlayer, jspec, 0, jh, jpos, False)
    for bi in range(2):
        _, cap = _capture_layer(layer, spec, 0, h, pos, False)
        cap["_batch_idx"], cap["_aliases"] = bi, _capture_alias_map(cap)
        with jax.disable_jit():
            _, jcap = jcapture(jlayer, jspec, 0, jh, jpos, False)
        jcap["_batch_idx"], jcap["_aliases"] = bi, jamap
        for name, s in sites.items():
            if cap.get(s.capture_key) is not None:
                mod.observe(state, s, cap[s.capture_key], None, cap)
            if jcap.get(jsites[name].capture_key) is not None:
                jmod.observe(jstate, jsites[name], jcap[jsites[name].capture_key], None, jcap)
    # 7 dense sites -> 4 Hessians: {q,k,v}, o, {gate,up}, down
    assert len(state["H"]) == 4, sorted(state["H"])
    assert sorted(state["H"]) == sorted(jstate["H"]) and state["alias"] == jstate["alias"]
    al = state["alias"]
    assert al[sites["k_proj"].prefix] == al[sites["q_proj"].prefix] == al[sites["v_proj"].prefix]
    assert al[sites["up_proj"].prefix] == al[sites["gate_proj"].prefix]
    assert al[sites["down_proj"].prefix] != al[sites["gate_proj"].prefix]
    for key, H in state["H"].items():
        want = np.asarray(jstate["H"][key])
        assert np.abs(H.numpy() - want).max() <= 1e-5 * np.abs(want).max(), key


# ---------------------------------------------------------------------------
# the reference fault: actorder group's scales read by contiguous groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sym", [True, False])
def test_actorder_group_ignores_g_idx_like_jax(sym):
    """Under ``actorder: group`` the scales are solved in the permuted
    column order, but both packages build the device linear (and
    ``dequantize``) with scale group j // g for column j, ignoring g_idx
    (ROADMAP queue 3). The port's linear equals the JAX package's bit for
    bit, and reading the scales by g_idx gives the lower output error."""
    K_, N, g = 256, 32, 32
    W, X, H = _problem(K_, N, seed=6)
    jargs, targs = _args(sym, g, "group")
    jqt, jg = JG.gptq_quantize(jnp.asarray(W), jnp.asarray(H), jargs, block_size=128)
    qt, g_idx = gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), targs, block_size=128)
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(jqt.values))
    np.testing.assert_array_equal(g_idx.numpy(), jg)
    lin = from_quantized(qt, targs)
    jlin = jfrom_quantized(jqt, jargs)
    np.testing.assert_array_equal(lin.dequantize(torch.float32).numpy(),
                                  np.asarray(jlin.dequantize(jnp.float32)))
    y = X @ W.T
    zp = None if sym else _np(qt.zero_point)
    served = dequantize(qt, targs).numpy()
    np.testing.assert_array_equal(served, np.asarray(jdequantize(jqt, jargs)))
    np.testing.assert_allclose(served, _dequant(qt.values.numpy(), _np(qt.scale), zp, g),
                               rtol=1e-6, atol=1e-6)
    mse_served = float(np.mean((X @ served.T - y) ** 2))
    mse_gidx = float(np.mean((X @ _dequant(qt.values.numpy(), _np(qt.scale), zp, g, g_idx).T
                              - y) ** 2))
    assert mse_gidx < mse_served, (mse_gidx, mse_served)
