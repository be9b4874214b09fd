"""Port parity for AWQ and SmoothQuant (slice 7e) and the engine's layer
hooks, against the JAX package on the CPU: the cases of the JAX
``tests/test_oneshot.py`` (AWQ, SmoothQuant, the observe statistics, the
sample budget, an unmatched modifier), each also held against the JAX
package's own records, and the tiny AWQ run config through the
``do_oneshot`` and ``serve`` CLIs.

The JAX side runs op by op (``jax.disable_jit``): jitted XLA keeps some
bf16 intermediates of the calibration forwards in f32, so its captured
activations past the first attention differ from the eager ones by a bf16
ulp, and every later statistic with them. Tolerances:

* SmoothQuant: its scale is a ratio of maxima (no sum) computed with numpy
  on both sides, so the folded norms, codes and scales equal the JAX
  package's bit for bit.
* AWQ: the port computes its 20 candidate scales with numpy, the JAX
  package's formula for its final scale; the JAX package searches with
  ``jnp.power``, which rounds a few scales an ulp apart, and an ulp moves a
  group's absmax code across its rounding tie (the largest negative weight
  lands on -7.5) and the loss by up to 1e-3 of itself (several % on these
  tiny models). So the JAX side's search here evaluates the same formula
  with numpy too (``_candidate_scale`` patched for the test; the JAX package
  is not edited). Then each mapping's pick equals the JAX package's, or its
  JAX loss is within TIE_RTOL = 1e-3 of the JAX minimum (f32 sums in other
  orders: the expert stacks' ``w_mean`` may differ by an ulp). Until the
  first mapping picked otherwise, everything downstream is the JAX
  package's: ``x_mean`` within 1e-6 relative (f32 sums in another order),
  the folded scale and the records of the layers before that mapping's
  equal bit for bit. Every code is within one step of the JAX package's.
* logits: the quantized model's within 0.3 mean relative error of the bf16
  model's (the JAX tests' own criterion); where no pick differs, within 2e-2
  of the JAX package's quantized logits' largest |value|.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from quantizers_tpu.cli.do_oneshot import main as jdo_oneshot
from quantizers_tpu.cli.make_tiny_model import main as jmake_tiny
from quantizers_tpu.core.numerics import fake_quantize as jfake_quantize
from quantizers_tpu.core.scheme import QuantizationArgs as JArgs
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.oneshot import awq as jawq
from quantizers_tpu.oneshot import make_batches as jmake_batches
from quantizers_tpu.oneshot import oneshot as joneshot
from quantizers_tpu.recipes import parse_recipe as jparse
from quantizers_tpu_torch.cli.do_oneshot import main as do_oneshot
from quantizers_tpu_torch.cli.serve import main as serve
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core.numerics import fake_quantize
from quantizers_tpu_torch.core.scheme import QuantizationArgs
from quantizers_tpu_torch.formats.safetensors_io import ShardedReader
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.models.loader import load_compressed_model
from quantizers_tpu_torch.oneshot import awq as tawq
from quantizers_tpu_torch.oneshot import oneshot
from quantizers_tpu_torch.recipes import parse_recipe

ROOT = Path(__file__).resolve().parent.parent
TIE_RTOL = 1e-3
XMEAN_RTOL = 1e-6
LOGIT_RTOL = 2e-2
W4G32 = {"targets": ["Linear"], "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                                            "strategy": "group", "group_size": 32}}
IDS = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)


def _recipe(modifiers):
    return {"quant_stage": {"quant_modifiers": modifiers}}


AWQ = _recipe({"AWQModifier": {"config_groups": {"group_0": W4G32}, "ignore": ["lm_head"],
                               "duo_scaling": True}})
SMOOTHQUANT = _recipe({"SmoothQuantModifier": {"smoothing_strength": 0.5},
                       "QuantizationModifier": {"config_groups": {"group_0": W4G32},
                                                "ignore": ["lm_head"]}})


def _tiny_batches(vocab, n=4, T=16):
    rng = np.random.default_rng(0)
    samples = [list(rng.integers(1, vocab, size=rng.integers(T // 2, T))) for _ in range(n)]
    return jmake_batches(samples, max_seq_length=T, batch_size=2, pad_to_multiple=8)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (kw, seed) in {"dense": ({}, 0), "moe": ({"moe": True}, 1)}.items():
        jspec = JSpec.tiny(**kw)
        out[name] = (jspec, jinit(jspec, jax.random.PRNGKey(seed)), ModelSpec.tiny(**kw))
    return out


def _numpy_candidate_scale(j_candidate):
    """The JAX package's own candidate scale, taken down its numpy branch
    (it picks numpy for numpy inputs), so that its search evaluates the
    same formula op by op on concrete values as its final scale does."""
    def candidate(ratio, x_mean, w_mean, duo_scaling):
        return jnp.asarray(j_candidate(np.float32(ratio), np.asarray(x_mean, np.float32),
                                       np.asarray(w_mean, np.float32), duo_scaling))
    return candidate


@contextlib.contextmanager
def _searches():
    """Record each package's AWQ searches in order: (x_mean, losses, scale);
    the JAX side runs op by op with its candidate scales on numpy."""
    log = {"jax": [], "port": []}
    j_losses, j_scale = jawq._search_losses, jawq._search_scale
    t_losses, t_scale = tawq._search_losses, tawq._search_scale
    j_candidate = jawq._candidate_scale

    def wrap(losses_fn, scale_fn, key):
        def losses(*a, **kw):
            out = losses_fn(*a, **kw)
            log[key][-1]["losses"] = np.asarray(out.cpu() if isinstance(out, torch.Tensor)
                                                else out, np.float64)
            return out

        def scale(x_rows, x_mean, *a, **kw):
            log[key].append({"x_mean": np.asarray(x_mean, np.float32)})
            log[key][-1]["scale"] = s = scale_fn(x_rows, x_mean, *a, **kw)
            return s
        return losses, scale

    jawq._search_losses, jawq._search_scale = wrap(j_losses, j_scale, "jax")
    tawq._search_losses, tawq._search_scale = wrap(t_losses, t_scale, "port")
    jawq._candidate_scale = _numpy_candidate_scale(j_candidate)
    try:
        with jax.disable_jit():
            yield log
    finally:
        jawq._search_losses, jawq._search_scale = j_losses, j_scale
        tawq._search_losses, tawq._search_scale = t_losses, t_scale
        jawq._candidate_scale = j_candidate


def _both(models, model, recipe, batches=None):
    """``oneshot`` of one recipe in both packages (JAX op by op) over the same
    batches, with their AWQ searches."""
    jspec, jparams, spec = models[model]
    batches = _tiny_batches(jspec.vocab_size) if batches is None else batches
    with _searches() as log:
        jres = joneshot(jspec, jax.tree_util.tree_map(lambda a: a, jparams), jparse(recipe),
                        batches)
        tres = oneshot(spec, params_from_numpy(jparams, device="cpu"), parse_recipe(recipe),
                       batches, device="cpu")
    return jres, tres, log


def _codes(qt):
    v = qt.values
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.int32)


def _searches_agree(log, num_layers):
    """Each pick equal or a near-tie on the JAX losses; ``x_mean`` and the
    scale equal until the first mapping whose pick or scale differs.
    Returns that mapping's layer (None: none)."""
    J, T = log["jax"], log["port"]
    assert len(J) == len(T) and J and len(J) % num_layers == 0
    per_layer = len(J) // num_layers
    first = None
    for i, (j, t) in enumerate(zip(J, T)):
        bj, bt = int(np.argmin(j["losses"])), int(np.argmin(t["losses"]))
        if first is None:
            np.testing.assert_allclose(t["x_mean"], j["x_mean"], rtol=XMEAN_RTOL)
        gap = (j["losses"][bt] - j["losses"][bj]) / j["losses"][bj]
        assert gap <= TIE_RTOL, (i, bj, bt, gap)
        if first is None and (bj != bt or not np.array_equal(t["scale"], j["scale"])):
            first = i // per_layer
    return first


def _records_agree(jres, tres, first_flip_layer):
    assert sorted(tres.records) == sorted(jres.records)
    for key, cp in jres.records.items():
        d = np.abs(_codes(tres.records[key].qt) - _codes(cp.qt))
        layer = int(key.split(".")[2])
        if first_flip_layer is None or layer < first_flip_layer:
            assert d.max() == 0, key
            np.testing.assert_array_equal(tres.records[key].qt.scale.float().numpy(),
                                          np.asarray(cp.qt.scale, np.float32), err_msg=key)
        assert d.max() <= 1, key


def _logits_ok(models, model, jres, tres, first_flip_layer):
    jspec, jparams, spec = models[model]
    ref = np.asarray(jforward(jparams, jspec, jnp.asarray(IDS))[0], np.float32)
    got = forward(tres.params, spec, torch.as_tensor(IDS).long())[0].float().numpy()
    assert np.abs(ref - got).mean() / (np.abs(ref).mean() + 1e-9) < 0.3
    if first_flip_layer is None:
        with jax.disable_jit():
            want = np.asarray(jforward(jres.params, jspec, jnp.asarray(IDS))[0], np.float32)
        assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# AWQ
# ---------------------------------------------------------------------------

def test_awq_beats_rtn_on_outlier_channels():
    """Activation outliers, AWQ's home ground: the searched scale beats RTN,
    and its pick is the JAX package's (or a near-tie), its scale then equal."""
    rng = np.random.default_rng(3)
    K, N, rows = 64, 32, 256
    W = rng.normal(size=(N, K)).astype(np.float32)
    X = rng.normal(size=(rows, K)).astype(np.float32)
    X[:, :4] *= 50.0  # outlier channels
    wd = {"num_bits": 4, "type": "int", "symmetric": True, "strategy": "group", "group_size": 32}
    args = QuantizationArgs.from_dict(wd)
    Xt, Wt = torch.from_numpy(X), torch.from_numpy(W)
    y_ref = Xt @ Wt.t()
    err_rtn = float(torch.mean((Xt @ fake_quantize(Wt, args).t() - y_ref) ** 2))
    x_mean, w_mean = np.abs(X).mean(axis=0), np.abs(W).mean(axis=0)
    with _searches() as log:
        s = tawq._search_scale(Xt, x_mean, w_mean, [Wt], args, duo_scaling=True)
        jawq._search_scale(X, x_mean, w_mean, [jnp.asarray(W)], JArgs.from_dict(wd),
                           duo_scaling=True)
    st = torch.from_numpy(s)
    wq = fake_quantize(Wt * st[None, :], args)
    err_awq = float(torch.mean(((Xt / st[None, :]) @ wq.t() - y_ref) ** 2))
    assert err_awq < err_rtn, (err_awq, err_rtn)
    _searches_agree(log, 1)
    # the JAX package's search, on its own numbers, also beats RTN
    js = jnp.asarray(log["jax"][0]["scale"])
    jq = jfake_quantize(jnp.asarray(W) * js[None, :], JArgs.from_dict(wd))
    jy = (jnp.asarray(X) / js[None, :]) @ jq.T
    jerr = float(jnp.mean((jy - jnp.asarray(y_ref.numpy())) ** 2))
    assert jerr < err_rtn


@pytest.mark.parametrize("strategy,blocks", [("group", 7), ("channel", 7), ("tensor", 1)])
def test_awq_host_loss_blocks_match_the_whole_weight(monkeypatch, strategy, blocks):
    """On the host the loss runs in blocks of output channels where each row
    quantizes on its own: the blocks' codes are the whole weight's, and the
    losses equal the one-block losses but for the f32 summation order."""
    rng = np.random.default_rng(4)
    K, N, rows = 64, 40, 48
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(rows, K)).astype(np.float32))
    wd = {"num_bits": 4, "type": "int", "symmetric": True, "strategy": strategy,
          **({"group_size": 32} if strategy == "group" else {})}
    args = QuantizationArgs.from_dict(wd)
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, size=(3, K)).astype(np.float32))
    monkeypatch.setattr(tawq, "HOST_BLOCK_ROWS", 6)
    parts = tawq._row_blocks(W, args)
    assert len(parts) == blocks
    assert torch.equal(torch.cat([fake_quantize(p, args) for p in parts]), fake_quantize(W, args))
    blocked = tawq._search_losses(X, scales, [W, W[:13]], args)
    monkeypatch.setattr(tawq, "HOST_BLOCK_ROWS", N)
    whole = tawq._search_losses(X, scales, [W, W[:13]], args)
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=0)


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_awq_oneshot_runs(model, models):
    jspec, _, _ = models[model]
    jres, tres, log = _both(models, model, AWQ)
    first = _searches_agree(log, jspec.num_layers)
    _records_agree(jres, tres, first)
    if model == "dense":
        assert len(tres.records) == jspec.num_layers * 7
    _logits_ok(models, model, jres, tres, first)


def test_awq_experts_only_recipe_folds_the_aliased_stacks(models):
    """The MiniMax experts-only recipe (``block_sparse_moe`` / w1 w2 w3 targets
    and mappings) on the tiny MoE model: the aliases resolve onto the native
    expert stacks (post_attention_layernorm -> w1, w3; the w3 stack -> w2),
    only expert records are written, as the JAX package's."""
    jspec, _, _ = models["moe"]
    recipe = yaml.safe_load((ROOT / "configs" / "recipes"
                             / "recipe_minimax_experts_only_awq.yaml").read_text())
    jres, tres, log = _both(models, "moe", recipe)
    assert len(log["port"]) == 2 * jspec.num_layers
    assert len(tres.records) == jspec.num_layers * 3 * jspec.num_experts
    assert all(".mlp.experts." in k for k in tres.records)
    first = _searches_agree(log, jspec.num_layers)
    _records_agree(jres, tres, first)
    for li in range(jspec.num_layers):  # the norm took the first mapping's scale
        a = np.asarray(jres.params["layers"][li]["post_attention_layernorm"].astype(jnp.float32))
        b = tres.params["layers"][li]["post_attention_layernorm"].float().numpy()
        if first is None or li < first:
            np.testing.assert_array_equal(b, a)
    _logits_ok(models, "moe", jres, tres, first)


def test_awq_observe_stats_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0.0  # 13 valid rows
    sum_abs, count, rows = tawq._observe_stats(torch.from_numpy(x), torch.from_numpy(mask), 5)
    valid = x.reshape(-1, 16)[mask.reshape(-1) > 0]
    np.testing.assert_allclose(sum_abs.numpy(), np.abs(valid).sum(0), rtol=1e-5)
    assert float(count) == 13.0
    # the 5 sampled rows are valid rows, evenly spread over the 13
    np.testing.assert_array_equal(rows.numpy(), valid[np.arange(5) * 13 // 5])
    jsum, jcount, jrows = jawq._observe_stats(jnp.asarray(x), jnp.asarray(mask), take=5,
                                              masked=True)
    np.testing.assert_allclose(sum_abs.numpy(), np.asarray(jsum), rtol=1e-6)
    assert float(jcount) == float(count)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))


@pytest.mark.parametrize("take,valid", [(5, 10), (7, 21), (512, 1000), (3, 3), (100, 300),
                                        (64, 192), (11, 1)])
def test_awq_sample_positions_match_jax(take, valid):
    """The sampled row of position i is valid row floor(i * n_valid / take),
    the JAX package's, also where the quotient is an exact integer."""
    R = max(valid, take) + 7
    x = np.arange(R, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
    mask = np.zeros((R,), np.float32)
    mask[np.random.default_rng(take).permutation(R)[:valid]] = 1.0
    _, _, rows = tawq._observe_stats(torch.from_numpy(x), torch.from_numpy(mask), take)
    _, _, jrows = jawq._observe_stats(jnp.asarray(x), jnp.asarray(mask), take=take, masked=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    idx = np.flatnonzero(mask > 0)[np.minimum(np.arange(take) * valid // take, valid - 1)]
    np.testing.assert_array_equal(rows.numpy()[:, 0], idx.astype(np.float32))


def test_awq_take_budget_uses_valid_rows():
    """A heavily padded batch must not fill the sample budget with duplicate
    rows and starve later batches; the port keeps the JAX package's rows."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 300, 16)).astype(np.float32)
    mask = np.zeros((4, 300), np.float32)
    mask[:, :25] = 1.0  # 100 valid of 1200 rows
    st, jst = tawq._MappingState(), jawq._MappingState()
    for xb, mb, vr, kept in ((x, mask, 100, 100), (x + 1.0, mask, 100, 200),
                             (x, None, None, tawq.MAX_SEARCH_ROWS)):
        st.update(torch.from_numpy(xb), None if mb is None else torch.from_numpy(mb), valid_rows=vr)
        jst.update(jnp.asarray(xb), None if mb is None else jnp.asarray(mb), valid_rows=vr)
        assert st.rows_kept == jst.rows_kept == kept
    np.testing.assert_array_equal(st.x_rows().numpy(), np.asarray(jst.x_rows()))
    assert st.count_f() == jst.count_f() == 1400.0
    np.testing.assert_allclose(st.x_mean, jst.x_mean, rtol=XMEAN_RTOL)


def test_multi_modifier_with_unmatched_modifier_and_sync(models):
    """A sequential recipe where one modifier matches no site of the decoder
    layers (RTN on lm_head) beside AWQ on the attention: the engine keeps no
    state for the unmatched one, and AWQ's records are the JAX package's."""
    jspec, _, _ = models["dense"]
    recipe = _recipe({
        "AWQModifier": {"config_groups": {"group_0": {"targets": ["re:.*self_attn.*"],
                                                      "weights": dict(W4G32["weights"])}},
                        "ignore": ["lm_head"]},
        "QuantizationModifier": {"config_groups": {"group_1": {
            "targets": ["lm_head"], "weights": dict(W4G32["weights"])}}}})
    jres, tres, log = _both(models, "dense", recipe)
    assert len(tres.records) == jspec.num_layers * 4
    assert all(".self_attn." in k for k in tres.records)
    _records_agree(jres, tres, _searches_agree(log, jspec.num_layers))


# ---------------------------------------------------------------------------
# SmoothQuant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["dense", "moe"])
def test_smoothquant_plus_rtn(model, models):
    """SmoothQuant transforms, RTN compresses (SmoothQuant claims no site):
    the folded norms, the codes and the scales are the JAX package's bit for
    bit, and the forward stays close to the bf16 model's."""
    jspec, _, _ = models[model]
    jres, tres, _ = _both(models, model, SMOOTHQUANT)
    if model == "dense":
        assert len(tres.records) == jspec.num_layers * 7
    _records_agree(jres, tres, None)
    for li in range(jspec.num_layers):
        for key in ("input_layernorm", "post_attention_layernorm"):
            np.testing.assert_array_equal(
                tres.params["layers"][li][key].float().numpy(),
                np.asarray(jres.params["layers"][li][key].astype(jnp.float32)))
    _logits_ok(models, model, jres, tres, None)


# ---------------------------------------------------------------------------
# the tiny AWQ run config through the CLIs
# ---------------------------------------------------------------------------

def test_tiny_awq_run_config_through_the_clis(tmp_path, capsys):
    """``configs/test-quantize_tiny-awq.yaml`` (its model a local tiny one):
    the port's do_oneshot writes the JAX CLI's tensors (the codes within one
    step, as above), and serve answers from the checkpoint."""
    tiny = tmp_path / "tiny"
    assert jmake_tiny([str(tiny), "--vocab", "300", "--platform", ""]) == 0
    cfg = yaml.safe_load((ROOT / "configs" / "test-quantize_tiny-awq.yaml").read_text())
    cfg["model"]["name"] = str(tiny)
    cfg["quantization"]["recipe"] = str(ROOT / "configs" / cfg["quantization"]["recipe"])
    cfg["calibration_set"] = str(ROOT / "configs" / cfg["calibration_set"])
    run_cfg = tmp_path / "run.yaml"
    run_cfg.write_text(yaml.safe_dump(cfg))
    common = ["--config", str(run_cfg), "--cache-dir", str(tmp_path / "cache"),
              "--max-seq-length", "64"]
    with jax.disable_jit():
        assert jdo_oneshot(common + ["--output", str(tmp_path / "j")]) == 0
    out = tmp_path / "t"
    assert do_oneshot(common + ["--output", str(out), "--device", "cpu"]) == 0
    rt, rj = ShardedReader(out), ShardedReader(tmp_path / "j")
    assert sorted(rt.keys()) == sorted(rj.keys())
    for name in rj.keys():
        a, b = rt.get(name), rj.get(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.endswith("weight_packed"):  # eight codes + 8 a word, one a nibble
            na, nb = (np.stack([t.view(torch.uint8).numpy() & 15, t.view(torch.uint8).numpy() >> 4])
                      .astype(np.int32) for t in (a, b))
            assert np.abs(na - nb).max() <= 1, name
    spec, params = load_compressed_model(out, device="cpu")
    assert params["layers"][0]["q_proj"].kind == "w4"
    logits = forward(params, spec, torch.as_tensor(IDS).long())[0]
    assert torch.isfinite(logits.float()).all()
    capsys.readouterr()
    assert serve([str(out), "--prompt", "hello", "--prompt", "the cat", "--max-new-tokens", "4",
                  "--device", "cpu"]) == 0
    assert len([ln for ln in capsys.readouterr().out.splitlines() if ln[:2] in ("0\t", "1\t")]) == 2
