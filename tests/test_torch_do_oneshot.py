"""Port parity for ``cli/do_oneshot``, the observers (``mse`` included) and
activation capture, against the JAX package on the CPU.

* ``do_oneshot --device cpu`` on a tiny model writes the JAX CLI's
  checkpoint: the same files, config and tokenizer config, every tensor
  equal bit for bit but the KV-cache scales past layer 0, which may differ
  by a bf16 ulp (1e-2 relative: the JAX package runs its calibration
  forwards under ``jit``, where XLA keeps some bf16 intermediates in f32).
* The ``mse`` observer's scales and codes equal the JAX package's eager
  ones; the min/max observers' within 1e-6 relative (f32 moving averages).
* The capture of one layer holds the JAX package's keys, its values within
  2e-2 of each one's largest |value| (bf16 activations, f32 sums in other
  orders), and the alias map of shared inputs is the JAX package's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.cli.do_oneshot import main as jdo_oneshot
from quantizers_tpu.cli.make_tiny_model import main as jmake_tiny
from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.oneshot import engine as jengine
from quantizers_tpu.oneshot import make_batches as jmake_batches
from quantizers_tpu_torch.cli.do_oneshot import main as do_oneshot
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core import observers as tobs
from quantizers_tpu_torch.core import scheme as ts
from quantizers_tpu_torch.formats.safetensors_io import ShardedReader
from quantizers_tpu_torch.models import ModelSpec
from quantizers_tpu_torch.oneshot import engine as tengine
from quantizers_tpu_torch.oneshot import oneshot
from quantizers_tpu_torch.recipes import parse_recipe

ROOT = Path(__file__).resolve().parent.parent
ACT_RTOL = 1e-2
LOGIT_RTOL = 2e-2
W4G32 = {"targets": ["Linear"], "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                                            "strategy": "group", "group_size": 32}}
W4G32_MSE = {"targets": ["Linear"], "weights": dict(W4G32["weights"], observer="mse")}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (kw, seed) in {"dense": ({}, 0), "moe": ({"moe": True}, 1),
                             "mla_moe": ({"moe": True, "mla": True}, 3)}.items():
        jspec = JSpec.tiny(**kw)
        out[name] = (jspec, jinit(jspec, jax.random.PRNGKey(seed)), ModelSpec.tiny(**kw))
    return out


def _body_recipe(parse, body):
    return parse({"quant_stage": {"quant_modifiers": {"QuantizationModifier": body}}})


def _batches(vocab, n=4, T=16):
    rng = np.random.default_rng(0)
    samples = [list(rng.integers(1, vocab, size=rng.integers(T // 2, T))) for _ in range(n)]
    return jmake_batches(samples, max_seq_length=T, batch_size=2, pad_to_multiple=8)


def _assert_logits_agree(got, want):
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= LOGIT_RTOL * np.abs(want).max(), err


MSE_CASES = {
    "group_outlier": (dict(num_bits=4, type="int", symmetric=True, strategy="group",
                           group_size=64), (8, 64), 0.0),
    "channel_asym": (dict(num_bits=4, type="int", symmetric=False, strategy="channel"),
                     (4, 32), 1.5),
    "int8_tensor": (dict(num_bits=8, type="int", symmetric=True, strategy="tensor"),
                    (16, 48), 0.0),
    "fp8_channel": (dict(num_bits=8, type="float", strategy="channel"), (16, 48), 0.0),
    "int4_block": (dict(num_bits=4, type="int", symmetric=True, strategy="block",
                        block_structure=[8, 16]), (20, 40), 0.0),
}


@pytest.mark.parametrize("case", sorted(MSE_CASES))
def test_mse_observer_scales_match_jax(case):
    kw, shape, shift = MSE_CASES[case]
    rng = np.random.default_rng(11)
    w = rng.normal(size=shape).astype(np.float32) + shift
    w[0, 0] = 40.0  # an outlier the search clips
    ja = js.QuantizationArgs.from_dict(dict(kw, observer="mse"))
    ta = ts.QuantizationArgs.from_dict(dict(kw, observer="mse"))
    jq, tq = jn.quantize(jnp.asarray(w), ja), tn.quantize(torch.from_numpy(w), ta)
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    got = tn.fake_quantize(torch.from_numpy(w), ta).numpy()
    np.testing.assert_array_equal(got, np.asarray(jn.fake_quantize(jnp.asarray(w), ja)))
    # the search beats the min/max envelope in its own measure
    mm = tn.fake_quantize(torch.from_numpy(w), ts.QuantizationArgs.from_dict(kw)).numpy()
    assert ((got - w) ** 2).mean() <= ((mm - w) ** 2).mean()


def test_mse_observer_in_the_engine_matches_jax(models):
    """The ``mse`` observer through the engine: each record is the port's
    quantize of the site's weight, and q_proj's equals the JAX package's
    eager quantize (the search is data-free: RTN records do not depend on
    the calibration batches)."""
    jspec, jparams, spec = models["dense"]
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"),
                  _body_recipe(parse_recipe, {"config_groups": {"group_0": W4G32_MSE},
                                              "ignore": ["lm_head"]}),
                  _batches(jspec.vocab_size), device="cpu")
    args = ts.QuantizationArgs.from_dict(W4G32_MSE["weights"])
    params = params_from_numpy(jparams, device="cpu")
    for li in range(spec.num_layers):
        for name in ("q_proj", "o_proj"):
            w = params["layers"][li][name].dequantize(torch.float32).t()
            want = tn.quantize(w, args)
            cp = res.records[f"model.layers.{li}.self_attn.{name}"]
            assert torch.equal(cp.qt.values, want.values) and torch.equal(cp.qt.scale, want.scale)
    jw = jparams["layers"][0]["q_proj"].dequantize(jnp.float32).T
    jq = jn.quantize(jw, js.QuantizationArgs.from_dict(W4G32_MSE["weights"]))
    cp = res.records["model.layers.0.self_attn.q_proj"]
    np.testing.assert_array_equal(cp.qt.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(cp.qt.scale.numpy(), np.asarray(jq.scale))


def test_observers_match_jax():
    from quantizers_tpu.core import observers as jobs

    rng = np.random.default_rng(4)
    batches = [rng.normal(size=(6, 64)).astype(np.float32) * (i + 1) for i in range(3)]
    for obs in ("minmax", "memoryless_minmax", "moving_average_minmax", "mse"):
        for kw in (dict(strategy="channel"), dict(strategy="group", group_size=32),
                   dict(strategy="tensor", symmetric=False)):
            base = dict(dict(num_bits=8, type="int", symmetric=True), **kw)
            got = tobs.observe_batches([torch.from_numpy(b) for b in batches],
                                       ts.QuantizationArgs.from_dict(base), obs)
            want = jobs.observe_batches([jnp.asarray(b) for b in batches],
                                        js.QuantizationArgs.from_dict(base), obs)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    with pytest.raises(ValueError, match="Unknown observer"):
        tobs.get_observer("nope")
    with pytest.raises(ValueError, match="no batches"):
        tobs.observe_batches([], ts.QuantizationArgs.from_dict(dict(num_bits=8, type="int")))


@pytest.mark.parametrize("model", ["dense", "moe", "mla_moe"])
def test_capture_and_alias_map_match_jax(model, models):
    from quantizers_tpu.models.transformer import apply_layer as japply

    jspec, jparams, spec = models[model]
    params = params_from_numpy(jparams, device="cpu")
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(2, 8, spec.hidden_size)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None, :], (2, 8))
    li = 1  # an MoE layer where the model has one
    jcap = {}
    jout, _ = japply(jparams["layers"][li], jspec, li, jnp.asarray(h, jnp.bfloat16),
                     jnp.asarray(pos), None, True, jcap)
    out, cap = tengine._capture_layer(params["layers"][li], spec, li,
                                      torch.from_numpy(h).bfloat16(), torch.from_numpy(pos.copy()),
                                      True)
    assert sorted(cap) == sorted(jcap)
    for k, v in cap.items():
        want = np.asarray(jcap[k], np.float32)
        assert tuple(v.shape) == want.shape, k
        np.testing.assert_allclose(v.float().numpy(), want, rtol=0,
                                   atol=LOGIT_RTOL * max(np.abs(want).max(), 1e-6), err_msg=k)
    _assert_logits_agree(out.float().numpy(), np.asarray(jout, np.float32))
    jmap = jengine._capture_alias_map(jparams["layers"][li], jspec, li,
                                      jnp.asarray(h, jnp.bfloat16), jnp.asarray(pos), True)
    assert tengine._capture_alias_map(cap) == jmap and jmap


# ---------------------------------------------------------------------------
# the CLI, end to end, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_models")
    assert jmake_tiny([str(d / "dense"), "--vocab", "300", "--platform", ""]) == 0
    assert jmake_tiny([str(d / "moe"), "--moe", "--vocab", "300", "--platform", ""]) == 0
    return d


CLI_CASES = {"dense_fp8_kv8": ("dense", "recipe_fp8_kv8"),
             "moe_rtn_nvfp4": ("moe", "recipe_moe_rtn_nvfp4")}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_do_oneshot_cli_writes_the_jax_checkpoint(case, tiny_dirs, tmp_path):
    model, recipe = CLI_CASES[case]
    run_cfg = tmp_path / "run.yaml"
    run_cfg.write_text(f"""
model:
  name: {tiny_dirs / model}
quantization:
  recipe: {ROOT}/configs/recipes/{recipe}.yaml
calibration_set: {ROOT}/configs/calibration_sets/test-calibrate_quick.yaml
""")
    common = ["--config", str(run_cfg), "--cache-dir", str(tmp_path / "cache"),
              "--max-seq-length", "64"]
    assert jdo_oneshot(common + ["--output", str(tmp_path / "j")]) == 0
    assert do_oneshot(common + ["--output", str(tmp_path / "t"), "--device", "cpu",
                                "--profile-dir", str(tmp_path / "trace")]) == 0
    assert (tmp_path / "trace" / "oneshot_trace.json").stat().st_size > 0
    t, j = tmp_path / "t", tmp_path / "j"
    assert sorted(p.name for p in t.iterdir()) == sorted(p.name for p in j.iterdir())
    for name in ("config.json", "tokenizer_config.json"):
        assert json.loads((t / name).read_text()) == json.loads((j / name).read_text()), name
    rt, rj = ShardedReader(t), ShardedReader(j)
    assert sorted(rt.keys()) == sorted(rj.keys())
    for n in rj.keys():
        a, b = rt.get(n), rj.get(n)
        assert a.dtype == b.dtype and a.shape == b.shape, n
        if n.endswith(("k_scale", "v_scale")) and ".layers.0." not in n:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ACT_RTOL, err_msg=n)
        else:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), n


def test_do_oneshot_cli_refuses_a_missing_model(tmp_path):
    run_cfg = tmp_path / "run.yaml"
    run_cfg.write_text(f"""
model:
  name: Qwen/NotDownloaded-4B
quantization:
  recipe: {ROOT}/configs/recipes/recipe_dense_nvfp4.yaml
""")
    assert do_oneshot(["--config", str(run_cfg), "--device", "cpu"]) == 2
    assert jdo_oneshot(["--config", str(run_cfg)]) == 2


def test_card_default_needs_a_device_or_an_explicit_cpu(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    jspec, jparams, spec = models["dense"]
    params = params_from_numpy(jparams, device="cpu")
    recipe = _body_recipe(parse_recipe, {"config_groups": {"group_0": W4G32}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oneshot(spec, params, recipe, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        do_oneshot(["--config", str(ROOT / "configs" / "test-quantize_tiny-awq.yaml")])
