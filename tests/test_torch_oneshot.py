"""Port parity for the RTN oneshot engine (``quantizers_tpu_torch.oneshot``)
against the JAX package on the CPU (the CLI, the observers and activation
capture: ``tests/test_torch_do_oneshot.py``).

The tiny models are the JAX package's ``ModelSpec.tiny()`` dense, MoE and
MLA + MoE weights, carried across with ``convert.params_from_numpy``; the
calibration batches are the same numpy arrays. Tolerances:

* codes, scales, global scales and zero points: equal, expert stacks too
  (the JAX package quantizes a w4 or w8 stack under ``vmap``, which could
  let XLA rewrite the division by the scale, as it does under ``lax.map``
  in ``experts_to_w8pc``; on the CPU it gives the eager codes: no code
  apart on these models, nor on 16 x 256 x 512 stacks at w4 g32 / g128,
  w8 and fp8 per channel);
* activation and KV-cache scales: the JAX package runs its capture and
  propagate forwards under ``jit`` (XLA keeps some bf16 intermediates in
  f32), so an absmax past the first layer's attention input may differ by
  a bf16 ulp: 1e-2 relative (one ulp is at most 2^-7 = 0.0078);
* logits after quantization: within 2e-2 of the largest |logit| (the rule
  of ``chip_smoke.logits_agree``).

The port runs every case in both offload modes; the JAX package in its
default device mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.oneshot import make_batches as jmake_batches
from quantizers_tpu.oneshot import oneshot as joneshot
from quantizers_tpu.oneshot import streaming_peak_bytes as jpeak
from quantizers_tpu.recipes import parse_recipe as jparse
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.formats.checkpoint import save_compressed_model
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.models.loader import (
    iter_model_linears,
    load_compressed_model,
    model_plain_tensors,
)
from quantizers_tpu_torch.oneshot import make_batches, oneshot, streaming_peak_bytes
from quantizers_tpu_torch.recipes import parse_recipe

ACT_RTOL = 1e-2
LOGIT_RTOL = 2e-2

W4G32 = {"targets": ["Linear"], "weights": {"num_bits": 4, "type": "int", "symmetric": True,
                                            "strategy": "group", "group_size": 32}}
KV8 = {"num_bits": 8, "type": "float", "strategy": "tensor", "symmetric": True}
NVFP4_EXPERTS = {"targets": ["re:.*mlp\\.experts\\.\\d+\\.(gate|up|down)_proj$"],
                 "weights": {"num_bits": 4, "type": "float", "symmetric": True,
                             "strategy": "tensor_group", "group_size": 16}}
STATIC_FP8 = {"targets": ["Linear"],
              "weights": {"num_bits": 8, "type": "float", "strategy": "channel"},
              "input_activations": {"num_bits": 8, "type": "float", "strategy": "tensor",
                                    "dynamic": False}}

MODELS = {"dense": ({}, 0), "moe": ({"moe": True}, 1), "mla_moe": ({"moe": True, "mla": True}, 3)}

#: (model, modifier body): the RTN cases of tests/test_oneshot.py
CASES = {
    "dense_w4_kv": ("dense", {"config_groups": {"group_0": W4G32}, "ignore": ["lm_head"],
                              "kv_cache_scheme": KV8}),
    "dense_static_fp8_act": ("dense", {"config_groups": {"group_0": STATIC_FP8},
                                       "ignore": ["lm_head"]}),
    "moe_w4_all_experts": ("moe", {"config_groups": {"group_0": W4G32}, "ignore": ["lm_head"]}),
    "moe_experts_only_nvfp4": ("moe", {"config_groups": {"group_0": NVFP4_EXPERTS},
                                       "ignore": ["lm_head", "re:.*mlp\\.gate$"]}),
    "mla_moe_w4_kv_latent": ("mla_moe", {"config_groups": {"group_0": W4G32},
                                         "ignore": ["lm_head", "re:.*mlp\\.gate$"],
                                         "kv_cache_scheme": KV8}),
}


def _clone(params):
    """New containers over the same arrays: the JAX oneshot replaces the
    linears of the dicts it is given."""
    return jax.tree_util.tree_map(lambda x: x, params)


def _body_recipe(parse, body):
    return parse({"quant_stage": {"quant_modifiers": {"QuantizationModifier": body}}})


def _batches(vocab, n=4, T=16):
    rng = np.random.default_rng(0)
    samples = [list(rng.integers(1, vocab, size=rng.integers(T // 2, T))) for _ in range(n)]
    return jmake_batches(samples, max_seq_length=T, batch_size=2, pad_to_multiple=8)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (kw, seed) in MODELS.items():
        jspec = JSpec.tiny(**kw)
        out[name] = (jspec, jinit(jspec, jax.random.PRNGKey(seed)), ModelSpec.tiny(**kw))
    return out


@pytest.fixture(scope="module")
def jax_results(models):
    """Each case's JAX oneshot, run once."""
    cache = {}

    def get(case):
        if case not in cache:
            model, body = CASES[case]
            jspec, jparams, _ = models[model]
            cache[case] = joneshot(jspec, _clone(jparams), _body_recipe(jparse, body),
                                   _batches(jspec.vocab_size), moe_calibrate_all_experts=True)
        return cache[case]
    return get


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_logits_agree(got, want):
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= LOGIT_RTOL * np.abs(want).max(), err


def _compare_results(res, jres, spec, jspec, ids):
    assert sorted(res.records) == sorted(jres.records) and res.records
    for prefix, cp in res.records.items():
        jcp = jres.records[prefix]
        assert cp.args.to_dict() == jcp.args.to_dict() and cp.group == jcp.group, prefix
        got, want = cp.qt.values.numpy(), np.asarray(jcp.qt.values)
        assert got.shape == want.shape, prefix
        differ = got != want
        assert not differ.any(), (prefix, differ.mean())
        np.testing.assert_array_equal(_np(cp.qt.scale), _np(jcp.qt.scale), err_msg=prefix)
        for f in ("zero_point", "global_scale"):
            a, b = getattr(cp.qt, f), getattr(jcp.qt, f)
            assert (a is None) == (b is None), (prefix, f)
            if a is not None:
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=prefix)
    assert sorted(res.extra_tensors) == sorted(jres.extra_tensors)
    for name, t in res.extra_tensors.items():
        assert t.dtype == torch.float32 and t.shape == (1,), name
        np.testing.assert_allclose(t.numpy(), np.asarray(jres.extra_tensors[name]),
                                   rtol=ACT_RTOL, err_msg=name)
    assert ({k: v.to_dict() for k, v in res.config_groups.items()}
            == {k: v.to_dict() for k, v in jres.config_groups.items()})
    assert res.ignore == jres.ignore
    assert ((res.kv_cache_scheme and res.kv_cache_scheme.to_dict())
            == (jres.kv_cache_scheme and jres.kv_cache_scheme.to_dict()))
    got = forward(res.params, spec, torch.as_tensor(ids).long())[0].float().numpy()
    want = np.asarray(jforward(jres.params, jspec, jnp.asarray(ids))[0], np.float32)
    _assert_logits_agree(got, want)


@pytest.mark.parametrize("offload", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rtn_oneshot_matches_jax(case, offload, models, jax_results):
    model, body = CASES[case]
    jspec, jparams, spec = models[model]
    params = params_from_numpy(jparams, device="cpu")
    res = oneshot(spec, params, _body_recipe(parse_recipe, body), _batches(jspec.vocab_size),
                  moe_calibrate_all_experts=True, offload=offload, device="cpu")
    _compare_results(res, jax_results(case), spec, jspec, np.array([[1, 2, 3, 4, 5, 6]]))
    # device mode quantizes the caller's params in place, as the JAX
    # package does; host mode works on a host copy
    assert (params["layers"][0]["o_proj"] is res.params["layers"][0]["o_proj"]) == (
        offload == "device")
    if model == "dense" and "w4" in case:
        assert len(res.records) == spec.num_layers * 7
        assert res.params["layers"][0]["q_proj"].kind == "w4"
    if case == "moe_experts_only_nvfp4":
        layer0 = res.params["layers"][0]
        assert layer0["moe"]["gate_proj"].kind == "nvfp4" and layer0["q_proj"].kind == "dense"
        assert layer0["moe"]["router"].kind == "dense"
        assert len(res.records) == spec.num_layers * 3 * spec.num_experts
    if case == "dense_static_fp8_act":
        assert sum(k.endswith(".input_scale") for k in res.extra_tensors) == spec.num_layers * 7
    if case == "mla_moe_w4_kv_latent":
        # the latent cache's scales: c_kv and the shared rope row
        assert res.extra_tensors["model.layers.0.self_attn.k_scale"][0] > 0
        assert "model.layers.1.mlp.experts.0.down_proj" in res.records
        assert "model.layers.1.mlp.shared_experts.down_proj" in res.records
        assert not any(k.endswith("mlp.gate") for k in res.records)
    for cp in res.records.values():
        assert cp.qt.values.device.type == "cpu"


def test_host_offload_matches_device_mode_exactly(models):
    jspec, jparams, spec = models["moe"]
    recipe = _body_recipe(parse_recipe, {"config_groups": {"group_0": W4G32},
                                         "ignore": ["lm_head"], "kv_cache_scheme": KV8})
    out = {mode: oneshot(spec, params_from_numpy(jparams, device="cpu"), recipe,
                         _batches(jspec.vocab_size), offload=mode, device="cpu")
           for mode in ("device", "host")}
    assert sorted(out["device"].records) == sorted(out["host"].records)
    for k, cp in out["device"].records.items():
        assert torch.equal(cp.qt.values, out["host"].records[k].qt.values), k
        assert torch.equal(cp.qt.scale, out["host"].records[k].qt.scale), k
    for k, t in out["device"].extra_tensors.items():
        assert torch.equal(t, out["host"].extra_tensors[k]), k
    assert set(out["host"].stats) >= {"capture_s", "solve_s", "propagate_s", "total_s"}


def test_bad_offload_refuses(models):
    _, jparams, spec = models["dense"]
    params = params_from_numpy(jparams, device="cpu")
    with pytest.raises(ValueError, match="offload"):
        oneshot(spec, params, _body_recipe(parse_recipe, {"config_groups": {"group_0": W4G32}}),
                [], offload="disk", device="cpu")


@pytest.mark.parametrize("name", ["AWQModifier", "SmoothQuantModifier", "GPTQModifier",
                                  "AutoRoundModifier"])
def test_ported_modifiers_run(name, models):
    """AWQ and SmoothQuant (slice 7e), GPTQ (slice 7d) and AutoRound (slice
    7f) run where they used to be refused: AWQ, GPTQ and AutoRound compress
    every linear, SmoothQuant only transforms (its paired RTN compresses),
    and with no calibration batch AWQ and SmoothQuant leave the folds out,
    GPTQ falls back to RTN and AutoRound solves on unit rows, as in the JAX
    package (tests/test_torch_awq.py, test_torch_gptq.py and
    test_torch_autoround.py hold them against it)."""
    jspec, jparams, spec = models["dense"]
    mods = {name: {"config_groups": {"group_0": W4G32}}}
    if name == "AutoRoundModifier":
        mods[name]["iters"] = 4
    if name == "SmoothQuantModifier":
        mods = {name: {}, "QuantizationModifier": {"config_groups": {"group_0": W4G32}}}
    recipe = {"quant_stage": {"quant_modifiers": mods}}
    batches = _batches(jspec.vocab_size)
    for bs in (batches, []):
        res = oneshot(spec, params_from_numpy(jparams, device="cpu"), parse_recipe(recipe), bs,
                      device="cpu")
        jres = joneshot(jspec, _clone(jparams), jparse(recipe), bs)
        assert sorted(res.records) == sorted(jres.records)
        assert len(res.records) == spec.num_layers * 7
    # no batch: no statistic, so no fold (no Hessian): RTN's codes of the
    # bf16 weights (AutoRound's on unit rows)
    for key, cp in jres.records.items():
        np.testing.assert_array_equal(res.records[key].qt.values.numpy(),
                                      np.asarray(cp.qt.values), err_msg=key)


def test_independent_pipeline_merges_groups_as_jax(models):
    jspec, jparams, spec = models["dense"]
    text = """
modifiers:
  - name: QuantizationModifier
    config_groups:
      group_0:
        targets: ["re:.*self_attn.*"]
        weights: {num_bits: 8, type: int, symmetric: true, strategy: channel}
    ignore: [lm_head]
  - name: QuantizationModifier
    config_groups:
      group_0:
        targets: ["re:.*mlp.*"]
        weights: {num_bits: 4, type: int, symmetric: true, strategy: group, group_size: 32}
    ignore: [lm_head]
"""
    batches = _batches(jspec.vocab_size)
    jres = joneshot(jspec, _clone(jparams), jparse(text), batches, pipeline="independent")
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"), parse_recipe(text), batches,
                  pipeline="independent", device="cpu")
    assert list(res.config_groups) == list(jres.config_groups) == ["group_0", "group_0_m1"]
    _compare_results(res, jres, spec, jspec, np.array([[1, 2, 3, 4]]))
    assert res.params["layers"][0]["q_proj"].kind == "w8"
    assert res.params["layers"][0]["mlp"]["down_proj"].kind == "w4"


@pytest.mark.parametrize("rows,max_len,bs,mult", [
    ([[1, 2, 3], [4, 5], list(range(1, 30))], 16, 2, 8),
    ([{"input_ids": [1, 2, 3]}], 8, 1, 4),
    ([list(range(1, n)) for n in (3, 130, 300, 20, 511, 700, 1)], 512, 4, 128),
])
def test_make_batches_matches_jax(rows, max_len, bs, mult):
    got = make_batches(rows, max_seq_length=max_len, batch_size=bs, pad_to_multiple=mult)
    want = jmake_batches(rows, max_seq_length=max_len, batch_size=bs, pad_to_multiple=mult)
    assert len(got) == len(want)
    for (ids, mask), (jids, jmask) in zip(got, want):
        assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)


def test_streaming_peak_bytes_matches_jax():
    geo = dict(vocab_size=151936, hidden_size=2048, num_layers=48, num_heads=32,
               num_kv_heads=4, head_dim=128, intermediate_size=6144, num_experts=128,
               num_experts_per_tok=8, moe_intermediate_size=768, qk_norm=True,
               model_type="qwen3_moe")
    est = streaming_peak_bytes(ModelSpec(**geo), batch_size=4, seq_len=4096)
    assert est == jpeak(JSpec(**geo), batch_size=4, seq_len=4096)
    assert est["peak_bytes"] < 16e9 < 55e9 < est["layer_bytes"] * 48 + est["embed_bytes"]


def test_forward_moe_all_experts_agrees_with_the_gathered_path(models):
    """``forward(moe_all_experts=True)`` takes every MoE layer through the
    loop over all experts (held against the JAX package's layer by
    ``test_capture_and_alias_map_match_jax``); a 5-token batch otherwise
    takes the gathered path (held against JAX in ``test_torch_moe.py``)."""
    _, jparams, spec = models["moe"]
    ids = torch.tensor([[3, 1, 4, 1, 5]])
    params = params_from_numpy(jparams, device="cpu")
    loop = forward(params, spec, ids, moe_all_experts=True)[0]
    gathered = forward(params, spec, ids)[0]
    _assert_logits_agree(loop.float().numpy(), gathered.float().numpy())


def test_save_reload_gives_the_same_logits(models, tmp_path):
    jspec, jparams, spec = models["dense"]
    res = oneshot(spec, params_from_numpy(jparams, device="cpu"),
                  _body_recipe(parse_recipe, {"config_groups": {"group_0": W4G32},
                                              "ignore": ["lm_head"]}),
                  _batches(jspec.vocab_size), device="cpu")
    plain = model_plain_tensors(spec, res.params)
    for prefix, lin in iter_model_linears(spec, res.params):
        if prefix not in res.records:
            plain[f"{prefix}.weight"] = lin.dequantize(torch.float32).t()
    save_compressed_model(tmp_path, plain, res.records, config_groups=res.config_groups,
                          ignore=res.ignore, base_config=spec.to_hf_config())
    spec2, params2 = load_compressed_model(tmp_path, device="cpu")
    assert params2["layers"][0]["q_proj"].kind == "w4"
    ids = torch.tensor([[1, 2, 3, 4]])
    a, b = forward(res.params, spec, ids)[0], forward(params2, spec2, ids)[0]
    assert torch.equal(a, b)
