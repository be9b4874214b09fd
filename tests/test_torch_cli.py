"""Port parity for checkpoints in and perplexity out: checkpoints written by
the JAX package's CLIs load in the port into exactly the tensors the JAX
loader gives, the port's ``eval_ppl`` and ``serve`` CLIs run on them (on
the CPU), and the port's ``make_tiny_model`` output loads in the JAX
package unchanged.

The tiny W4A16 checkpoint is the one ``tests/test_cli.py`` makes:
``make_tiny_model`` then ``do_oneshot`` with AWQ (``recipe_awq_w4a16``) on
``test-calibrate_quick.yaml``. Perplexity tolerance: 1e-3 relative (the
JAX package scores under jit, where XLA may keep fused bf16 intermediates
in f32; the NLL mean moves by far less than a logit ulp).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from quantizers_tpu.cli.do_oneshot import main as jdo_oneshot
from quantizers_tpu.cli.eval_ppl import main as jeval_ppl
from quantizers_tpu.cli.make_tiny_model import main as jmake_tiny
from quantizers_tpu.models import load_compressed_model as jload_compressed
from quantizers_tpu.models import load_hf_model as jload_hf
from quantizers_tpu_torch.cli.eval_ppl import main as eval_ppl
from quantizers_tpu_torch.cli.make_tiny_model import main as make_tiny
from quantizers_tpu_torch.cli.serve import main as serve
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import load_compressed_model, load_hf_model
from quantizers_tpu_torch.models.moe import ExpertLinears
from quantizers_tpu_torch.ops.linear import QuantLinear

PPL_RTOL = 1e-3


def _oneshot(tmp, root, model_dir, recipe, name):
    run_cfg = tmp / f"{name}.yaml"
    run_cfg.write_text(f"""
model:
  name: {model_dir}
quantization:
  recipe: {root}/configs/recipes/{recipe}.yaml
calibration_set: {root}/configs/calibration_sets/test-calibrate_quick.yaml
""")
    out = tmp / name
    assert jdo_oneshot(["--config", str(run_cfg), "--output", str(out),
                        "--cache-dir", str(tmp / "cache"), "--max-seq-length", "64"]) == 0
    return out


@pytest.fixture(scope="module")
def root(request):
    return request.config.rootpath


@pytest.fixture(scope="module")
def awq_dir(tmp_path_factory, root):
    tmp = tmp_path_factory.mktemp("awq")
    assert jmake_tiny([str(tmp / "tiny"), "--vocab", "300", "--platform", ""]) == 0
    return _oneshot(tmp, root, tmp / "tiny", "recipe_awq_w4a16", "out")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    path = tmp_path_factory.mktemp("text") / "sample.txt"
    path.write_text("hello quantized world, the quick brown fox. " * 40)
    return path


def _assert_same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (QuantLinear, ExpertLinears)):
        assert type(got) is type(want) and got.kind == want.kind and got.meta == want.meta, path
        for f in ("weight", "scale", "zero_point", "bias"):
            _assert_same_tree(getattr(got, f), getattr(want, f), f"{path}.{f}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


def test_compressed_checkpoint_loads_exactly(awq_dir):
    jspec, jparams = jload_compressed(awq_dir)
    spec, params = load_compressed_model(awq_dir, device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert params["layers"][0]["q_proj"].kind == "w4"
    _assert_same_tree(params, params_from_numpy(jparams, device="cpu"))


def _ppl(out: str) -> float:
    return float(re.search(r"^ppl=([0-9.]+) tokens=\d+ windows=\d+ eval_s=", out, re.M).group(1))


@pytest.mark.parametrize("extra", [[], ["--stride", "64", "--head-bits", "8"]],
                         ids=["windows", "strided_int8_head"])
def test_eval_ppl_matches_jax(awq_dir, sample, capsys, extra):
    args = [str(awq_dir), str(sample), "--window", "128", "--max-windows", "4", *extra]
    assert jeval_ppl(args) == 0
    want = _ppl(capsys.readouterr().out)
    assert eval_ppl(args + ["--device", "cpu"]) == 0
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= PPL_RTOL * want, (got, want)


def test_serve_prints_one_line_per_prompt(awq_dir, capsys):
    prompts = ["hello", "quantized world", "a third prompt"]
    args = [str(awq_dir), "--max-new-tokens", "4", "--max-len", "64", "--head-bits", "8",
            "--device", "cpu"]
    for p in prompts:
        args += ["--prompt", p]
    assert serve(args) == 0
    assert re.findall(r"^(\d+)\t", capsys.readouterr().out, re.M) == ["0", "1", "2"]


def test_moe_nvfp4_checkpoint_loads_equal_expert_stacks(tmp_path, root):
    assert jmake_tiny([str(tmp_path / "tiny_moe"), "--moe", "--vocab", "300",
                       "--platform", ""]) == 0
    out = _oneshot(tmp_path, root, tmp_path / "tiny_moe", "recipe_moe_rtn_nvfp4", "moe")
    jspec, jparams = jload_compressed(out)
    spec, params = load_compressed_model(out, device="cpu")
    moe = params["layers"][0]["moe"]
    assert moe["gate_proj"].kind == "nvfp4" and moe["gate_proj"].num_experts == spec.num_experts
    assert moe["router"].kind == "dense"
    _assert_same_tree(params, params_from_numpy(jparams, device="cpu"))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_port_tiny_model_loads_in_jax(tmp_path, moe):
    d = tmp_path / "port_tiny"
    assert make_tiny([str(d), "--vocab", "300", "--seed", "3", "--device", "cpu"]
                     + (["--moe"] if moe else [])) == 0
    jspec, jparams = jload_hf(d)
    spec, params = load_hf_model(d, device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec) and spec.is_moe == moe
    _assert_same_tree(params, params_from_numpy(jparams, device="cpu"))
    assert np.isfinite(np.asarray(jparams["embed"], np.float32)).all()
