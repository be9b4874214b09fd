"""The port stands alone: no module of quantizers_tpu_torch imports jax,
quantizers_tpu, ml_dtypes or transformers (the machine with the card has
none of them), importing the kernels needs neither nvcc nor a card, and
the entry points refuse to fall back to the CPU on their own.

The import checks run in a subprocess, because the test session's
conftest.py has already imported JAX.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import quantizers_tpu_torch
from quantizers_tpu_torch.cli import make_tiny_model, serve
from quantizers_tpu_torch.models import (
    KVCache,
    ModelSpec,
    init_params,
    load_compressed_model,
    load_hf_model,
)
from quantizers_tpu_torch.serve import ContinuousBatcher, generate, perplexity, serving_layout

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import quantizers_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from quantizers_tpu_torch.ops import _build
banned = ("jax", "quantizers_tpu", "ml_dtypes", "transformers")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), _build._LIB is None, bad)
"""


def _all_modules():
    return [m.name for m in pkgutil.walk_packages(quantizers_tpu_torch.__path__,
                                                  "quantizers_tpu_torch.")]


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    assert make_tiny_model.main([str(d), "--vocab", "300", "--device", "cpu"]) == 0
    return d


def test_no_module_imports_jax_or_the_jax_package():
    # PATH without nvcc, and no CUDA device visible: importing builds nothing
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, not_built, bad = out.stdout.split(maxsplit=2)
    assert int(count) == len(_all_modules()) >= 15
    assert not_built == "True"
    assert bad.strip() == "[]"


ENTRY_POINTS = {
    "init_params": lambda spec, d, **kw: init_params(spec, **kw),
    "KVCache.init": lambda spec, d, **kw: KVCache.init(spec, 1, 8, **kw),
    "serving_layout": lambda spec, d, **kw: serving_layout(spec, {"layers": []}, **kw),
    "generate": lambda spec, d, **kw: generate(spec, {}, [[1, 2]], max_new_tokens=1, **kw),
    "ContinuousBatcher": lambda spec, d, **kw: ContinuousBatcher(spec, {}, **kw),
    "perplexity": lambda spec, d, **kw: perplexity(spec, load_hf_model(d, device="cpu")[1],
                                                   [(np.ones((1, 8), np.int32),
                                                     np.ones((1, 8), np.float32))], **kw),
    "load_compressed_model": lambda spec, d, **kw: load_compressed_model(d, **kw),
    "load_hf_model": lambda spec, d, **kw: load_hf_model(d, **kw),
    "make_tiny_model": lambda spec, d, **kw: make_tiny_model.main(
        [str(d / "again")] + [a for k, v in kw.items() for a in (f"--{k}", str(v))]),
}


@pytest.mark.parametrize("call", list(ENTRY_POINTS.values()), ids=list(ENTRY_POINTS))
def test_entry_points_need_a_device_or_an_explicit_cpu(call, tiny_dir):
    spec = ModelSpec.tiny(vocab_size=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(spec, tiny_dir)


@pytest.mark.parametrize("name", ["perplexity", "load_compressed_model", "load_hf_model",
                                  "make_tiny_model"])
def test_checkpoint_entry_points_run_on_an_explicit_cpu(name, tiny_dir):
    out = ENTRY_POINTS[name](ModelSpec.tiny(vocab_size=300), tiny_dir, device="cpu")
    if name == "perplexity":
        assert np.isfinite(out) and out > 1.0
    elif name == "make_tiny_model":
        assert out == 0 and (tiny_dir / "again" / "config.json").is_file()
    else:
        assert out[1]["embed"].device.type == "cpu"


@pytest.mark.parametrize("argv,slice_", [
    (lambda d: make_tiny_model.main([str(d / "mla"), "--mla"]), "slice 5"),
    (lambda d: make_tiny_model.main([str(d / "fit"), "--fit-corpus", str(d / "config.json")]),
     "training slice"),
    (lambda d: serve.main([str(d), "--prompt", "hi", "--mesh", "dp=1,tp=4", "--device", "cpu"]),
     "slice 8"),
], ids=["make_tiny_model --mla", "make_tiny_model --fit-corpus", "serve --mesh"])
def test_cli_options_of_later_slices_raise(argv, slice_, tiny_dir):
    with pytest.raises(NotImplementedError, match=slice_):
        argv(tiny_dir)


def test_moe_and_mla_specs_wait_for_their_slices():
    # MoE is ported (slice 4): a random MoE model initializes and runs
    spec = ModelSpec.tiny(moe=True)
    params = init_params(spec, device="cpu")
    moe = params["layers"][0]["moe"]
    assert moe["router"].weight.dtype == torch.float32
    assert moe["gate_proj"].num_experts == spec.num_experts
    out = generate(spec, params, [[1, 2, 3]], max_new_tokens=2, device="cpu")
    assert out.shape == (1, 2)
    # MLA waits for slice 5
    with pytest.raises(NotImplementedError, match="slice 5"):
        KVCache.init(ModelSpec.tiny(mla=True), 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        init_params(ModelSpec.tiny(mla=True), device="cpu")
