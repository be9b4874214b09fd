"""The port stands alone: no module of quantizers_tpu_torch imports jax or
quantizers_tpu, importing the kernels needs neither nvcc nor a card, and
the entry points refuse to fall back to the CPU on their own.

The import checks run in a subprocess, because the test session's
conftest.py has already imported JAX.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import quantizers_tpu_torch
from quantizers_tpu_torch.models import KVCache, ModelSpec, init_params
from quantizers_tpu_torch.serve import ContinuousBatcher, generate, serving_layout

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import quantizers_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from quantizers_tpu_torch.ops import _build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "quantizers_tpu"
             or m.startswith("quantizers_tpu."))
print(len(names), _build._LIB is None, bad)
"""


def _all_modules():
    return [m.name for m in pkgutil.walk_packages(quantizers_tpu_torch.__path__,
                                                  "quantizers_tpu_torch.")]


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


@pytest.mark.parametrize("call", [
    lambda spec: init_params(spec),
    lambda spec: KVCache.init(spec, 1, 8),
    lambda spec: serving_layout(spec, {"layers": []}),
    lambda spec: generate(spec, {}, [[1, 2]], max_new_tokens=1),
    lambda spec: ContinuousBatcher(spec, {}),
], ids=["init_params", "KVCache.init", "serving_layout", "generate", "ContinuousBatcher"])
def test_entry_points_need_a_device_or_an_explicit_cpu(call):
    spec = ModelSpec.tiny()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(spec)


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
