"""The port stands alone: no module of quantizers_tpu_torch imports jax,
quantizers_tpu, ml_dtypes or transformers (the machine with the card has
none of them), importing the kernels needs neither nvcc nor a card, and
the entry points refuse to fall back to the CPU on their own. HF
``datasets`` and ``pyarrow`` (on the card's machine, but slow to import)
are loaded only by the calibration-set functions that read data, never by
importing a module.

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
banned = ("jax", "quantizers_tpu", "ml_dtypes", "transformers", "datasets", "pyarrow")
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
    # the multi-device slice's modules are among those imported
    assert {f"quantizers_tpu_torch.{m}" for m in (
        "parallel", "parallel.distributed", "parallel.mesh", "parallel.ring",
        "parallel.collectives", "utils", "utils.jitcache")} <= set(_all_modules())
    assert not_built == "True"
    assert bad.strip() == "[]"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    banned = ("jax", "quantizers_tpu", "ml_dtypes", "transformers")
    assert not sorted(m for m in names if m.split(".")[0] in banned)
    assert "quantizers_tpu_torch.ops" in names


def test_slice5_kernels_are_counted_and_refuse_other_devices():
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.ops import linear as tl

    assert {"fp8_matmul", "mla_decode_attention"} <= set(K.launch_counts())
    lin = tl.QuantLinear(kind="fp8", weight=torch.zeros((128, 128), dtype=torch.float8_e4m3fn,
                                                        device="meta"),
                         scale=torch.ones((1, 1), device="meta"),
                         meta=(("k", 128), ("n", 128), ("strategy", "block"), ("block_k", 128),
                               ("block_n", 128)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.fp8_matmul(torch.zeros((2, 128), dtype=torch.bfloat16, device="meta"), lin)
    z = torch.zeros((1, 2, 128), dtype=torch.bfloat16, device="meta")
    c = torch.zeros((1, 1, 8, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.mla_decode_attention(z, z, z[0], z[0], c, c, torch.zeros(1, dtype=torch.int32), 0.1)
    assert K.fp8_matmul.launches == K.mla_decode_attention.launches == 0


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
    # ported in slice 5: writes a tiny MLA model that both packages load
    (lambda d: make_tiny_model.main([str(d / "mla"), "--mla", "--device", "cpu"]), None),
    # ported in the training slice: fits the model to a text first
    (lambda d: make_tiny_model.main([str(d / "fit"), "--fit-corpus", str(d / "config.json"),
                                     "--fit-steps", "5", "--fit-seq", "32", "--device", "cpu"]),
     None),
    # ported in slice 8: one process serves --mesh tp=1; a mesh of more ranks
    # than the run has raises
    (lambda d: serve.main([str(d), "--prompt", "hi", "--mesh", "dp=1,tp=4", "--device", "cpu"]),
     "slice 8"),
], ids=["make_tiny_model --mla", "make_tiny_model --fit-corpus", "serve --mesh"])
def test_cli_options_of_later_slices_raise(argv, slice_, tiny_dir, request, capsys):
    if slice_ == "slice 8":
        assert serve.main([str(tiny_dir), "--prompt", "hi", "--mesh", "tp=1", "--device", "cpu",
                           "--max-new-tokens", "3"]) == 0
        assert capsys.readouterr().out.startswith("0\t")
        with pytest.raises(ValueError, match="mesh needs 4 ranks, have 1"):
            argv(tiny_dir)
        return
    from quantizers_tpu.models.loader import load_hf_model as jax_load_hf_model

    mla = "--mla" in request.node.callspec.id
    out = tiny_dir / ("mla" if mla else "fit")
    assert argv(tiny_dir) == 0
    spec, params = load_hf_model(out, device="cpu")
    jspec, jparams = jax_load_hf_model(out)
    assert spec == ModelSpec.tiny(mla=mla, hidden_size=64, num_layers=2, vocab_size=512)
    assert jspec.is_mla == mla and jspec.kv_lora_rank == spec.kv_lora_rank
    names = ("q_a_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj") if mla else (
        "q_proj", "k_proj", "v_proj", "o_proj")
    for name in names:
        np.testing.assert_array_equal(
            params["layers"][1][name].weight.float().numpy(),
            np.asarray(jparams["layers"][1][name].weight, np.float32))
    assert np.isfinite(perplexity(spec, params, [(np.ones((1, 8), np.int32),
                                                  np.ones((1, 8), np.float32))], device="cpu"))


def test_moe_and_mla_specs_wait_for_their_slices():
    # MoE is ported (slice 4): a random MoE model initializes and runs
    spec = ModelSpec.tiny(moe=True)
    params = init_params(spec, device="cpu")
    moe = params["layers"][0]["moe"]
    assert moe["router"].weight.dtype == torch.float32
    assert moe["gate_proj"].num_experts == spec.num_experts
    out = generate(spec, params, [[1, 2, 3]], max_new_tokens=2, device="cpu")
    assert out.shape == (1, 2)
    # MLA is ported (slice 5): the latent cache, and a random MLA model runs
    mla = ModelSpec.tiny(mla=True)
    caches = KVCache.init(mla, 1, 8, device="cpu")
    assert caches[0].k.shape == (1, 1, 8, mla.kv_lora_rank) and caches[0].v.shape == (1, 1, 8, 128)
    params = init_params(mla, device="cpu")
    assert {"q_a_proj", "q_b_proj", "kv_a_proj_with_mqa", "kv_b_proj"} <= set(params["layers"][0])
    assert generate(mla, params, [[1, 2, 3]], max_new_tokens=2, device="cpu").shape == (1, 2)
