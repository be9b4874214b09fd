"""Tensor, data and expert parallelism of the port against the JAX package.

Each case runs the port in a world of ``gloo`` processes on the CPU
(``tests/_torch_dist_workers.py``: one process per rank, a ``file://``
store, one thread each, a deadline that kills a hung world), from weights
made and quantized on the JAX side; the JAX package runs the same mesh in
this process on the virtual CPU devices (``shard_params`` and a jitted
forward under the mesh).

Tolerances: bf16 logits within 2% of the largest |logit| (a rank's row
shard rounds its partial sum to bf16 before the f32 all-reduce, where the
whole matmul rounds once); the ranks of a tensor-parallel group hold the
same logits bit for bit (every rank samples from them); greedy tokens
equal.
"""

import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _quantize_params_rtn
from _torch_dist_workers import ROOT, run_procs, run_world, world_env
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.parallel import make_mesh as jmake_mesh
from quantizers_tpu.parallel import shard_params as jshard
from quantizers_tpu.serve import generate as jgenerate
from quantizers_tpu_torch.cli import make_tiny_model, serve
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
from quantizers_tpu_torch.serve import generate

RTOL = 2e-2


def _model(kind):
    if kind == "dense":
        jspec, spec = JSpec.tiny(), ModelSpec.tiny()
        jp = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(0)))
    elif kind == "moe":
        jspec, spec = JSpec.tiny(moe=True), ModelSpec.tiny(moe=True)
        jp = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(1)))
    else:  # MLA with an MoE layer, bf16 (the JAX package's own mesh test model)
        jspec, spec = JSpec.tiny(moe=True, mla=True), ModelSpec.tiny(moe=True, mla=True)
        jp = jinit(jspec, jax.random.PRNGKey(3))
    return jspec, jp, spec, params_from_numpy(jp, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {k: _model(k) for k in ("dense", "moe", "mla")}


def _jax_sharded(jspec, jp, axes, ids):
    mesh = jmake_mesh(axes)
    sharded = jshard(jspec, jp, mesh)
    with mesh:
        out = jax.jit(lambda p, i: jforward(p, jspec, i)[0])(sharded, jnp.asarray(ids, jnp.int32))
    return np.asarray(out, np.float32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, label):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (label, err, np.abs(want).max())


def _decode_ref(spec, params, ids, steps):
    """The unsharded port: the no-cache logits, then a prefill and
    teacher-forced one-token steps (the worker's ``forward`` case)."""
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        T0 = ids.shape[1] - steps
        caches = KVCache.init(spec, ids.shape[0], ids.shape[1] + 8, device="cpu")
        lg, caches = forward(params, spec, ids[:, :T0], caches=caches)
        dec = [lg[:, -1]]
        for t in range(T0, ids.shape[1]):
            lg, caches = forward(params, spec, ids[:, t:t + 1], caches=caches)
            dec.append(lg[:, 0])
    return torch.stack(dec, dim=1)


def _gathered(outs, key="logits"):
    """The dp groups' rows in order, from each group's tp rank 0; and the
    check that every tp rank of a group holds the same bits."""
    rows = {}
    for o in outs:
        d = o["coords"].get("dp", 0)
        if d in rows:
            assert torch.equal(rows[d], o[key]), "ranks of one group disagree"
        else:
            rows[d] = o[key]
    return torch.cat([rows[d] for d in sorted(rows)], dim=0)


def _run_forward(models, kind, axes, ids, tmp_path, steps=3):
    jspec, jp, spec, params = models[kind]
    world = int(np.prod(list(axes.values())))
    outs = run_world("forward", world, {"spec": spec, "params": params, "ids": ids,
                                        "mesh": axes, "decode_steps": steps}, tmp_path)
    want = _jax_sharded(jspec, jp, axes, ids)
    _close(_gathered(outs), want, f"{kind} {axes} no-cache logits")
    ref = _decode_ref(spec, params, ids, steps)
    _close(_gathered(outs, "decode_logits"), ref, f"{kind} {axes} decode logits")
    return outs


@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2}],
                         ids=["tp2", "tp4_kv2_replicated", "dp2_tp2"])
def test_dense_forward_matches_jax(models, axes, tmp_path):
    """tp splits the 4 query heads; at tp 4 the 2 KV heads are replicated
    and each rank keeps the one its query head reads."""
    ids = np.random.default_rng(0).integers(1, 256, (2, 12))
    outs = _run_forward(models, "dense", axes, ids, tmp_path)
    tp = axes["tp"]
    assert all(o["heads"] == (4 // tp, max(1, 2 // tp)) for o in outs)
    assert all(o["cache_heads"] == max(1, 2 // tp) for o in outs)


@pytest.mark.parametrize("axes", [{"ep": 4}, {"tp": 2}], ids=["ep4", "tp2_fallback"])
def test_moe_forward_matches_jax(models, axes, tmp_path):
    """Experts over ep, else over tp (attention then over tp too); the
    decode steps (one token, 2 slots < 4 experts) take the gathered path,
    whose slots routed to another rank are remapped and zeroed."""
    ids = np.random.default_rng(1).integers(1, 256, (1, 10))
    outs = _run_forward(models, "moe", axes, ids, tmp_path)
    assert {o["expert_shards"] for o in outs} == {next(iter(axes.values()))}


def test_mla_forward_matches_jax(models, tmp_path):
    ids = np.random.default_rng(2).integers(1, 256, (2, 8))
    outs = _run_forward(models, "mla", {"tp": 2}, ids, tmp_path)
    assert {o["heads"][0] for o in outs} == {2}
    assert {o["cache_heads"] for o in outs} == {1}  # the latent cache is head-shared


def test_generate_under_tp2_matches_unsharded(models, tmp_path):
    _, _, spec, params = models["dense"]
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    want = generate(spec, params, prompt, max_new_tokens=6, device="cpu")
    outs = run_world("generate", 2, {"spec": spec, "params": params, "prompt": prompt,
                                     "steps": 6, "mesh": {"tp": 2}}, tmp_path)
    assert np.array_equal(outs[0]["tokens"], outs[1]["tokens"])
    assert np.array_equal(outs[0]["tokens"], want)


def test_tp2_nvfp4_moe_batcher_matches_oracle(models, tmp_path):
    """JAX's test_tp2_nvfp4_moe_batcher_matches_oracle: NVFP4 experts split
    over tp (2 of the 4 on each rank), continuous batching with slot
    recycling, against JAX's greedy generate of each prompt alone."""
    jspec, jp, spec, params = models["moe"]
    reqs = [([1, 2, 3, 4], 5), ([9, 8, 7], 4)]
    outs = run_world("batcher", 2, {"spec": spec, "params": params, "requests": reqs,
                                    "mesh": {"tp": 2}}, tmp_path)
    assert [o["expert_shards"] for o in outs] == [2, 2]
    assert "gate_up_proj" in outs[0]["layers0"]  # the w8pc layout, applied to the shards
    assert outs[0]["tokens"] == outs[1]["tokens"]
    want = [jgenerate(jspec, jp, np.asarray([p], np.int32), max_new_tokens=n)[0].tolist()
            for p, n in reqs]
    assert outs[0]["tokens"] == want


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_serve")
    assert make_tiny_model.main([str(d), "--vocab", "300", "--device", "cpu"]) == 0
    return d


PROMPTS = ["hello there", "a b c", "tensor parallel", "xyz"]


def _lines(text):
    return re.findall(r"^(\d+)\t(.*)$", text, re.M)


@pytest.mark.parametrize("mesh", ["tp=2", "dp=2"])
def test_serve_cli_mesh(mesh, tiny_dir, tmp_path, capsys):
    """``serve --mesh`` as two processes through the CLI: rank 0 prints one
    line per prompt, in prompt order (dp splits the prompts between the
    groups and gathers them), the other rank none; the texts are those of
    the single-process CLI."""
    argv = [str(tiny_dir), "--device", "cpu", "--max-new-tokens", "5"]
    for p in PROMPTS:
        argv += ["--prompt", p]
    assert serve.main(argv) == 0
    want = _lines(capsys.readouterr().out)
    assert [r for r, _ in want] == ["0", "1", "2", "3"]
    cmd = [sys.executable, "-m", "quantizers_tpu_torch.cli.serve", *argv, "--mesh", mesh]
    outs = run_procs([cmd, cmd], [world_env(tmp_path, 2, r) for r in range(2)], ROOT)
    assert _lines(outs[0]) == want
    assert _lines(outs[1]) == []
    assert "batcher steps" in outs[1]
