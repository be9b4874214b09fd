"""The port's placements and shards against the JAX package, in one process.

``quantizers_tpu_torch.parallel.mesh`` against ``quantizers_tpu.parallel``:
the placement tree leaf for leaf with JAX's ``param_pspecs`` (on the 8
virtual CPU devices of the root conftest), the compatible rule,
``parse_mesh_arg`` and the mesh's error; then the port's own shards, cut
for every rank of an abstract mesh on the host and put back together, bit
for bit the whole weights (the split-half re-pack of w4 and NVFP4 rows,
the fused segments, the expert stacks); the capacity plan of a rank's
tree; the persistent build cache; and the build's install under two
processes at once.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax

from __graft_entry__ import _quantize_params_rtn
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.models.transformer import fuse_for_decode as jfuse
from quantizers_tpu.ops import linear as jl
from quantizers_tpu.parallel import make_mesh as jmake_mesh
from quantizers_tpu.parallel import param_pspecs as jpspecs
from quantizers_tpu.parallel.distributed import parse_mesh_arg as jparse
from quantizers_tpu.parallel.mesh import compatible_pspec as jcompat
from quantizers_tpu.utils import jitcache as jjit
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import ModelSpec
from quantizers_tpu_torch.models.transformer import fuse_for_decode
from quantizers_tpu_torch.ops import _build
from quantizers_tpu_torch.ops import linear as tl
from quantizers_tpu_torch.parallel import make_mesh, param_pspecs, shard_params
from quantizers_tpu_torch.parallel.collectives import RowParallel
from quantizers_tpu_torch.parallel.distributed import parse_mesh_arg
from quantizers_tpu_torch.parallel.mesh import P, Mesh, compatible_pspec
from quantizers_tpu_torch.utils import enable_persistent_cache

ROOT = Path(__file__).resolve().parent.parent


def _models(kind):
    """(JAX spec, JAX params, port spec, port params) of a tiny model:
    dense W4A16 g32, dense NVFP4, NVFP4 experts, or MLA (bf16)."""
    if kind in ("dense", "nvfp4"):
        over = dict(hidden_size=128, intermediate_size=256)
        jspec = JSpec.tiny(**over)
        jp = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(0)),
                                  scheme_name="W4A16_G32" if kind == "dense" else "NVFP4")
        spec = ModelSpec.tiny(**over)
    elif kind == "moe":
        jspec, spec = JSpec.tiny(moe=True), ModelSpec.tiny(moe=True)
        jp = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(1)))
    else:
        jspec, spec = JSpec.tiny(moe=True, mla=True), ModelSpec.tiny(moe=True, mla=True)
        jp = jfuse(jspec, jinit(jspec, jax.random.PRNGKey(3)))  # adds mla_absorb
    return jspec, jp, spec, params_from_numpy(jp, device="cpu")


def _flat(tree, path=""):
    """(path, placement) pairs of a placement tree of either package."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{path}/{key}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") and \
            type(tree).__name__ not in ("PartitionSpec", "P"):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif tree is None:
        yield path, None
    elif hasattr(tree, "kind") and hasattr(tree, "weight"):
        yield path + "#type", type(tree).__name__
        for field in ("weight", "scale", "zero_point", "bias"):
            yield from _flat(getattr(tree, field), f"{path}.{field}")
    else:
        yield path, tuple(tree)


@pytest.mark.parametrize("kind,axes", [
    ("dense", {"tp": 2}), ("dense", {"dp": 2, "tp": 4}), ("dense-fused", {"tp": 4}),
    ("moe", {"dp": 2, "ep": 4}), ("moe", {"tp": 2}), ("mla", {"dp": 2, "tp": 4})])
def test_placements_match_jax(kind, axes):
    jspec, jp, spec, tp = _models(kind.split("-")[0])
    if kind.endswith("fused"):
        jp, tp = jfuse(jspec, jp), fuse_for_decode(spec, tp)
    want = list(_flat(jpspecs(jspec, jp, jmake_mesh(axes))))
    got = list(_flat(param_pspecs(spec, tp, Mesh.abstract(axes))))
    assert got == want
    if kind == "mla":
        assert ("/layers/0/mla_absorb/w_uk_t", ("tp", None, None)) in got


@pytest.mark.parametrize("p,shape", [
    (("tp", None), (8, 16)), ((None, "tp"), (8, 6)), (("tp", None), (1, 16)),
    ((None, "tp"), (3, 4)), (("ep", None, "tp"), (4, 8, 12)), ((None,), (5,)),
    (("dp",), (7, 3))])
def test_compatible_pspec_matches_jax(p, shape):
    from jax.sharding import PartitionSpec as JP

    axes = {"dp": 2, "ep": 4} if "ep" in p else {"dp": 2, "tp": 4}
    want = jcompat(JP(*p), shape, jmake_mesh(axes))
    assert tuple(compatible_pspec(P(*p), shape, Mesh.abstract(axes))) == tuple(want)


@pytest.mark.parametrize("arg", ["dp=2,tp=4", " tp=8 ", "dp=1,ep=2,tp=2,", "tp"])
def test_parse_mesh_arg_matches_jax(arg):
    try:
        want = jparse(arg)
    except ValueError as e:
        with pytest.raises(ValueError, match="name=size"):
            parse_mesh_arg(arg)
        assert "name=size" in str(e)
        return
    assert parse_mesh_arg(arg) == want


def test_make_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match="mesh needs 4 ranks, have 1"):
        make_mesh({"dp": 1, "tp": 4})
    with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
        jmake_mesh({"tp": 16})
    mesh = make_mesh({"dp": 1, "tp": 1})
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.groups == {"dp": None, "tp": None}


def _shards(spec, params, axes, axis="tp"):
    """Each rank's (local spec, tree) of ``axes``, cut on the host."""
    return [shard_params(spec, params, Mesh.abstract(axes, {axis: r}), device="cpu")
            for r in range(axes[axis])]


def _codes(w, k):
    """The (K, N) nibbles of a split-half packed payload."""
    return torch.cat([w & 0x0F, w >> 4], dim=-2)[..., :k, :]


@pytest.mark.parametrize("kind,tp", [("dense", 2), ("dense", 4), ("nvfp4", 2), ("nvfp4", 4)])
def test_row_parallel_shards_are_the_whole_codes(kind, tp):
    """o_proj and down_proj: each rank's logical rows of K, re-packed
    split-half; put back together, the whole weight's codes and scales,
    bit for bit."""
    _, _, spec, params = _models(kind)
    shards = _shards(spec, params, {"tp": tp})
    for path in (("o_proj",), ("mlp", "down_proj")):
        whole = params["layers"][1]
        for key in path:
            whole = whole[key]
        parts = []
        for _, tree in shards:
            x = tree["layers"][1]
            for key in path:
                x = x[key]
            assert isinstance(x, RowParallel)
            parts.append(x.shard)
        k = whole.in_features
        assert all(p.in_features == k // tp for p in parts)
        codes = torch.cat([_codes(p.weight, p.in_features) for p in parts], dim=0)
        assert torch.equal(codes, _codes(whole.weight, k))
        g = whole.meta_dict["group_size"]
        scale = torch.cat([p.scale for p in parts], dim=0)
        if k // tp >= g:
            assert torch.equal(scale, whole.scale)
        else:  # a shard inside one group keeps that group's row
            assert torch.equal(scale, whole.scale.repeat_interleave(g * tp // k, dim=0))
        x = torch.randn((3, k), generator=torch.Generator().manual_seed(0)).float()
        kl = k // tp
        part_sum = sum(x[:, i * kl:(i + 1) * kl] @ p.dequantize(torch.float32)
                       for i, p in enumerate(parts))
        torch.testing.assert_close(part_sum, x @ whole.dequantize(torch.float32),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_column_shards_follow_heads_and_fused_segments(tp):
    """q/k/v and gate/up, plain and fused: each rank's heads of q, its KV
    heads (at tp 4 the 2 KV heads are replicated and each rank keeps the
    one its query heads read), its slices of gate and up."""
    _, _, spec, params = _models("dense")
    fused = fuse_for_decode(spec, params)
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    F_ = spec.intermediate_size
    for tree in (params, fused):
        for r, (lspec, local) in enumerate(_shards(spec, tree, {"tp": tp})):
            H_l = H // tp
            kv0, KV_l = ((r * KV // tp, KV // tp) if KV % tp == 0
                         else ((r * H_l) // (H // KV), 1))
            assert (lspec.num_heads, lspec.num_kv_heads) == (H_l, KV_l)
            lay, whole = local["layers"][0], params["layers"][0]
            if "qkv_proj" in lay:
                w = lay["qkv_proj"].weight
                q_w, k_w, v_w = torch.split(w, [H_l * hd, KV_l * hd, KV_l * hd], dim=1)
                gu = lay["mlp"]["gateup_proj"].weight
                g_w, u_w = torch.chunk(gu, 2, dim=1)
            else:
                q_w, k_w, v_w = (lay[n].weight for n in ("q_proj", "k_proj", "v_proj"))
                g_w, u_w = lay["mlp"]["gate_proj"].weight, lay["mlp"]["up_proj"].weight
            assert torch.equal(q_w, whole["q_proj"].weight[:, r * H_l * hd:(r + 1) * H_l * hd])
            for got, name in ((k_w, "k_proj"), (v_w, "v_proj")):
                assert torch.equal(got, whole[name].weight[:, kv0 * hd:(kv0 + KV_l) * hd])
            fl = F_ // tp
            assert torch.equal(g_w, whole["mlp"]["gate_proj"].weight[:, r * fl:(r + 1) * fl])
            assert torch.equal(u_w, whole["mlp"]["up_proj"].weight[:, r * fl:(r + 1) * fl])


@pytest.mark.parametrize("axes", [{"ep": 2}, {"ep": 4}, {"tp": 2}])
def test_expert_stacks_split_on_the_expert_axis(axes):
    _, _, spec, params = _models("moe")
    axis = next(iter(axes))
    shards = _shards(spec, params, axes, axis)
    n = axes[axis]
    for name in ("gate_proj", "up_proj", "down_proj"):
        whole = params["layers"][0]["moe"][name]
        parts = [tree["layers"][0]["moe"][name] for _, tree in shards]
        assert [(p.shards, p.first) for p in parts] == [
            (n, r * spec.num_experts // n) for r in range(n)]
        for field in ("weight", "scale"):
            assert torch.equal(torch.cat([getattr(p, field) for p in parts]),
                               getattr(whole, field))
        assert tl.infer_expert_shards(shards[0][1]) == n
    assert tl.infer_expert_shards(params) == 1


def test_mla_heads_and_the_absorbed_weights():
    _, _, spec, params = _models("mla")
    shards = _shards(spec, params, {"tp": 2})
    whole = params["layers"][0]
    for key in ("w_uk_t", "w_uv"):
        assert torch.equal(torch.cat([t["layers"][0]["mla_absorb"][key] for _, t in shards]),
                           whole["mla_absorb"][key])
    for name in ("q_b_proj", "kv_b_proj"):
        assert torch.equal(torch.cat([t["layers"][0][name].weight for _, t in shards], dim=1),
                           whole[name].weight)
    for name in ("q_a_proj", "kv_a_proj_with_mqa"):  # the latent projections stay whole
        assert all(torch.equal(t["layers"][0][name].weight, whole[name].weight)
                   for _, t in shards)
    assert shards[0][0].num_heads == spec.num_heads // 2


def test_capacity_plan_of_a_rank_tree_matches_jax():
    """A rank's tree under ep 2, its stacks holding half the experts, plans
    the bytes JAX's plan gives the whole tree with expert_shards 2."""
    jspec, jp, spec, params = _models("moe")
    (_, local), _ = _shards(spec, params, {"ep": 2}, "ep")
    assert tl.infer_expert_shards(local) == 2
    for hbm in (10 ** 6, 10 ** 9):
        want = jl.nvfp4_capacity_plan(jp, hbm_bytes=hbm, expert_shards=2)
        assert tl.nvfp4_capacity_plan(local, hbm_bytes=hbm, expert_shards=2) == want
        assert tl.nvfp4_capacity_plan(params, hbm_bytes=hbm, expert_shards=2) == want


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_follow_the_compatible_rule(tp):
    """An MLP width that tp does not divide: the placements keep gate, up
    and down whole (the compatible rule), and the shards do too; the
    attention is still split on its heads."""
    spec = ModelSpec.tiny(hidden_size=128, intermediate_size=257)
    jspec = JSpec.tiny(hidden_size=128, intermediate_size=257)
    params = params_from_numpy(jinit(jspec, jax.random.PRNGKey(2)), device="cpu")
    mesh = Mesh.abstract({"tp": tp})
    places = param_pspecs(spec, params, mesh)
    mlp = params["layers"][0]["mlp"]
    for name in ("gate_proj", "up_proj", "down_proj"):
        lin = mlp[name]
        shape = (lin.in_features, lin.out_features)
        assert all(a is None for a in compatible_pspec(
            places["layers"][0]["mlp"][name].weight, shape, mesh))
    for r, (lspec, local) in enumerate(_shards(spec, params, {"tp": tp})):
        lay = local["layers"][0]
        for name in ("gate_proj", "up_proj", "down_proj"):
            assert not isinstance(lay["mlp"][name], RowParallel)
            assert torch.equal(lay["mlp"][name].weight, mlp[name].weight)
        assert isinstance(lay["o_proj"], RowParallel)
        assert lay["q_proj"].out_features == spec.q_dim // tp


@pytest.mark.parametrize("k,on_cpu,on_card", [
    (9728, True, True), (4864, False, True), (2432, False, True), (2400, False, False)])
def test_w4_route_at_tensor_parallel_k(k, on_cpu, on_card):
    """Qwen3-4B's down_proj (K 9728) and its row-parallel shards at tp 2
    and 4 (K 4864, 2432): on the card K1 takes them (its own conditions,
    8 | K/2); a weight on the CPU keeps the JAX kernel's tiling (8g | K/2),
    so there the shards take the dequantize route. K 2400 (2g = 64 does
    not divide it) is refused on both."""
    import dataclasses
    from types import SimpleNamespace

    from quantizers_tpu_torch.ops import kernels as K

    n, g = 256, 32
    lin = tl.QuantLinear(kind="w4", weight=torch.zeros((k // 2, n), dtype=torch.uint8),
                         scale=torch.ones((k // g, n), dtype=torch.bfloat16),
                         meta=(("k", k), ("n", n), ("group_size", g)))
    card = dataclasses.replace(lin, weight=SimpleNamespace(device=torch.device("cuda", 0),
                                                           dtype=torch.uint8))
    assert K.supports(lin) is on_cpu
    assert K.supports(card) is on_card


@pytest.mark.parametrize("env", [None, "off", "0", "none", "", "custom"])
def test_enable_persistent_cache(env, monkeypatch, tmp_path):
    saved = (_build._BUILD_ROOT, _build._TMP_ROOT)
    custom = str(tmp_path / "cache")
    try:
        if env is None:
            monkeypatch.delenv("QTPU_JIT_CACHE", raising=False)
        else:
            monkeypatch.setenv("QTPU_JIT_CACHE", custom if env == "custom" else env)
        got = enable_persistent_cache()
        if env in ("off", "0", "none", ""):
            assert got is None and jjit.enable_persistent_cache() is None
            assert _build.build_root() != _build.DEFAULT_BUILD_ROOT
        else:
            want = custom if env == "custom" else str(_build.DEFAULT_BUILD_ROOT)
            assert got == want and _build.build_root() == Path(want)
        assert enable_persistent_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
        assert _build.build_root() == tmp_path / "arg"
    finally:
        _build._BUILD_ROOT, _build._TMP_ROOT = saved


_RACE = r"""
import os, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from quantizers_tpu_torch.ops import _build

root, start = Path(sys.argv[2]), float(sys.argv[3])

def stub(out_dir):
    with open(root / "compiles.log", "a") as f:
        f.write(f"{os.getpid()}\n")
    time.sleep(0.5)
    (out_dir / "libqtt_kernels.so").write_text(str(os.getpid()))
    return "stub"

_build._compile = stub
_build.set_build_root(root)
while time.time() < start:
    time.sleep(0.005)
path = _build.library_path()
print(path, path.read_text())
"""


def test_build_install_under_two_processes_at_once(tmp_path):
    """Two processes build the same hash at once: one compiles and installs
    its library, the other waits and takes it; neither raises or removes
    the other's directory."""
    import time

    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(ROOT), str(tmp_path), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].split()[0] for o in outs}
    winners = {o[0].split()[1] for o in outs}
    assert len(paths) == 1 and len(winners) == 1
    assert (tmp_path / "compiles.log").read_text().split() == list(winners)
    lib = Path(paths.pop())
    assert lib.read_text() == winners.pop() and lib.parent.parent == tmp_path
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("build-")]
