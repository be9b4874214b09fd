"""Port parity for run configs, ``validate_config`` and ``recombine``.

* Run configs (``config.py``) load into the same fields in both packages,
  and refuse alike.
* ``tools/recombine.ModelMerger`` writes the golden mixed-precision
  ``quantization_config`` of ``tests/test_golden_config.py`` (the
  reference's literal), key for key, as the JAX package's merger does;
  the first-party schema writer and the scheme round trip agree too.
* ``cli/validate_config`` prints the same report and returns the same code.
* ``cli/recombine`` on two checkpoints written by the JAX package's
  ``model_free`` CLI (an FP8 primary, with one module's scale renamed to
  ``weight_scale_inv``, and a W4A16 secondary) writes the same files as the
  JAX CLI: every tensor equal bit for bit, the same index and config; a
  swap target missing from the secondary keeps all its primary tensors;
  ``--dry-run`` writes nothing.
"""

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from quantizers_tpu import config as jcfg
from quantizers_tpu.cli.make_tiny_model import main as jmake_tiny
from quantizers_tpu.cli.model_free import main as jmodel_free
from quantizers_tpu.cli.recombine import main as jrecombine
from quantizers_tpu.cli.validate_config import main as jvalidate
from quantizers_tpu.core.scheme import QuantScheme as JScheme
from quantizers_tpu.formats.compressed_tensors import build_quantization_config as jbuild
from quantizers_tpu.tools.recombine import ModelMerger as JMerger
from quantizers_tpu_torch import config as tcfg
from quantizers_tpu_torch.cli.recombine import main as recombine
from quantizers_tpu_torch.cli.validate_config import main as validate
from quantizers_tpu_torch.core.scheme import QuantScheme
from quantizers_tpu_torch.formats.compressed_tensors import build_quantization_config
from quantizers_tpu_torch.formats.safetensors_io import ShardedReader, ShardedWriter
from quantizers_tpu_torch.tools.recombine import ModelMerger

ROOT = Path(__file__).resolve().parent.parent


def _golden_module():
    spec = importlib.util.spec_from_file_location("_jax_test_golden_config",
                                                  ROOT / "tests" / "test_golden_config.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _golden_module()


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as exc:  # the refusals are compared, not raised
        return ("raised", type(exc).__name__, str(exc))
    return ("ok", json.loads(json.dumps(dataclasses.asdict(out), default=str)))


def _run_configs(tmp_path):
    """The run configs of tests/test_calibration_sets.py's TestRunConfig."""
    fixtures = ROOT / "tests" / "fixtures"
    (tmp_path / "calibration_sets").mkdir()
    (tmp_path / "calibration_sets" / "mini.yaml").write_text(
        "calibration_set:\n  datasets:\n"
        f"    - dataset: \"{fixtures / 'qa_pairs'}\"\n"
        "      split: train\n      columns: [question, answer]\n"
        "      formatter: prompt_answer\n      num_samples: 2\n")
    runs = {
        "suffixless_calibration_set": "model:\n  name: test/model\n  revision: abc\n"
        "quantization:\n  recipe: recipes/r.yaml\ncalibration_set: calibration_sets/mini\n",
        "configs_prefix": "model:\n  name: m\nquantization:\n  recipe: r.yaml\n"
        "calibration_set: configs/calibration_sets/mini.yaml\n",
        "no_model_name": "model: {}\nquantization:\n  recipe: r\n",
        "no_recipe": "model:\n  name: m\n",
        "missing_calibration_set": "model:\n  name: m\nquantization:\n  recipe: r\n"
        "calibration_set: calibration_sets/none.yaml\n",
    }
    paths = {}
    for name, text in runs.items():
        paths[name] = tmp_path / f"{name}.yaml"
        paths[name].write_text(text)
    paths["missing_file"] = tmp_path / "nope.yaml"
    paths["repo_tiny_awq"] = ROOT / "configs" / "test-quantize_tiny-awq.yaml"
    return paths


def test_run_configs_load_the_same(tmp_path):
    paths = _run_configs(tmp_path)
    for name, path in paths.items():
        got = _outcome(tcfg.load_quantization_config, str(path))
        assert got == _outcome(jcfg.load_quantization_config, str(path)), name
    assert _outcome(tcfg.load_quantization_config, str(paths["no_model_name"]))[0] == "raised"
    assert tcfg.load_yaml(str(paths["configs_prefix"])) == jcfg.load_yaml(
        str(paths["configs_prefix"]))


@pytest.fixture()
def merged_configs(tmp_path):
    """Both mergers' config writers over the golden test's fixture configs."""
    G._write_cfg(tmp_path / "fp8", {
        "model_type": "minimax", "hidden_size": 3072, "torch_dtype": "bfloat16",
        "quantization_config": {
            "quant_method": "compressed-tensors", "format": "float-quantized",
            "quantization_status": "compressed",
            "config_groups": {"group_0": copy.deepcopy(G.GOLDEN["config_groups"]["group_0"])},
            "ignore": [], "version": G.GOLDEN["version"]}})
    G._write_cfg(tmp_path / "w4", {
        "model_type": "minimax",
        "quantization_config": {
            "quant_method": "compressed-tensors", "format": "pack-quantized",
            "quantization_status": "compressed",
            "config_groups": {"group_0": copy.deepcopy(G.GOLDEN["config_groups"]["group_1"])},
            "ignore": list(G.GOLDEN_IGNORE), "version": G.GOLDEN["version"]}})
    out = {}
    for name, cls in (("torch", ModelMerger), ("jax", JMerger)):
        (tmp_path / name).mkdir()
        cls(tmp_path / "fp8", tmp_path / "w4", tmp_path / name)._write_config()
        out[name] = (tmp_path / name / "config.json").read_text()
    return out


def test_golden_config_written_byte_for_byte(merged_configs):
    assert merged_configs["torch"] == merged_configs["jax"]
    got = json.loads(merged_configs["torch"])
    assert got["quantization_config"] == G.GOLDEN
    assert list(got["quantization_config"]["config_groups"]) == ["group_0", "group_1"]
    assert (got["model_type"], got["hidden_size"], got["torch_dtype"]) == (
        "minimax", 3072, "bfloat16")


def test_first_party_schema_is_the_same():
    bodies = G.GOLDEN["config_groups"]
    got = build_quantization_config({k: QuantScheme.from_dict(v) for k, v in bodies.items()},
                                    G.GOLDEN_IGNORE)
    assert got == jbuild({k: JScheme.from_dict(v) for k, v in bodies.items()}, G.GOLDEN_IGNORE)
    for gname, body in bodies.items():
        assert QuantScheme.from_dict(body).to_dict() == JScheme.from_dict(body).to_dict(), gname


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A tiny model, its FP8 and W4A16 model-free checkpoints (JAX CLI), and
    a copy of the FP8 one whose first q_proj scale is stored as
    ``weight_scale_inv`` and whose W4 twin lacks every q_proj tensor."""
    d = tmp_path_factory.mktemp("recombine")
    assert jmake_tiny([str(d / "tiny"), "--vocab", "300", "--platform", ""]) == 0
    assert jmodel_free([str(d / "tiny"), str(d / "fp8")]) == 0
    assert jmodel_free([str(d / "tiny"), str(d / "w4"), "--scheme", "W4A16_G32"]) == 0
    for src, dst, keep in (
            ("fp8", "fp8_inv", lambda n: True),
            ("w4", "w4_no_q", lambda n: "q_proj" not in n)):
        (d / dst).mkdir()
        for f in (d / src).iterdir():
            if f.suffix != ".safetensors" and f.name != "model.safetensors.index.json":
                (d / dst / f.name).write_bytes(f.read_bytes())
        r = ShardedReader(d / src)
        inv = "model.layers.0.self_attn.q_proj.weight_scale"
        w = ShardedWriter(d / dst)
        w.add_many({(n + "_inv" if dst == "fp8_inv" and n == inv else n): r.get(n)
                    for n in r.keys() if keep(n)})
        w.finalize(metadata={"format": "pt"})
    return d


def _same_dirs(a: Path, b: Path):
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    assert (a / "config.json").read_text() == (b / "config.json").read_text()
    ia = json.loads((a / "model.safetensors.index.json").read_text())
    assert ia == json.loads((b / "model.safetensors.index.json").read_text())
    ra, rb = ShardedReader(a), ShardedReader(b)
    assert sorted(ra.keys()) == sorted(rb.keys())
    for n in ra.keys():
        x, y = ra.get(n), rb.get(n)
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), n
    return ia["weight_map"]


RECOMBINES = {
    "swap_mlp": ("fp8_inv", "w4", [r".*mlp\.(gate|up|down)_proj$"]),
    "missing_swap_target": ("fp8", "w4_no_q", [r".*self_attn\.q_proj$"]),
    "default_patterns": ("fp8_inv", "w4", None),
}


@pytest.mark.parametrize("case", sorted(RECOMBINES))
def test_recombine_writes_the_same_checkpoint(case, ckpts, tmp_path, capsys):
    prim, sec, swap = RECOMBINES[case]
    argv = [str(ckpts / prim), str(ckpts / sec)]
    extra = [] if swap is None else ["--swap-pattern", swap[0]]
    assert jrecombine(argv + [str(tmp_path / "j")] + extra) == 0
    want_stats = capsys.readouterr().out
    assert recombine(argv + [str(tmp_path / "t")] + extra) == 0
    assert capsys.readouterr().out == want_stats
    names = _same_dirs(tmp_path / "t", tmp_path / "j")
    qcfg = json.loads((tmp_path / "t" / "config.json").read_text())["quantization_config"]
    assert qcfg["format"] == "mixed-precision" and len(qcfg["config_groups"]) == 2
    if case == "swap_mlp":
        assert "renamed_scale_inv=1" in want_stats
        assert "model.layers.0.self_attn.q_proj.weight_scale" in names
        assert "model.layers.0.mlp.down_proj.weight_packed" in names
    if case == "missing_swap_target":
        prim_q = [n for n in ShardedReader(ckpts / "fp8").keys() if "self_attn.q_proj" in n]
        assert prim_q and all(n in names for n in prim_q)


def test_recombine_dry_run_writes_nothing(ckpts, tmp_path, capsys):
    argv = [str(ckpts / "fp8"), str(ckpts / "fp8"), str(tmp_path / "never"), "--dry-run"]
    assert jrecombine(argv) == 0
    want = capsys.readouterr().out
    assert recombine(argv) == 0
    assert capsys.readouterr().out == want and not (tmp_path / "never").exists()


@pytest.mark.parametrize("target", ["fp8", "w4", "tiny", "fp8/config.json"])
def test_validate_config_reports_the_same(target, ckpts, capsys):
    rc_j = jvalidate([str(ckpts / target)])
    want = capsys.readouterr()
    rc_t = validate([str(ckpts / target)])
    got = capsys.readouterr()
    assert (rc_t, got.out, got.err) == (rc_j, want.out, want.err)
    assert rc_t == (1 if target == "tiny" else 0)
