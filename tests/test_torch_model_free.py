"""Port parity for data-free PTQ (slice 7f) against the JAX package on the CPU.

* The port's ``model_free`` CLI against the JAX package's on the tiny dense
  and MoE models, with FP8_BLOCK and W4A16_G32: every tensor of the output
  shards equal, bit for bit (the same RTN codes and scales, and the same
  packing); the same index, ``config.json`` and copied assets; and
  ``model_free_ptq`` returns the same quantized prefixes.
* The output does not depend on ``max_workers``: a checkpoint written in 5+
  shards gives the same files with 8 workers as with 1 (the port reads on
  the calling thread and writes in the checkpoint's order).
* The port's ``model_free`` then the port's ``recombine`` loads, as the JAX
  package's ``tests/test_cli.py`` checks for its CLIs.
* Without a card and without ``--device cpu`` the CLI raises.
"""

import json
from pathlib import Path

import pytest
import torch

from quantizers_tpu.cli.model_free import main as jmodel_free
from quantizers_tpu.oneshot.model_free import model_free_ptq as jmodel_free_ptq
from quantizers_tpu_torch.cli import make_tiny_model
from quantizers_tpu_torch.cli.model_free import main as model_free
from quantizers_tpu_torch.cli.recombine import main as recombine
from quantizers_tpu_torch.cli.validate_config import main as validate
from quantizers_tpu_torch.formats.checkpoint import CompressedModelReader
from quantizers_tpu_torch.formats.safetensors_io import INDEX_NAME, ShardedReader, ShardedWriter
from quantizers_tpu_torch.oneshot import model_free_ptq

#: the reference's GLM-4.7-Flash-FP8 ignore policy
#: (configs/quantize_glm-4.7-flash-fp8.yaml:4-6)
GLM_IGNORE = ["lm_head", "re:.*mlp\\.gate$", "re:.*kv_a_proj_with_mqa$",
              "re:.*kv_a_layernorm$", "re:.*q_a_layernorm$", "re:.*embed_tokens$"]
ASSETS = {"tokenizer.json": '{"model": "tiny"}\n',
          "generation_config.json": '{"do_sample": false}\n'}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny dense and MoE models, each with two tokenizer assets."""
    d = tmp_path_factory.mktemp("model_free")
    for name, extra in (("dense", []), ("moe", ["--moe"])):
        assert make_tiny_model.main([str(d / name), "--vocab", "300", "--device", "cpu",
                                     *extra]) == 0
        for fname, text in ASSETS.items():
            (d / name / fname).write_text(text)
    return d


def _files(d: Path):
    return sorted(f.name for f in d.iterdir())


def _same_checkpoint(got: Path, want: Path) -> None:
    """Every tensor equal bit for bit (dtype, shape, bytes), and every other
    file equal byte for byte."""
    assert _files(got) == _files(want)
    with ShardedReader(got) as a, ShardedReader(want) as b:
        assert sorted(a.keys()) == sorted(b.keys()) and a.keys()
        assert a.weight_map == b.weight_map
        for name in b.keys():
            x, y = a.get(name), b.get(name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8)), name
    for f in _files(want):
        if not f.endswith(".safetensors"):
            assert (got / f).read_bytes() == (want / f).read_bytes(), f


@pytest.mark.parametrize("scheme", ["FP8_BLOCK", "W4A16_G32"])
@pytest.mark.parametrize("model", ["dense", "moe"])
def test_cli_matches_jax(model, scheme, tiny, tmp_path):
    src = tiny / model
    argv = ["--scheme", scheme]
    assert model_free([str(src), str(tmp_path / "port"), *argv, "--device", "cpu"]) == 0
    assert jmodel_free([str(src), str(tmp_path / "jax"), *argv]) == 0
    _same_checkpoint(tmp_path / "port", tmp_path / "jax")
    for name in ASSETS:
        assert (tmp_path / "port" / name).read_text() == ASSETS[name]
    assert validate([str(tmp_path / "port")]) == 0


def test_quantized_prefixes_match_jax(tiny, tmp_path):
    """The GLM ignore policy on the tiny MoE model: the same prefixes, in
    the same order; the router, the embeddings and the head stay plain."""
    src = tiny / "moe"
    got = model_free_ptq(src, tmp_path / "port", scheme="FP8_BLOCK", ignore=GLM_IGNORE,
                         device="cpu")
    want = jmodel_free_ptq(src, tmp_path / "jax", scheme="FP8_BLOCK", ignore=GLM_IGNORE)
    assert got == want and got
    assert not any(p.endswith("mlp.gate") or "embed" in p or "lm_head" in p for p in got)
    _same_checkpoint(tmp_path / "port", tmp_path / "jax")


def test_output_does_not_depend_on_max_workers(tiny, tmp_path):
    """A checkpoint in 5 or more shards (the reader keeps 2 open, so it
    closes maps while the pool works): 8 workers write the files 1 worker
    writes, byte for byte."""
    src = tmp_path / "sharded"
    with ShardedReader(tiny / "moe") as r:
        w = ShardedWriter(src, max_shard_bytes=24 * 1024)
        w.add_many({n: r.get(n) for n in r.keys()})
        files = w.finalize(metadata={"format": "pt"})
    (src / "config.json").write_bytes((tiny / "moe" / "config.json").read_bytes())
    assert len(files) >= 5
    outs = {}
    for workers in (8, 1):
        out = tmp_path / f"w{workers}"
        outs[workers] = model_free_ptq(src, out, scheme="W4A16_G32", max_workers=workers,
                                       max_shard_bytes=32 * 1024, device="cpu")
    assert outs[8] == outs[1]
    assert len(_files(tmp_path / "w8")) > 3
    for f in _files(tmp_path / "w1"):
        assert (tmp_path / "w8" / f).read_bytes() == (tmp_path / "w1" / f).read_bytes(), f


def test_model_free_then_recombine_loads(tiny, tmp_path):
    """The port's model_free (FP8_BLOCK and W4A16_G32), then the port's
    recombine: the hybrid is mixed precision and its swapped modules load
    as int4 by their stored parameters (JAX tests/test_cli.py:79-103)."""
    src = tiny / "dense"
    fp8, w4, hybrid = tmp_path / "fp8", tmp_path / "w4", tmp_path / "hybrid"
    assert model_free([str(src), str(fp8), "--device", "cpu"]) == 0
    assert validate([str(fp8)]) == 0
    assert model_free([str(src), str(w4), "--scheme", "W4A16_G32", "--device", "cpu"]) == 0
    assert recombine([str(fp8), str(w4), str(hybrid),
                      "--swap-pattern", r".*mlp\.(gate|up|down)_proj$"]) == 0
    qcfg = json.loads((hybrid / "config.json").read_text())["quantization_config"]
    assert qcfg["format"] == "mixed-precision"
    assert len(qcfg["config_groups"]) == 2
    assert (hybrid / INDEX_NAME).is_file()
    with CompressedModelReader(hybrid) as r:
        _, args = r.load_quantized("model.layers.0.mlp.down_proj", device="cpu")
        assert args.num_bits == 4
        _, args2 = r.load_quantized("model.layers.0.self_attn.q_proj", device="cpu")
        assert args2.num_bits == 8


def test_cli_needs_a_card_or_an_explicit_cpu(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_free([str(tiny / "dense"), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
