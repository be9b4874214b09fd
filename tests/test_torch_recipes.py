"""Port parity for recipes: every recipe text of ``tests/test_recipes.py`` and
every file of ``configs/recipes/`` parses to the same ``Recipe`` in both
packages (compared field for field, exactly), the recipe-path resolution
gives the same paths, and both refuse the same inputs with the same error.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from quantizers_tpu import recipes as jr
from quantizers_tpu_torch import recipes as tr

ROOT = Path(__file__).resolve().parent.parent


def _jax_test_module():
    spec = importlib.util.spec_from_file_location("_jax_test_recipes",
                                                  ROOT / "tests" / "test_recipes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the recipe texts of the JAX package's recipe tests (module-level strings)
TEXTS = {k: v for k, v in vars(_jax_test_module()).items() if k.isupper() and isinstance(v, str)}
FILES = sorted((ROOT / "configs" / "recipes").glob("*.yaml"))


def canon(recipe) -> dict:
    """A recipe as plain JSON data: dataclasses as dicts, enums (str
    enums) as their values, tuples as lists."""
    return json.loads(json.dumps(dataclasses.asdict(recipe), default=str))


def test_the_cases_are_all_there():
    assert len(TEXTS) >= 8 and len(FILES) >= 12


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_recipe_texts_parse_the_same(name):
    got, want = tr.parse_recipe(TEXTS[name]), jr.parse_recipe(TEXTS[name])
    assert got.modifiers and canon(got) == canon(want)
    assert canon(got)["modifiers"][0]["name"] == want.modifiers[0].name


@pytest.mark.parametrize("path", FILES, ids=[p.stem for p in FILES])
def test_recipe_files_parse_the_same(path):
    got, want = tr.parse_recipe(str(path)), jr.parse_recipe(str(path))
    assert canon(got) == canon(want)
    kv, jkv = got.kv_cache_scheme(), want.kv_cache_scheme()
    assert (kv is None) == (jkv is None)
    if kv is not None:
        assert kv.to_dict() == jkv.to_dict()


def test_default_awq_mappings_are_the_same():
    assert ([dataclasses.asdict(m) for m in tr.DEFAULT_AWQ_MAPPINGS]
            == [dataclasses.asdict(m) for m in jr.DEFAULT_AWQ_MAPPINGS])
    assert tr.KNOWN_MODIFIERS == jr.KNOWN_MODIFIERS


@pytest.mark.parametrize("source,match", [
    ({"not_a_stage": {}}, "no modifiers"),
    ("/no/such/recipe.yaml", "not found"),
], ids=["empty", "missing_file"])
def test_both_refuse_the_same_recipes(source, match):
    for mod in (jr, tr):
        with pytest.raises(ValueError, match=match):
            mod.parse_recipe(source)


def test_recipe_paths_resolve_the_same(tmp_path):
    (tmp_path / "recipes").mkdir()
    target = tmp_path / "recipes" / "r.yaml"
    target.write_text(TEXTS["NVFP4_RECIPE"])
    run_cfg = tmp_path / "run.yaml"
    run_cfg.write_text("x: 1")
    direct = tmp_path / "direct.yaml"
    direct.write_text(TEXTS["NVFP4_RECIPE"])
    for args in (("r.yaml", str(run_cfg)), (str(direct),),
                 ("configs/recipes/recipe_dense_nvfp4.yaml",)):
        assert tr.resolve_recipe_path(*args) == jr.resolve_recipe_path(*args)
    assert tr.resolve_recipe_path("r.yaml", str(run_cfg)) == str(target)
    for mod in (jr, tr):
        with pytest.raises(ValueError, match="not found"):
            mod.resolve_recipe_path("missing.yaml")
