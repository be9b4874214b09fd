"""Recipe parsing: llmcompressor-dialect YAML → modifier specifications.

Counterpart of ``quantizers_tpu/recipes.py``, the same code over the port's
``core.scheme``. The reference passes recipe files verbatim to llmcompressor
(``do_oneshot.py:179-187``); this module makes those same files first-class
inputs of the port's pipeline. All dialects present in the reference's
``configs/recipes/`` parse:

* ``default_stage: default_modifiers: {Modifier: {...}}``
  (``recipe_AR_W4A16G32.yaml``, ``recipe_Dense_NVFP4.yaml``);
* ``<any>_stage: <any>_modifiers:`` with several modifiers in one stage
  (``recipe_mixed_fp8_int4.yaml`` — FP8_BLOCK attention + AWQ INT4 MLP);
* top-level ``modifiers:`` list with ``name:`` entries
  (``recipe_Minimax-M2.1-AWQ-MixedPrec.yaml``);
* inline recipe strings (``quantization_multiple_modifiers.py:58-91``).

Modifier bodies may carry ``scheme:`` presets (NVFP4, FP8_BLOCK, ...),
explicit ``config_groups`` with weights/input_activations dicts, AWQ
``mappings``/``duo_scaling``, GPTQ ``dampening_frac``/``block_size``,
AutoRound ``iters``, and ``kv_cache_scheme``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

from .core.scheme import QuantizationArgs, QuantScheme, resolve_scheme

KNOWN_MODIFIERS = (
    "QuantizationModifier",
    "AWQModifier",
    "GPTQModifier",
    "AutoRoundModifier",
    "SmoothQuantModifier",
)


@dataclasses.dataclass
class AWQMapping:
    smooth_layer: str
    balance_layers: List[str]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AWQMapping":
        return cls(smooth_layer=d["smooth_layer"], balance_layers=list(d["balance_layers"]))


#: Default smooth/balance mappings for standard HF decoder naming — applied
#: when an AWQ recipe ships no explicit ``mappings`` (llmcompressor behavior;
#: per-arch derivations noted at reference ``main_devstral-gptq.py:167-193``).
DEFAULT_AWQ_MAPPINGS = [
    AWQMapping("re:.*input_layernorm$", ["re:.*q_proj$", "re:.*k_proj$", "re:.*v_proj$"]),
    AWQMapping("re:.*v_proj$", ["re:.*o_proj$"]),
    AWQMapping("re:.*post_attention_layernorm$", ["re:.*gate_proj$", "re:.*up_proj$"]),
    AWQMapping("re:.*up_proj$", ["re:.*down_proj$"]),
]


@dataclasses.dataclass
class ModifierSpec:
    """One quantization modifier: algorithm + config groups + knobs."""

    name: str
    config_groups: Dict[str, QuantScheme]
    ignore: List[str] = dataclasses.field(default_factory=list)
    # algorithm knobs
    mappings: List[AWQMapping] = dataclasses.field(default_factory=list)
    duo_scaling: bool = True
    dampening_frac: float = 0.01
    block_size: int = 128
    iters: int = 200
    kv_cache_scheme: Optional[QuantizationArgs] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def targets_all(self) -> List[str]:
        out: List[str] = []
        for scheme in self.config_groups.values():
            out.extend(scheme.targets)
        return out


@dataclasses.dataclass
class Recipe:
    modifiers: List[ModifierSpec]
    pipeline: str = "sequential"  # sequential | independent | basic
    raw: Optional[Dict[str, Any]] = None

    def kv_cache_scheme(self) -> Optional[QuantizationArgs]:
        for m in self.modifiers:
            if m.kv_cache_scheme is not None:
                return m.kv_cache_scheme
        return None


def _looks_like_scheme_body(body: Any) -> bool:
    return isinstance(body, dict) and ("weights" in body or "input_activations" in body or "targets" in body)


def _extract_config_groups(body: Dict[str, Any]) -> Dict[str, QuantScheme]:
    """Pull config groups out of a modifier body, tolerating the dialects:
    explicit ``config_groups``, a ``scheme:`` preset + ``targets``, or
    stray nested dicts that *are* groups (``recipe_mixed_fp8_int4.yaml``'s
    ``mlp_experts_projections: group_0: {...}``)."""
    groups: Dict[str, QuantScheme] = {}

    cg = body.get("config_groups")
    if isinstance(cg, dict):
        for gname, gbody in cg.items():
            groups[gname] = QuantScheme.from_dict(gbody)

    if "scheme" in body:
        scheme = resolve_scheme(body["scheme"])
        targets = body.get("targets", list(scheme.targets))
        if isinstance(targets, str):
            targets = [_clean_target(targets)]
        else:
            targets = [_clean_target(t) for t in targets]
        groups[f"group_{len(groups)}"] = dataclasses.replace(scheme, targets=tuple(targets))

    # stray nested group containers
    reserved = {
        "config_groups", "scheme", "targets", "ignore", "mappings", "duo_scaling",
        "dampening_frac", "block_size", "iters", "kv_cache_scheme", "offload_device",
        "observer", "actorder", "sequential_update", "num_calibration_steps",
    }
    for key, val in body.items():
        if key in reserved or not isinstance(val, dict):
            continue
        if _looks_like_scheme_body(val):
            groups[key] = QuantScheme.from_dict(val)
        else:
            for sub_key, sub_val in val.items():
                if _looks_like_scheme_body(sub_val):
                    groups[f"{key}.{sub_key}"] = QuantScheme.from_dict(sub_val)

    return groups


def _clean_target(target: str) -> str:
    # tolerate raw-string spellings like r"re:..." that survive YAML
    t = target.strip()
    if t.startswith('r"') and t.endswith('"'):
        t = t[2:-1]
    return t


def _parse_modifier(name: str, body: Dict[str, Any]) -> ModifierSpec:
    body = body or {}
    groups = _extract_config_groups(body)

    ignore = body.get("ignore") or []
    if isinstance(ignore, str):
        ignore = [ignore]

    mappings = [AWQMapping.from_dict(m) for m in body.get("mappings") or []]
    if name == "AWQModifier" and not mappings:
        mappings = list(DEFAULT_AWQ_MAPPINGS)

    kv = body.get("kv_cache_scheme")
    kv_args = QuantizationArgs.from_dict(kv) if kv else None

    known = {
        "config_groups", "scheme", "targets", "ignore", "mappings", "duo_scaling",
        "dampening_frac", "block_size", "iters", "kv_cache_scheme",
    }
    extra = {k: v for k, v in body.items() if k not in known and not isinstance(v, dict)}

    return ModifierSpec(
        name=name,
        config_groups=groups,
        ignore=[_clean_target(i) for i in ignore],
        mappings=mappings,
        duo_scaling=bool(body.get("duo_scaling", True)),
        dampening_frac=float(body.get("dampening_frac", 0.01)),
        block_size=int(body.get("block_size", 128)),
        iters=int(body.get("iters", 200)),
        kv_cache_scheme=kv_args,
        extra=extra,
    )


def parse_recipe(source: Union[str, Path, Dict[str, Any]]) -> Recipe:
    """Parse a recipe from a YAML file path, a YAML string, or a dict."""
    if isinstance(source, Path) or (isinstance(source, str) and "\n" not in source and source.endswith((".yaml", ".yml"))):
        p = Path(source)
        if not p.exists():
            raise ValueError(f"Recipe file not found: {source}")
        data = yaml.safe_load(p.read_text()) or {}
    elif isinstance(source, str):
        data = yaml.safe_load(source) or {}
    else:
        data = dict(source)

    modifiers: List[ModifierSpec] = []

    # dialect A: top-level `modifiers:` list with `name:` entries
    for item in data.get("modifiers") or []:
        if isinstance(item, dict) and "name" in item:
            body = {k: v for k, v in item.items() if k != "name"}
            modifiers.append(_parse_modifier(item["name"], body))

    # dialect B: *_stage -> *_modifiers -> {ModifierName: body}
    for stage_key, stage in data.items():
        if not isinstance(stage, dict) or not stage_key.endswith("_stage"):
            continue
        for mods_key, mods in stage.items():
            if not isinstance(mods, dict) or not mods_key.endswith("_modifiers"):
                continue
            for mod_name, body in mods.items():
                modifiers.append(_parse_modifier(mod_name, body or {}))

    # dialect C: bare {ModifierName: body} at top level
    for key, body in data.items():
        if key in KNOWN_MODIFIERS:
            modifiers.append(_parse_modifier(key, body or {}))

    if not modifiers:
        raise ValueError(
            "Recipe contains no modifiers (expected a `*_stage:` block, a "
            "`modifiers:` list, or a bare modifier mapping)"
        )

    return Recipe(modifiers=modifiers, raw=data)


def resolve_recipe_path(recipe: str, config_path: Optional[str] = None, configs_root: str = "configs") -> str:
    """Resolve a run-config's recipe reference, with the reference CLI's
    fallback into the ``recipes/`` subdirectory (``do_oneshot.py:123-135``)."""
    cands: List[Path] = [Path(recipe)]
    if config_path:
        parent = Path(config_path).parent
        cands += [parent / recipe, parent / "recipes" / Path(recipe).name]
    cands += [Path(configs_root) / recipe, Path(configs_root) / "recipes" / Path(recipe).name]
    for c in cands:
        if c.exists():
            return str(c)
    raise ValueError(f"Recipe file not found: {recipe} (searched {[str(c) for c in cands]})")
