"""Enumeration of quantizable linear sites within one decoder layer.

Counterpart of ``quantizers_tpu/oneshot/sites.py``, the same code over the
port's params.

Bridges recipe-land (HF module paths like
``model.layers.3.mlp.experts.7.down_proj``, targeted by regexes in the
reference's recipes, e.g. ``recipe_MoE_RTN_NVFP4.yaml:19-21``) and the
params pytree (nested dicts of QuantLinear / ExpertLinears).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

from ..core.scheme import QuantScheme, is_ignored, match_targets
from ..models.config import ModelSpec


#: Mixtral/MiniMax-dialect module-path aliases: those checkpoints name the
#: MoE container ``block_sparse_moe`` and the expert projections w1/w3/w2
#: (= gate/up/down). Reference recipes target them directly
#: (``recipe_Minimax-M2.1-Experts-only-AWQ.yaml:17``), so every expert site
#: also answers to its aliased path.
_EXPERT_ALIASES = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}


@dataclasses.dataclass
class LinearSite:
    """One (possibly expert-stacked) linear inside a layer."""

    prefix: str  # HF module path; expert sites use `...experts.{e}.proj` with e elided
    name: str  # projection key, e.g. "q_proj"
    capture_key: str  # key in the apply_layer capture dict holding this site's input
    get: Callable[[], Any]  # -> QuantLinear | ExpertLinears
    set: Callable[[Any], None]
    is_expert: bool = False

    def expert_prefix(self, e: int) -> str:
        return self.prefix.replace("experts.*", f"experts.{e}")

    def alias_paths(self, e: int) -> List[str]:
        """All HF-dialect paths this site answers to for expert ``e``:
        the native Qwen-style path plus the Mixtral/MiniMax w1/w2/w3 form."""
        paths = [self.expert_prefix(e)]
        alias = _EXPERT_ALIASES.get(self.name)
        if self.is_expert and alias is not None:
            paths.append(
                self.expert_prefix(e)
                .replace(".mlp.experts.", ".block_sparse_moe.experts.")
                .replace(f".{self.name}", f".{alias}"))
        return paths


def layer_sites(spec: ModelSpec, layer_idx: int, layer: Dict[str, Any]) -> List[LinearSite]:
    p = f"model.layers.{layer_idx}"
    sites: List[LinearSite] = []

    def _mk(prefix: str, name: str, cap: str, container: Dict[str, Any], key: str,
            is_expert: bool = False) -> LinearSite:
        return LinearSite(
            prefix=prefix, name=name, capture_key=cap,
            get=lambda: container[key],
            set=lambda v: container.__setitem__(key, v),
            is_expert=is_expert,
        )

    if spec.is_mla:
        attn_projs = (("q_a_proj", "q_b_proj") if spec.q_lora_rank else ("q_proj",)
                      ) + ("kv_a_proj_with_mqa", "kv_b_proj", "o_proj")
    else:
        attn_projs = ("q_proj", "k_proj", "v_proj", "o_proj")
    for proj in attn_projs:
        sites.append(_mk(f"{p}.self_attn.{proj}", proj, proj, layer, proj))

    if spec.layer_is_moe(layer_idx):
        moe = layer["moe"]
        sites.append(_mk(f"{p}.mlp.gate", "router", "router", moe, "router"))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sites.append(_mk(
                f"{p}.mlp.experts.*.{proj}", proj, f"moe_{proj}", moe, proj,
                is_expert=True,
            ))
        if "shared_experts" in moe:
            shared = moe["shared_experts"]
            for proj in ("gate_proj", "up_proj", "down_proj"):
                sites.append(_mk(
                    f"{p}.mlp.shared_experts.{proj}", proj, f"shared_{proj}",
                    shared, proj,
                ))
    else:
        mlp = layer["mlp"]
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sites.append(_mk(f"{p}.mlp.{proj}", proj, proj, mlp, proj))
    return sites


def scheme_for_site(site: LinearSite, config_groups: Dict[str, QuantScheme],
                    ignore: List[str], num_experts: int = 0):
    """Resolve which config group (if any) quantizes this site; returns
    ``(group_name, scheme)`` or ``None``.

    Expert sites match if any concrete expert path matches (recipes address
    experts both as ``re:.*experts\\.\\d+\\.down_proj`` and as plain
    ``re:.*down_proj``), including the Mixtral/MiniMax
    ``block_sparse_moe...w1/w2/w3`` alias dialect."""
    paths = [site.prefix]
    if site.is_expert:
        paths = [p for e in range(max(1, num_experts))
                 for p in site.alias_paths(e)]
    for path in paths:
        if is_ignored(path, ignore):
            continue
        for group_name, scheme in config_groups.items():
            if match_targets(path, "Linear", list(scheme.targets)):
                return group_name, scheme
    return None
