"""Mixed-precision weight recombination (generalized ModelMerger).

Reimplements the capability of the reference's
``scripts/recombine_weights_MiniMax-M2.1.py``: merge a *primary* checkpoint
(e.g. FP8 block-quantized) with a *secondary* checkpoint (e.g. W4A16
pack-quantized experts) into one hybrid compressed-tensors model —
streaming shard-by-shard with a bounded shard LRU (:26,208-222), renaming
``*_proj.weight_scale_inv`` → ``weight_scale`` (:44-46,261-265), swapping
matched modules for the secondary's pack-quantized quintuple
(:54-65,269-274), preferring the secondary's AWQ-smoothed
``post_attention_layernorm`` weights (:275-282), rebuilding the index
(:341-356) and writing a two-config-group mixed-precision
``quantization_config`` (:75-138).

Counterpart of ``quantizers_tpu/tools/recombine.py`` over the port's
``formats/safetensors_io`` (torch tensors, copied as stored).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from ..formats.safetensors_io import (
    ShardedReader,
    ShardedWriter,
    dump_json,
    load_json,
    natural_sort_key,
)

logger = logging.getLogger(__name__)

#: pack-quantized parameter quintuple (compressed-tensors schema — the
#: contract the reference's merger swaps, :54-65)
PACK_QUANTIZED_SUFFIXES = (
    "weight_packed", "weight_scale", "weight_shape", "weight_zero_point",
    "weight_g_idx",
)


@dataclasses.dataclass
class MergeStats:
    copied: int = 0
    renamed_scale_inv: int = 0
    skipped_scale_inv: int = 0
    swapped_modules: int = 0
    swapped_tensors: int = 0
    preferred_secondary: int = 0

    def summary(self) -> str:
        return (f"copied={self.copied} renamed_scale_inv={self.renamed_scale_inv} "
                f"skipped_scale_inv={self.skipped_scale_inv} "
                f"swapped_modules={self.swapped_modules} "
                f"(tensors={self.swapped_tensors}) "
                f"preferred_secondary={self.preferred_secondary}")


class ModelMerger:
    """Merge primary + secondary checkpoints into a hybrid model.

    ``swap_pattern`` modules take the secondary's pack-quantized params;
    ``prefer_secondary_pattern`` tensors (e.g. smoothed layernorms) are
    copied from the secondary when present.
    """

    def __init__(
        self,
        primary_path: Union[str, Path],
        secondary_path: Union[str, Path],
        output_path: Union[str, Path],
        swap_pattern: str = r".*\.mlp\.experts\.\d+\.(gate|up|down)_proj$"
                            r"|.*\.(w1|w2|w3)$",
        prefer_secondary_pattern: str = r".*post_attention_layernorm\.weight$",
        dry_run: bool = False,
        max_shard_bytes: int = 5 * 1024**3,
    ) -> None:
        self.primary = Path(primary_path)
        self.secondary = Path(secondary_path)
        self.output = Path(output_path)
        self.swap_re = re.compile(swap_pattern)
        self.prefer_re = re.compile(prefer_secondary_pattern)
        self.dry_run = dry_run
        self.max_shard_bytes = max_shard_bytes
        self.stats = MergeStats()

    # -- classification ------------------------------------------------------
    @staticmethod
    def _module_prefix(name: str) -> Optional[str]:
        for suf in (".weight", ".bias") + tuple("." + s for s in PACK_QUANTIZED_SUFFIXES) + (
                ".weight_scale_inv", ".input_scale", ".weight_global_scale"):
            if name.endswith(suf):
                return name[: -len(suf)]
        return None

    def run(self) -> MergeStats:
        # both readers keep at most 2 shards resident (LRU in ShardedReader)
        with ShardedReader(self.primary) as prim, ShardedReader(self.secondary) as sec:
            sec_keys = set(sec.keys())
            sec_prefix_params: Dict[str, List[str]] = {}
            for k in sec_keys:
                pref = self._module_prefix(k)
                if pref is not None:
                    sec_prefix_params.setdefault(pref, []).append(k)

            writer = None
            if not self.dry_run:
                self.output.mkdir(parents=True, exist_ok=True)
                writer = ShardedWriter(self.output, max_shard_bytes=self.max_shard_bytes)

            emitted: set = set()
            swapped_prefixes: set = set()
            kept_primary_prefixes: set = set()

            def emit(name: str, arr_fn) -> None:
                if name in emitted:
                    return
                emitted.add(name)
                if writer is not None:
                    writer.add(name, arr_fn())

            for name in sorted(prim.keys(), key=natural_sort_key):
                prefix = self._module_prefix(name)

                # 1. scale_inv handling (reference :261-268). A prefix the
                # swap rule owns never renames: the secondary's quintuple
                # (incl. weight_scale) replaces the whole module, so the
                # primary's scale_inv is dropped regardless of whether the
                # swap branch has run yet — no reliance on sort order.
                if name.endswith(".weight_scale_inv"):
                    if (prefix is not None and self.swap_re.match(prefix)
                            and sec_prefix_params.get(prefix)):
                        self.stats.skipped_scale_inv += 1
                    elif prefix is not None and prefix.endswith("_proj"):
                        emit(f"{prefix}.weight_scale", lambda n=name: prim.get(n))
                        self.stats.renamed_scale_inv += 1
                    else:
                        self.stats.skipped_scale_inv += 1
                    continue

                # 2. module swap-in from secondary (reference :269-274).
                # A swap-rule prefix missing from the secondary keeps the
                # primary's tensors — ALL of them, not just the first one
                # encountered, so kept prefixes fall through to the
                # passthrough branch on every tensor.
                if (prefix is not None and self.swap_re.match(prefix)
                        and prefix not in kept_primary_prefixes):
                    if prefix not in swapped_prefixes:
                        sec_params = sec_prefix_params.get(prefix, [])
                        if sec_params:
                            swapped_prefixes.add(prefix)
                            self.stats.swapped_modules += 1
                            for sk in sorted(sec_params):
                                emit(sk, lambda n=sk: sec.get(n))
                                self.stats.swapped_tensors += 1
                            continue
                        logger.warning("swap target %s missing in secondary; "
                                       "keeping primary", prefix)
                        kept_primary_prefixes.add(prefix)
                        # fall through to passthrough for this tensor
                    else:
                        continue

                # 3. prefer secondary's (smoothed) tensor (reference :275-282)
                if self.prefer_re.match(name) and name in sec_keys:
                    emit(name, lambda n=name: sec.get(n))
                    self.stats.preferred_secondary += 1
                    continue

                # 4. passthrough
                emit(name, lambda n=name: prim.get(n))
                self.stats.copied += 1

            if writer is not None:
                writer.finalize(metadata={"format": "pt"})
                self._write_config()

        logger.info("merge %s: %s", "DRY RUN" if self.dry_run else "done",
                    self.stats.summary())
        return self.stats

    # -- config --------------------------------------------------------------
    def _write_config(self) -> None:
        """Hybrid config: primary's base config, mixed-precision
        quantization_config combining both models' config groups
        (reference :75-138)."""
        prim_cfg = load_json(self.primary / "config.json") if (
            self.primary / "config.json").exists() else {}
        sec_cfg = load_json(self.secondary / "config.json") if (
            self.secondary / "config.json").exists() else {}

        prim_q = (prim_cfg.get("quantization_config") or {})
        sec_q = (sec_cfg.get("quantization_config") or {})

        # group bodies are carried over VERBATIM (no re-normalization) so the
        # emitted config stays byte-identical to what the source checkpoints'
        # producers wrote — the ecosystem contract pinned by
        # tests/test_golden_config.py against the reference's literal output.
        groups: Dict[str, Any] = {}
        for q in (prim_q, sec_q):
            for body in (q.get("config_groups") or {}).values():
                groups[f"group_{len(groups)}"] = body
        ignore = list(dict.fromkeys(
            (prim_q.get("ignore") or []) + (sec_q.get("ignore") or [])))

        from ..formats.compressed_tensors import COMPRESSION_VERSION

        # full compressed-tensors schema, key order matching the reference's
        # create_mixed_precision_config literal (:75-138)
        qcfg = {
            "quant_method": "compressed-tensors",
            "format": "mixed-precision",
            "quantization_status": "compressed",
            "config_groups": groups,
            "ignore": ignore,
            "kv_cache_scheme": (prim_q.get("kv_cache_scheme")
                                or sec_q.get("kv_cache_scheme") or None),
            "global_compression_ratio": None,
            "sparsity_config": {},
            "transform_config": {},
            "version": (prim_q.get("version") or sec_q.get("version")
                        or COMPRESSION_VERSION),
        }
        out_cfg = dict(prim_cfg)
        out_cfg["quantization_config"] = qcfg
        dump_json(out_cfg, self.output / "config.json")
