"""The layer-sequential oneshot engine.

Counterpart of ``quantizers_tpu/oneshot/engine.py`` (reference boundary at
``scripts/do_oneshot.py:177-187``): calibration batches are embedded once,
then each decoder layer is (1) run with capture to feed the modifiers'
observers, (2) compressed, (3) re-run with quantized weights so downstream
layers calibrate against the *quantized* upstream, the error-propagation
property GPTQ and AWQ rely on. Pipelines:

* ``sequential``: one pass; all modifiers applied per layer in recipe order.
* ``independent``: each modifier gets its own full sequential pass
  (reference ``quantization_multiple_modifiers.py:102-109`` ``--independent``).
* ``basic``: no error propagation: capture on the original model only.

The layer forwards run without a cache, so their attention goes through the
flash kernel where it takes the shape, and their matmuls at m = B x T rows
through the weight-only kernels up to ``ops.dispatch.KERNEL_MAX_ROWS``,
dequantize-then-matmul above, and W8A8 linears through the int8 GEMM at any
m, as in the JAX package. Modifiers see each layer through a
:class:`~quantizers_tpu_torch.oneshot.modifiers.LayerCtx`; transform-only
ones (SmoothQuant) observe every site and claim none, and every modifier's
``pre_compress`` (AWQ's and SmoothQuant's folds) runs before any site of the
layer is compressed.

Memory model: two modes via ``offload``. In both, each record moves to
host memory as it is made (only the save reads it).

* ``"device"`` (default): the whole params tree and one (B, T, D) hidden
  block per calibration batch stay on the device. As in the JAX package,
  the params are modified in place: each layer's dict takes its quantized
  linears as the layer is compressed, so the bf16 weights of a layer are
  freed once it is done.
* ``"host"``: params and hiddens live in host memory; each layer moves to
  the device for its capture / compress / propagate window and comes back
  quantized, and the hiddens pass through one batch at a time. Peak device
  memory is one layer's weights plus one batch of hiddens (plus the
  embedding table while the batches are embedded):
  :func:`streaming_peak_bytes`.

Observers keep their running statistics on the device and read them once,
when a layer is compressed; nothing in the capture loop waits on the device.
Stage times are taken after a device synchronization.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.scheme import QuantizationArgs, QuantScheme
from ..formats.checkpoint import CompressedParam
from ..models.config import ModelSpec
from ..models.transformer import apply_layer, embed, tree_to
from ..recipes import ModifierSpec, Recipe
from .autoround import AutoRoundModifier
from .awq import AWQModifier
from .gptq import GPTQModifier
from .modifiers import LayerCtx, Modifier, RTNModifier, SiteResult, _to_host
from .sites import LinearSite, layer_sites, scheme_for_site
from .smoothquant import SmoothQuantModifier

logger = logging.getLogger(__name__)


def _build_modifier(spec: ModifierSpec) -> Modifier:
    table = {"QuantizationModifier": RTNModifier, "GPTQModifier": GPTQModifier,
             "AWQModifier": AWQModifier, "SmoothQuantModifier": SmoothQuantModifier,
             "AutoRoundModifier": AutoRoundModifier}
    cls = table.get(spec.name)
    if cls is None:
        raise ValueError(f"Unsupported modifier {spec.name!r}; known: {sorted(table)}")
    return cls(spec)


@dataclasses.dataclass
class OneshotResult:
    params: Dict[str, Any]
    records: Dict[str, CompressedParam]
    extra_tensors: Dict[str, torch.Tensor]
    config_groups: Dict[str, QuantScheme]
    ignore: List[str]
    kv_cache_scheme: Optional[QuantizationArgs]
    stats: Dict[str, Any]


def make_batches(tokenized: Iterable[Any], max_seq_length: int,
                 batch_size: int = 4, pad_to_multiple: int = 128,
                 pad_id: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Pack tokenized samples (dicts with ``input_ids`` or raw id lists)
    into (ids, mask) numpy batches. Rows are sorted by length, and each
    batch is right-padded to its longest row rounded up to
    ``pad_to_multiple`` (at most ``max_seq_length``), as in the JAX package,
    so both packages see the same batches."""
    rows: List[List[int]] = []
    for s in tokenized:
        ids = s["input_ids"] if isinstance(s, dict) else s
        ids = list(ids)[:max_seq_length]
        if ids:
            rows.append(ids)
    rows.sort(key=len)  # length-bucketing minimizes padding waste
    pad_to_multiple = min(pad_to_multiple, max_seq_length)
    batches: List[Tuple[np.ndarray, np.ndarray]] = []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i: i + batch_size]
        longest = max(len(r) for r in chunk)
        T = min(max_seq_length, -(-longest // pad_to_multiple) * pad_to_multiple)
        T = max(T, pad_to_multiple)
        ids = np.full((len(chunk), T), pad_id, dtype=np.int32)
        mask = np.zeros((len(chunk), T), dtype=np.float32)
        for j, r in enumerate(chunk):
            r = r[:T]
            ids[j, : len(r)] = r
            mask[j, : len(r)] = 1.0
        batches.append((ids, mask))
    return batches


def _capture_layer(layer, spec, idx, hiddens, positions, moe_all_experts
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer forward with capture; returns (out, capture)."""
    cap: Dict[str, torch.Tensor] = {}
    out, _ = apply_layer(layer, spec, idx, hiddens, positions, None, moe_all_experts, cap)
    return out, cap


def _capture_alias_map(cap: Dict[str, Any]) -> Dict[str, str]:
    """capture_key -> canonical capture_key for keys that hold the same
    tensor (q/k/v share the post-norm hidden, gate/up likewise, the MoE
    gate/up/router/shared experts all see the pre-routing tokens). The
    canonical key is the first in sorted order, as in the JAX package's map
    (which reads identity off the traced outputs, whose dict keys flatten
    sorted). Modifiers use it to accumulate one statistic per distinct
    input instead of one per site."""
    first: Dict[int, str] = {}
    alias: Dict[str, str] = {}
    for key in sorted(cap):
        v = cap[key]
        if not isinstance(v, torch.Tensor):
            continue
        canon = first.setdefault(id(v), key)
        if canon != key:
            alias[key] = canon
    return alias


def streaming_peak_bytes(spec: ModelSpec, batch_size: int, seq_len: int,
                         hidden_dtype_bytes: int = 2) -> Dict[str, int]:
    """Device-memory bound of the ``offload='host'`` pipeline: the maximum
    of (embed table + one batch of hiddens) during embedding and (one
    layer's bf16-equivalent weights + one batch of hiddens) during the
    per-layer loop. Pure shape math, to plan a calibration against one
    card's memory without allocating anything."""
    D, Ff = spec.hidden_size, spec.intermediate_size
    attn = 2 * D * (spec.q_dim + 2 * spec.kv_dim) + 2 * spec.q_dim * D
    if spec.num_experts:
        ff_e = getattr(spec, "moe_intermediate_size", None) or Ff
        mlp = spec.num_experts * 2 * (2 * D * ff_e + ff_e * D)
    else:
        mlp = 2 * (2 * D * Ff + Ff * D)
    layer_bytes = attn + mlp + 4 * D  # + norms
    hidden_bytes = batch_size * seq_len * D * hidden_dtype_bytes
    embed_bytes = spec.vocab_size * D * 2
    return {
        "layer_bytes": layer_bytes,
        "hidden_bytes": hidden_bytes,
        "embed_bytes": embed_bytes,
        "peak_bytes": max(embed_bytes, layer_bytes) + hidden_bytes,
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def oneshot(
    spec: ModelSpec,
    params: Dict[str, Any],
    recipe: Recipe,
    batches: Sequence[Tuple[np.ndarray, np.ndarray]],
    moe_calibrate_all_experts: bool = True,
    pipeline: Optional[str] = None,
    offload: str = "device",
    device: DeviceLike = None,
) -> OneshotResult:
    """Run calibrated quantization over ``params`` on ``device`` (the CUDA
    card unless the caller names another); the result holds the quantized
    params. ``offload='device'`` modifies ``params`` in place and moves it
    to the device layer by layer; ``offload='host'`` works on a host copy
    and streams one layer and one hidden batch through the device at a
    time (module docstring)."""
    if offload not in ("device", "host"):
        raise ValueError(f"offload must be 'device' or 'host', got {offload!r}")
    dev = resolve_device(device)
    t0 = time.time()
    pipeline = pipeline or recipe.pipeline
    modifiers = [_build_modifier(m) for m in recipe.modifiers]

    if pipeline == "independent":
        # each modifier gets its own full sequential pass; the results are
        # MERGED: every pass's records and config groups reach the artifact
        merged_records: Dict[str, CompressedParam] = {}
        merged_extra: Dict[str, torch.Tensor] = {}
        merged_groups: Dict[str, QuantScheme] = {}
        merged_ignore: List[str] = []
        merged_stats: Dict[str, Any] = {}
        kv_scheme_out: Optional[QuantizationArgs] = None
        for i, mspec in enumerate(recipe.modifiers):
            sub = Recipe(modifiers=[mspec], pipeline="sequential", raw=recipe.raw)
            result = oneshot(spec, params, sub, batches, moe_calibrate_all_experts,
                             pipeline="sequential", offload=offload, device=dev)
            params = result.params
            merged_records.update(result.records)
            merged_extra.update(result.extra_tensors)
            for gname, scheme in result.config_groups.items():
                key = gname if gname not in merged_groups else f"{gname}_m{i}"
                merged_groups[key] = scheme
            for ig in result.ignore:
                if ig not in merged_ignore:
                    merged_ignore.append(ig)
            merged_stats[f"pass_{i}_s"] = result.stats.get("total_s", 0.0)
            if result.kv_cache_scheme is not None:
                kv_scheme_out = result.kv_cache_scheme
        merged_stats["total_s"] = time.time() - t0
        return OneshotResult(
            params=params, records=merged_records, extra_tensors=merged_extra,
            config_groups=merged_groups, ignore=merged_ignore,
            kv_cache_scheme=kv_scheme_out or recipe.kv_cache_scheme(),
            stats=merged_stats)

    propagate = pipeline != "basic"

    # ---- merged config groups across modifiers (for the saved config) ----
    config_groups: Dict[str, QuantScheme] = {}
    ignore: List[str] = []
    for i, mspec in enumerate(recipe.modifiers):
        for gname, scheme in mspec.config_groups.items():
            key = gname if gname not in config_groups else f"{gname}_m{i}"
            config_groups[key] = scheme
        for ig in mspec.ignore:
            if ig not in ignore:
                ignore.append(ig)

    host_mode = offload == "host"
    home = torch.device("cpu") if host_mode else dev
    if host_mode:
        # params live in host memory for the whole run (new dicts, as the
        # JAX package's host copy); layers visit the device one at a time
        params = tree_to(params, home)
    else:
        for key in params:
            if key != "layers":
                params[key] = tree_to(params[key], dev)

    # ---- embed the calibration data once ----------------------------------
    # host mode: the embed table visits the device once, each batch's
    # hiddens come straight back to host memory
    hiddens: List[torch.Tensor] = []
    positions: List[torch.Tensor] = []
    masks: List[torch.Tensor] = []
    valid_rows: List[int] = []  # host-side valid-token counts per batch
    embed_dev = {"embed": params["embed"].to(dev)}
    for ids, mask in batches:
        B, T = ids.shape
        valid_rows.append(int(np.asarray(mask).sum()) if mask is not None else B * T)
        hiddens.append(embed(embed_dev, torch.as_tensor(np.asarray(ids), device=dev)).to(home))
        positions.append(torch.arange(T, device=home)[None, :].expand(B, T))
        masks.append(torch.as_tensor(np.asarray(mask, np.float32), device=home))
    del embed_dev

    records: Dict[str, CompressedParam] = {}
    extra_tensors: Dict[str, torch.Tensor] = {}
    stage_s: Dict[str, Any] = {"capture_s": 0.0, "solve_s": 0.0, "propagate_s": 0.0}

    # FP8 KV-cache calibration (reference main_seed-oss-fp8-kv8.py:168-202):
    # per-layer k/v absmax over the capture pass, emitted as k_scale/v_scale
    kv_scheme = recipe.kv_cache_scheme()
    kv_absmax: Dict[int, Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]] = {}

    for li in range(len(params["layers"])):
        t_layer = time.time()
        # this layer's weights enter the device here; in host mode they
        # leave it (quantized) at the end of the iteration
        layer = tree_to(params["layers"][li], dev)
        if not host_mode:
            params["layers"][li] = layer
        sites = layer_sites(spec, li, layer)

        # which modifier owns which site (first match in recipe order wins);
        # transform-only modifiers (SmoothQuant) observe every site but
        # never claim one: their paired quantizer compresses
        owned: List[Tuple[Modifier, LinearSite, str, QuantScheme]] = []
        observe_only: List[Tuple[Modifier, LinearSite, str, Optional[QuantScheme]]] = []
        taken: set = set()
        for mod in modifiers:
            if mod.transforms_only:
                observe_only.extend((mod, site, "", None) for site in sites)
                continue
            for site in sites:
                if site.prefix in taken:
                    continue
                hit = scheme_for_site(site, mod.spec.config_groups, mod.spec.ignore,
                                      spec.num_experts)
                if hit is not None:
                    gname, scheme = hit
                    owned.append((mod, site, gname, scheme))
                    taken.add(site.prefix)

        ctx = LayerCtx(spec=spec, layer_idx=li, layer=layer, sites=sites)
        per_mod: Dict[int, List[Tuple[LinearSite, str, Optional[QuantScheme]]]] = {}
        for mod, site, gname, scheme in owned + observe_only:
            per_mod.setdefault(id(mod), []).append((site, gname, scheme))
        states: Dict[int, Any] = {}
        want_capture = kv_scheme is not None
        for mod in modifiers:
            matched = per_mod.get(id(mod), [])
            if not matched:
                continue
            states[id(mod)] = mod.begin_layer(ctx, matched)
            want_capture = want_capture or mod.wants_capture_for(matched)

        # ---- capture pass -------------------------------------------------
        if want_capture and batches:
            t_cap = time.time()
            kmax = vmax = None
            for bi, (h, pos, mask) in enumerate(zip(hiddens, positions, masks)):
                _, cap = _capture_layer(layer, spec, li, h.to(dev), pos.to(dev),
                                        moe_calibrate_all_experts)
                # the batch's ordinal (modifiers that observe one shared
                # input for several sites take it once a batch), the
                # shared-input map and the host-side valid-token count: none
                # of them waits on the device
                cap["_batch_idx"] = bi
                cap["_aliases"] = _capture_alias_map(cap)
                cap["_valid_rows"] = valid_rows[bi]
                mask_dev = mask.to(dev)
                for mod, site, gname, scheme in observe_only + owned:
                    x_in = cap.get(site.capture_key)
                    if x_in is not None:
                        mod.observe(states[id(mod)], site, x_in, mask_dev, cap)
                if kv_scheme is not None:
                    k = torch.max(torch.abs(cap["k_cache"].float()))
                    v = torch.max(torch.abs(cap["v_cache"].float()))
                    kmax = k if kmax is None else torch.maximum(kmax, k)
                    vmax = v if vmax is None else torch.maximum(vmax, v)
                del cap
            kv_absmax[li] = (kmax, vmax)
            _sync(dev)
            stage_s["capture_s"] += time.time() - t_cap

        # ---- layer-level transforms (AWQ, SmoothQuant), then compress ------
        t_solve = time.time()
        for mod in modifiers:
            matched = per_mod.get(id(mod), [])
            if matched:
                mod.pre_compress(states[id(mod)], ctx, matched)
        for mod, site, gname, scheme in owned:
            res: SiteResult = mod.compress(states[id(mod)], site, gname, scheme)
            site.set(res.new_linear)
            # the records leave the device at once: they are read only when
            # the checkpoint is saved
            records.update({key: dataclasses.replace(cp, qt=_to_host(cp.qt))
                            for key, cp in res.records.items()})
            extra_tensors.update(res.extra_tensors)
        _sync(dev)
        stage_s["solve_s"] += time.time() - t_solve

        # ---- propagate ----------------------------------------------------
        if propagate and batches:
            t_prop = time.time()
            # batch by batch in place, so one batch's old hiddens are freed
            # as its new ones are made
            for bi, pos in enumerate(positions):
                hiddens[bi] = apply_layer(layer, spec, li, hiddens[bi].to(dev), pos.to(dev),
                                          None, moe_calibrate_all_experts)[0].to(home)
            _sync(dev)
            stage_s["propagate_s"] += time.time() - t_prop

        if host_mode:
            # the quantized layer leaves the device; params keep the host copy
            params["layers"][li] = tree_to(layer, home)
            del layer

        if owned:
            dt_layer = time.time() - t_layer
            stage_s.setdefault("layer_s", []).append(round(dt_layer, 2))
            logger.info("layer %d: %d sites compressed in %.1fs", li, len(owned), dt_layer)

    if kv_scheme is not None and batches:
        divisor = kv_scheme.scale_divisor
        for li in range(len(params["layers"])):
            kmax, vmax = kv_absmax.get(li, (None, None))
            p = f"model.layers.{li}.self_attn"
            for name, amax in (("k_scale", kmax), ("v_scale", vmax)):
                a = 0.0 if amax is None else max(0.0, float(amax))
                extra_tensors[f"{p}.{name}"] = torch.tensor([max(a / divisor, 1e-10)],
                                                            dtype=torch.float32)

    stats = {"total_s": time.time() - t0, **stage_s}
    return OneshotResult(
        params=params,
        records=records,
        extra_tensors=extra_tensors,
        config_groups=config_groups,
        ignore=ignore,
        kv_cache_scheme=recipe.kv_cache_scheme(),
        stats=stats,
    )
