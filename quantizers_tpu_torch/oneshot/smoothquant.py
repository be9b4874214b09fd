"""SmoothQuant: fixed-strength activation-outlier migration.

Counterpart of ``quantizers_tpu/oneshot/smoothquant.py``. The reference's
recipe dialect admits ``SmoothQuantModifier`` (llmcompressor's modifier zoo;
typically paired with a ``QuantizationModifier`` for W8A8). Unlike AWQ
there is no search: the per-channel scale is

    s_j = act_absmax_j^a / weight_absmax_j^(1-a)

with ``smoothing_strength`` a (default 0.5), folded into the smooth layer
(divide) and the balance layers (multiply). This modifier only transforms
weights; the paired quantization modifier compresses, so it is
``transforms_only`` and claims no site.

``act_absmax`` is taken over the <= 512 rows that AWQ's statistics sample
(``_MappingState``), not over every calibration token, as in the JAX
package (ROADMAP queue 3). The scale is computed on the host with numpy
from maxima, which do not depend on the order of a sum.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np
import torch

from ..recipes import DEFAULT_AWQ_MAPPINGS
from .awq import _MappingState, _apply_smoothing, _matches_balance, _resolve_smooth
from .modifiers import LayerCtx, Modifier, expert_weights_enk, weight_nk
from .sites import LinearSite

logger = logging.getLogger(__name__)


class SmoothQuantModifier(Modifier):
    name = "SmoothQuantModifier"
    needs_capture = True
    transforms_only = True

    @property
    def smoothing_strength(self) -> float:
        return float(self.spec.extra.get("smoothing_strength", 0.5))

    def begin_layer(self, ctx: LayerCtx, matched) -> Any:
        state = super().begin_layer(ctx, matched)
        mappings = self.spec.mappings or DEFAULT_AWQ_MAPPINGS
        resolved: List[Dict[str, Any]] = []
        for m in mappings:
            balance = [s for s in ctx.sites if _matches_balance(m, s)]
            smooth = _resolve_smooth(m, ctx)
            if balance and smooth is not None:
                resolved.append({"mapping": m, "smooth": smooth, "balance": balance,
                                 "stats": _MappingState()})
        state["mappings"] = resolved
        state["by_capture"] = {}
        for r in resolved:
            for s in r["balance"]:
                state["by_capture"].setdefault(s.capture_key, r)
        return state

    def observe(self, state, site: LinearSite, x_in, mask, capture) -> None:
        r = state["by_capture"].get(site.capture_key)
        key = capture["_batch_idx"]
        if r is None or r.get("_seen_key") == key:
            return
        if site.is_expert and x_in.ndim == 3:
            r["stats"].update(x_in.reshape(-1, x_in.shape[-1]), None)
        else:
            r["stats"].update(x_in, mask)
        r["_seen_key"] = key

    def pre_compress(self, state, ctx: LayerCtx, matched) -> None:
        alpha = self.smoothing_strength
        for r in state["mappings"]:
            stats: _MappingState = r["stats"]
            if stats.count is not None and stats.count_f() == 0.0:
                continue
            balance: List[LinearSite] = r["balance"]
            # each balance weight's per-input-channel |w| max, on its device
            ws = [torch.amax(torch.abs(expert_weights_enk(s.get())), dim=(0, 1)).cpu().numpy()
                  if s.is_expert else
                  torch.amax(torch.abs(weight_nk(s.get())), dim=0).cpu().numpy()
                  for s in balance]
            w_absmax = np.maximum.reduce(ws)
            x_rows = stats.x_rows()
            if x_rows.shape[-1] != w_absmax.shape[0]:
                continue
            act_absmax = np.maximum(np.abs(x_rows.cpu().numpy()).max(axis=0), 1e-8)
            s = np.power(act_absmax, alpha) / np.power(np.maximum(w_absmax, 1e-8), 1.0 - alpha)
            s = np.clip(s, 1e-4, 1e4).astype(np.float32)
            _apply_smoothing(ctx, r["smooth"], balance, s)
            logger.debug("SmoothQuant folded scales for %s (alpha=%.2f)",
                         r["mapping"].smooth_layer, alpha)
