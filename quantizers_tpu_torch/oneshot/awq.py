"""AWQ: activation-aware weight quantization.

Counterpart of ``quantizers_tpu/oneshot/awq.py``, the algorithm the
reference drives through ``AWQModifier`` (recipes ``recipe_awq_w4a16.yaml``,
``recipe_Minimax-M2.1-AWQ-MixedPrec.yaml:50-59``): for each smooth->balance
mapping, grid-search a per-in-channel scale ``s = x_mean^a / w_mean^(1-a)``
(``duo_scaling``; plain ``x_mean^a`` otherwise), pick the ``a`` with the
least fake-quantized output MSE on the captured activations, fold ``s``
into the smooth layer (divide) and the balance layers (multiply), then
RTN-quantize the smoothed weights.

The activation statistics reduce and accumulate on the device, with no
host synchronization per observe; the ``N_GRID`` candidates run one after
another (as the JAX package's ``lax.map``), so one candidate's
fake-quantized weights live at a time. The candidate scales are computed on
the host with numpy from ``x_mean`` and ``w_mean``, the JAX package's
formula for its final scale (it searches with ``jnp.power``, which may
round a scale an ulp apart), so that the card and the CPU search the same
scales. The search's f32 matmuls stay f32 on the card (nothing in the port
enables TF32).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.numerics import fake_quantize
from ..core.scheme import QuantizationArgs, QuantScheme, QuantStrategy
from ..models.moe import ExpertLinears
from ..ops.linear import QuantLinear
from ..recipes import DEFAULT_AWQ_MAPPINGS, AWQMapping
from .modifiers import LayerCtx, Modifier, SiteResult, build_site_result, expert_weights_enk, weight_nk
from .sites import LinearSite

logger = logging.getLogger(__name__)

N_GRID = 20
MAX_SEARCH_ROWS = 512  # activation rows kept for the loss evaluation
#: a balance weight's output channels per block of the loss on the host,
#: where a block's dozen fake-quantize passes stay in the caches
HOST_BLOCK_ROWS = 256


def _matches(pattern: str, path: str) -> bool:
    if pattern.startswith("re:"):
        return re.match(pattern[3:], path) is not None
    return path.endswith(pattern)


def _observe_stats(x: torch.Tensor, mask: Optional[torch.Tensor], take: int):
    """One batch's activations reduced on their device: the per-channel |x|
    column sum over the valid rows, the valid-row count, and ``take`` valid
    rows spread evenly over the valid span (the valid rows first, in their
    order; position ``i * n_valid / take``, divided by a tensor so that the
    card truncates the CPU's quotient)."""
    x2 = x.float().reshape(-1, x.shape[-1])
    R = x2.shape[0]
    if mask is not None:
        m = (mask.reshape(-1) > 0).float()
    else:
        m = torch.ones((R,), dtype=torch.float32, device=x2.device)
    sum_abs = torch.sum(torch.abs(x2) * m[:, None], dim=0)
    count = torch.sum(m)
    perm = torch.argsort(-m, stable=True)
    n_valid = torch.clamp(count, min=1.0)
    num = torch.arange(take, device=x2.device).float() * n_valid
    pos = torch.clamp((num / torch.full_like(num, take)).to(torch.int64), 0, R - 1)
    return sum_abs, count, x2[perm[pos]]


class _MappingState:
    """Streaming statistics of one smooth->balance group, accumulated on the
    device (:func:`_observe_stats`); ``update`` reads nothing back. Only
    ``pre_compress`` reads the (K,) mean and the <= 512 sampled rows."""

    def __init__(self) -> None:
        self.sum_abs: Optional[torch.Tensor] = None  # (K,)
        self.count: Optional[torch.Tensor] = None  # () f32
        self.rows: List[torch.Tensor] = []  # sampled input rows (r, K)
        self.rows_kept = 0

    def update(self, x: torch.Tensor, mask: Optional[torch.Tensor],
               valid_rows: Optional[int] = None) -> None:
        x2_rows = int(np.prod(x.shape[:-1]))
        if x2_rows == 0:
            return
        masked = mask is not None and mask.numel() == x2_rows
        # the sample budget counts VALID rows (the engine's host-side count),
        # so that a padded batch does not fill it with duplicate rows
        n_valid = valid_rows if (masked and valid_rows is not None) else x2_rows
        take = min(MAX_SEARCH_ROWS - self.rows_kept, n_valid)
        sum_abs, count, rows = _observe_stats(x, mask if masked else None, max(take, 1))
        if self.sum_abs is None:
            self.sum_abs, self.count = sum_abs, count
        else:
            self.sum_abs = self.sum_abs + sum_abs
            self.count = self.count + count
        if take > 0:
            self.rows.append(rows)
            self.rows_kept += take

    def count_f(self) -> float:
        """Total valid rows (one read from the device)."""
        return 0.0 if self.count is None else float(self.count)

    @property
    def x_mean(self) -> np.ndarray:
        return self.sum_abs.cpu().numpy() / max(self.count_f(), 1.0)

    def x_rows(self) -> torch.Tensor:
        return torch.cat(self.rows, dim=0) if self.rows else torch.zeros((0, 1))


def _col_abs_mean(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-weighted per-column |w| mean over (N_i, K) weights, on their device."""
    total = sum(torch.sum(torch.abs(w.float()), dim=0) for w in ws)
    n_rows = sum(w.shape[0] for w in ws)
    return total / torch.full_like(total, n_rows)


def _candidate_scale(ratio, x_mean: np.ndarray, w_mean: np.ndarray,
                     duo_scaling: bool) -> np.ndarray:
    """The ratio-parameterized per-channel scale family (numpy, f32)."""
    if duo_scaling:
        s = np.power(x_mean, ratio) / np.power(w_mean, 1.0 - ratio)
    else:
        s = np.power(x_mean, ratio)
    s = np.clip(s, 1e-4, 1e4)
    return s / np.sqrt(np.max(s) * np.min(s))


def _row_blocks(w: torch.Tensor, wargs: QuantizationArgs) -> List[torch.Tensor]:
    """A (N, K) balance weight in blocks of output channels for the loss:
    whole on a card; on the host HOST_BLOCK_ROWS at a time where each row
    quantizes on its own (group and channel strategies), so that the
    blocks' codes are the whole weight's."""
    if w.device.type != "cpu" or wargs.strategy not in (QuantStrategy.GROUP,
                                                        QuantStrategy.CHANNEL):
        return [w]
    return list(torch.split(w, HOST_BLOCK_ROWS))


def _search_losses(x: torch.Tensor, scales: torch.Tensor, bweights: Sequence[torch.Tensor],
                   wargs: QuantizationArgs) -> torch.Tensor:
    """The loss of each candidate scale (a row of ``scales``), one after
    another: the summed mean squared error of ``(x / s) @ fake_quantize(w *
    s)^T`` against ``x @ w^T`` over the balance weights (each weight's mean
    taken over its row blocks, weighted by their rows)."""
    blocks = [_row_blocks(w, wargs) for w in bweights]
    refs = [[x @ b.t() for b in bl] for bl in blocks]
    losses = []
    for s in scales:
        xs = x / s[None, :]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for w, bl, rl in zip(bweights, blocks, refs):
            for b, y_ref in zip(bl, rl):
                y_q = xs @ fake_quantize(b * s[None, :], wargs).t()
                total = total + torch.mean((y_ref - y_q) ** 2) * (b.shape[0] / w.shape[0])
        losses.append(total)
    return torch.stack(losses)


def _search_scale(x_rows: torch.Tensor, x_mean: np.ndarray, w_mean: np.ndarray,
                  balance_weights: List[torch.Tensor], wargs: QuantizationArgs,
                  duo_scaling: bool) -> np.ndarray:
    """Grid-search the ratio on the weights' device; the winning (K,) scale.

    The candidate scales are computed on the host with numpy, the JAX
    package's formula for its final scale, so that every device searches
    the same scales: a scale an ulp apart moves a group's absmax code
    across its rounding tie (the largest negative weight lands on -7.5), and
    with it the loss by up to 1e-3 of itself."""
    dev = balance_weights[0].device
    x_mean = np.maximum(x_mean, 1e-8).astype(np.float32)
    w_mean = np.maximum(w_mean, 1e-8).astype(np.float32)
    ratios = np.arange(N_GRID, dtype=np.float32) / N_GRID
    cands = np.stack([_candidate_scale(r, x_mean, w_mean, duo_scaling) for r in ratios])
    losses = _search_losses(x_rows.to(dev, torch.float32),
                            torch.as_tensor(cands, dtype=torch.float32, device=dev),
                            balance_weights, wargs)
    best = int(torch.argmin(losses))
    logger.debug("AWQ best ratio %.2f (loss %.3e)", ratios[best], float(losses[best]))
    return cands[best]


class AWQModifier(Modifier):
    name = "AWQModifier"
    needs_capture = True

    def begin_layer(self, ctx: LayerCtx, matched) -> Any:
        state = super().begin_layer(ctx, matched)
        mappings = self.spec.mappings or DEFAULT_AWQ_MAPPINGS
        # the mappings whose balance layers this modifier owns in this layer
        resolved: List[Dict[str, Any]] = []
        matched_prefixes = {s.prefix for s, _, _ in matched}
        for m in mappings:
            balance = [s for s in ctx.sites
                       if _matches_balance(m, s) and s.prefix in matched_prefixes]
            if not balance:
                continue
            smooth = _resolve_smooth(m, ctx)
            if smooth is None:
                continue
            resolved.append({"mapping": m, "smooth": smooth, "balance": balance,
                             "stats": _MappingState()})
        state["mappings"] = resolved
        state["by_capture"] = {}
        for r in resolved:
            for s in r["balance"]:
                state["by_capture"].setdefault(s.capture_key, r)
        return state

    def observe(self, state, site: LinearSite, x_in, mask, capture) -> None:
        super().observe(state, site, x_in, mask, capture)
        r = state["by_capture"].get(site.capture_key)
        key = capture["_batch_idx"]
        if r is None or r.get("_seen_key") == key:
            return
        if site.is_expert and x_in.ndim == 3:
            # (E, N, C): each expert's own input (down_proj); every expert
            # sees the same token axis, so the mask tiles across E and the
            # sample budget counts E x valid rows
            E, N = x_in.shape[0], x_in.shape[1]
            m = None
            if mask is not None and mask.numel() == N:
                m = mask.reshape(-1).repeat(E)
            vr = capture.get("_valid_rows")
            r["stats"].update(x_in.reshape(-1, x_in.shape[-1]), m,
                              valid_rows=None if vr is None else E * vr)
        else:
            r["stats"].update(x_in, mask, valid_rows=capture.get("_valid_rows"))
        r["_seen_key"] = key  # one update per batch per mapping

    def pre_compress(self, state, ctx: LayerCtx, matched) -> None:
        """Fold the best smoothing scales into the smooth and balance weights."""
        scheme_by_prefix = {s.prefix: sch for s, _, sch in matched}
        for r in state["mappings"]:
            stats: _MappingState = r["stats"]
            if stats.rows_kept == 0 or stats.count_f() == 0.0:
                logger.warning("AWQ mapping %s saw no activations; skipping",
                               r["mapping"].smooth_layer)
                continue
            balance: List[LinearSite] = r["balance"]
            wargs = scheme_by_prefix[balance[0].prefix].weights
            bweights = []
            for s in balance:
                if s.is_expert:
                    w = expert_weights_enk(s.get())  # (E, N, K)
                    bweights.append(w.reshape(-1, w.shape[-1]))
                else:
                    bweights.append(weight_nk(s.get()))
            K = bweights[0].shape[-1]
            w_mean = _col_abs_mean(bweights).cpu().numpy()
            x_rows = stats.x_rows()
            if x_rows.shape[-1] != K:
                logger.warning("AWQ mapping %s: stat dim %d != weight dim %d; skipping",
                               r["mapping"].smooth_layer, x_rows.shape[-1], K)
                continue
            scale = _search_scale(x_rows, stats.x_mean, w_mean, bweights, wargs,
                                  self.spec.duo_scaling)
            del bweights
            _apply_smoothing(ctx, r["smooth"], balance, scale)

    def compress(self, state, site: LinearSite, group: str,
                 scheme: QuantScheme) -> SiteResult:
        args, act = scheme.weights, scheme.input_activations
        if site.is_expert:
            res = build_site_result(site, args, group, w_enk=expert_weights_enk(site.get()),
                                    act_args=act)
        else:
            res = build_site_result(site, args, group, w_nk=weight_nk(site.get()), act_args=act)
        return self.finalize_site(state, site, scheme, res)


# ---------------------------------------------------------------------------
# mapping resolution + scale folding
# ---------------------------------------------------------------------------

def _matches_balance(m: AWQMapping, site: LinearSite) -> bool:
    paths = [site.prefix]
    if site.is_expert:
        paths.extend(site.alias_paths(0))  # with the Mixtral/MiniMax w1/w2/w3 dialect
    return any(_matches(b, p) for b in m.balance_layers for p in paths)


def _resolve_smooth(m: AWQMapping, ctx: LayerCtx):
    p = f"model.layers.{ctx.layer_idx}"
    for key in ("input_layernorm", "post_attention_layernorm"):
        if _matches(m.smooth_layer, f"{p}.{key}"):
            return ("norm", key)
    for s in ctx.sites:
        paths = [s.prefix] + (s.alias_paths(0) if s.is_expert else [])
        if any(_matches(m.smooth_layer, pp) for pp in paths):
            return ("expert_linear", s) if s.is_expert else ("linear", s)
    return None


def _dense_from_kn(w_kn: torch.Tensor, bias) -> QuantLinear:
    """A dense linear from a (K, N) weight on its device."""
    k, n = w_kn.shape
    return QuantLinear(kind="dense", weight=w_kn.to(torch.bfloat16).contiguous(),
                       bias=None if bias is None else bias.to(torch.bfloat16),
                       meta=(("k", k), ("n", n)))


def _fold_rows(lin: QuantLinear, inv_scale: torch.Tensor) -> QuantLinear:
    """Divide a linear's *output channels* by the scale (smooth side)."""
    w = lin.dequantize(torch.float32) / inv_scale[None, :]  # (K, N)
    bias = None if lin.bias is None else lin.bias.float() / inv_scale
    return _dense_from_kn(w, bias)


def _fold_cols(lin: QuantLinear, scale: torch.Tensor) -> QuantLinear:
    """Multiply a linear's *input channels* by the scale (balance side)."""
    return _dense_from_kn(lin.dequantize(torch.float32) * scale[:, None], lin.bias)


def _fold_expert_stack(el: ExpertLinears, scale: torch.Tensor, rows: bool) -> ExpertLinears:
    """Fold a smoothing scale into a whole expert stack at once."""
    deq = el.dequantize(torch.float32)  # (E, K, N)
    if rows:  # smooth side: divide output channels
        deq = deq / scale[None, None, :]
        bias = None if el.bias is None else (el.bias.float() / scale[None, :]).to(torch.bfloat16)
    else:  # balance side: multiply input channels
        deq = deq * scale[None, :, None]
        bias = el.bias
    K, N = deq.shape[1], deq.shape[2]
    return ExpertLinears(kind="dense", weight=deq.to(torch.bfloat16), bias=bias,
                         meta=(("k", K), ("n", N)))


def _apply_smoothing(ctx: LayerCtx, smooth, balance: List[LinearSite],
                     scale_np: np.ndarray) -> None:
    dev = balance[0].get().weight.device
    scale = torch.as_tensor(scale_np, dtype=torch.float32, device=dev)
    spec = ctx.spec

    kind = smooth[0]
    if kind == "norm":
        key = smooth[1]
        ctx.layer[key] = (ctx.layer[key].float() / scale).to(ctx.layer[key].dtype)
    elif kind == "linear":
        site = smooth[1]
        # v_proj -> o_proj under GQA: o's input channels (H*hd) map onto v's
        # output channels (KV*hd) by head-group repetition: reconcile scales
        if site.name == "v_proj" and any(b.name == "o_proj" for b in balance):
            H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
            rep = H // KV
            s_v = scale.reshape(KV, rep, hd).mean(dim=1)  # (KV, hd)
            # the balance scale, made consistent with s_v
            scale = s_v.repeat_interleave(rep, dim=0).reshape(H * hd)
            site.set(_fold_rows(site.get(), s_v.reshape(KV * hd)))
        else:
            site.set(_fold_rows(site.get(), scale))
    elif kind == "expert_linear":
        site = smooth[1]
        site.set(_fold_expert_stack(site.get(), scale, rows=True))

    for b in balance:
        if b.is_expert:
            b.set(_fold_expert_stack(b.get(), scale, rows=False))
        else:
            b.set(_fold_cols(b.get(), scale))
