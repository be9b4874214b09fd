"""Modifier protocol + RTN (`QuantizationModifier`).

Counterpart of ``quantizers_tpu/oneshot/modifiers.py``. A modifier
transforms one layer's weights given (optionally) captured activations.
The engine drives it layer by layer:

    state = modifier.begin_layer(ctx, matched)
    for batch: modifier.observe(state, site, x_in, mask, capture)   # if it captures
    modifier.pre_compress(state, ctx, matched)   # layer-level transforms (AWQ)
    modifier.compress(state, site, group, scheme) -> SiteResult

RTN is the reference's ``QuantizationModifier`` (used data-free in
``main_seed-oss-fp8.py:31-33`` and for FP8 attention in the mixed recipes):
pure round-to-nearest under the scheme's observer, no activation feedback,
except static (non-dynamic) activation schemes, whose ``input_scale`` is
calibrated from the captured activations.

An expert stack is quantized expert by expert, so each expert gets exactly
the codes of the per-expert :func:`~quantizers_tpu_torch.core.numerics.quantize`
(the JAX package maps one program over the stack with ``vmap``, which gives
the same codes on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.numerics import QuantizedTensor, quantize
from ..core.scheme import QuantizationArgs, QuantScheme
from ..formats.checkpoint import CompressedParam
from ..models.moe import ExpertLinears
from ..ops.linear import QuantLinear, from_quantized
from ..recipes import ModifierSpec
from .sites import LinearSite


@dataclasses.dataclass
class SiteResult:
    """Outcome of compressing one site."""

    new_linear: Any  # QuantLinear | ExpertLinears
    records: Dict[str, CompressedParam]  # per concrete HF prefix
    extra_tensors: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def weight_nk(lin: QuantLinear) -> torch.Tensor:
    """Current weight in HF (N, K) orientation, f32."""
    return lin.dequantize(torch.float32).t()


def expert_weights_enk(el: ExpertLinears) -> torch.Tensor:
    """(E, N, K) f32 stack of an expert group's weights."""
    return el.dequantize(torch.float32).transpose(1, 2)


def _to_host(qt: QuantizedTensor) -> QuantizedTensor:
    """The quantized tensor with every part on the CPU."""
    def cpu(t):
        return None if t is None else t.cpu()
    return qt._replace(values=qt.values.cpu(), scale=qt.scale.cpu(),
                       zero_point=cpu(qt.zero_point), global_scale=cpu(qt.global_scale))


def build_site_result(site: LinearSite, args: QuantizationArgs, group: str,
                      w_nk: Optional[torch.Tensor] = None,
                      w_enk: Optional[torch.Tensor] = None,
                      g_idx: Optional[torch.Tensor] = None,
                      qt: Optional[QuantizedTensor] = None,
                      qt_per_expert: Optional[List[QuantizedTensor]] = None,
                      act_args: Optional[QuantizationArgs] = None) -> SiteResult:
    """Quantize a site's weights (``w_nk``, or ``w_enk`` for an expert
    stack) and assemble the new linear and its on-disk records, on the
    weights' device. Callers that solved their own codes (GPTQ) pass them
    as ``qt`` / ``qt_per_expert`` instead, with ``g_idx`` (an actorder
    permutation) for the record. The new linear is built from the codes and
    scales alone with contiguous groups, as the JAX package builds it (it
    reads no ``g_idx``: ROADMAP queue 3). ``act_args`` (the scheme's
    ``input_activations``) is recorded on the new linear as the JAX package
    records it."""
    if site.is_expert:
        el: ExpertLinears = site.get()
        new_lins: List[QuantLinear] = []
        records: Dict[str, CompressedParam] = {}
        for e in range(el.num_experts):
            qt_e = qt_per_expert[e] if qt_per_expert is not None else quantize(w_enk[e], args)
            new_lins.append(from_quantized(qt_e, args, bias=el.expert(e).bias,
                                           act_args=act_args))
            records[site.expert_prefix(e)] = CompressedParam(qt=qt_e, args=args, group=group)
        return SiteResult(new_linear=ExpertLinears.stack(new_lins), records=records)

    lin: QuantLinear = site.get()
    if qt is None:
        qt = quantize(w_nk, args)
    new_lin = from_quantized(qt, args, bias=lin.bias, act_args=act_args)
    rec = CompressedParam(qt=qt, args=args, group=group,
                          g_idx=None if g_idx is None else g_idx.cpu())
    return SiteResult(new_linear=new_lin, records={site.prefix: rec})


# ---------------------------------------------------------------------------
# static activation-scale observation (shared by all modifiers)
# ---------------------------------------------------------------------------

class ActScaleObserver:
    """Tracks the absmax of a site's input activations for static act
    schemes (e.g. per-tensor FP8, ``main_seed-oss-fp8-kv8.py:168-202``). The
    running max stays on the activations' device until :meth:`scale`."""

    def __init__(self) -> None:
        self.absmax: Optional[torch.Tensor] = None

    def update(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
        xf = torch.abs(x.float()).reshape(-1, x.shape[-1])
        if mask is not None:
            m = mask.reshape(-1).float()
            if m.shape[0] == xf.shape[0]:
                xf = xf * m[:, None]
        amax = torch.max(xf)
        self.absmax = amax if self.absmax is None else torch.maximum(self.absmax, amax)

    def scale(self, args: QuantizationArgs) -> torch.Tensor:
        """(1,) f32 on the CPU: absmax / the scheme's divisor, at least 1e-10,
        divided in double precision and rounded once, as the JAX package does."""
        absmax = 0.0 if self.absmax is None else max(0.0, float(self.absmax))
        s = absmax / args.scale_divisor
        return torch.tensor([max(s, 1e-10)], dtype=torch.float32)


def needs_static_act(scheme: QuantScheme) -> bool:
    a = scheme.input_activations
    return a is not None and not a.dynamic


@dataclasses.dataclass
class LayerCtx:
    """Everything a modifier may need about the layer being compressed."""

    spec: Any  # ModelSpec
    layer_idx: int
    layer: Dict[str, Any]
    sites: List[LinearSite]


class Modifier:
    """Base modifier. Subclasses override the hooks they need."""

    name = "Modifier"
    needs_capture = False
    #: transform-only modifiers (SmoothQuant) fold scales into weights but
    #: never claim sites for compression: a paired quantization modifier
    #: owns that
    transforms_only = False

    def __init__(self, spec: ModifierSpec) -> None:
        self.spec = spec

    # --- per-layer protocol -------------------------------------------------
    def begin_layer(self, ctx: LayerCtx,
                    matched: List[Tuple[LinearSite, str, QuantScheme]]) -> Any:
        """matched: (site, group_name, scheme) triples this modifier owns."""
        state: Dict[str, Any] = {"act_obs": {}}
        for site, _, scheme in matched:
            if scheme is not None and needs_static_act(scheme):
                state["act_obs"][site.prefix] = ActScaleObserver()
        return state

    def wants_capture_for(self, matched) -> bool:
        return self.needs_capture or any(
            s is not None and needs_static_act(s) for _, _, s in matched)

    def observe(self, state: Any, site: LinearSite, x_in: torch.Tensor,
                mask: Optional[torch.Tensor], capture: Dict[str, Any]) -> None:
        obs = state["act_obs"].get(site.prefix)
        if obs is not None:
            obs.update(x_in, mask)

    def pre_compress(self, state: Any, ctx: LayerCtx,
                     matched: List[Tuple[LinearSite, str, QuantScheme]]) -> None:
        """Layer-level weight transform before per-site quantization (AWQ
        and SmoothQuant fold their scales here)."""

    def compress(self, state: Any, site: LinearSite, group: str,
                 scheme: QuantScheme) -> SiteResult:
        raise NotImplementedError

    def finalize_site(self, state: Any, site: LinearSite, scheme: QuantScheme,
                      result: SiteResult) -> SiteResult:
        """Attach static activation scales."""
        obs = state["act_obs"].get(site.prefix)
        if obs is not None and scheme.input_activations is not None:
            scale = obs.scale(scheme.input_activations)
            if site.is_expert:
                el: ExpertLinears = result.new_linear
                for e in range(el.num_experts):
                    result.extra_tensors[f"{site.expert_prefix(e)}.input_scale"] = scale
            else:
                result.extra_tensors[f"{site.prefix}.input_scale"] = scale
        return result


class RTNModifier(Modifier):
    """Round-to-nearest under the scheme's observer: the
    ``QuantizationModifier`` of the reference's recipes."""

    name = "QuantizationModifier"
    needs_capture = False

    def compress(self, state: Any, site: LinearSite, group: str,
                 scheme: QuantScheme) -> SiteResult:
        args = scheme.weights
        act = scheme.input_activations
        if site.is_expert:
            w = expert_weights_enk(site.get())
            res = build_site_result(site, args, group, w_enk=w, act_args=act)
        else:
            w = weight_nk(site.get())
            res = build_site_result(site, args, group, w_nk=w, act_args=act)
        del w
        return self.finalize_site(state, site, scheme, res)
