"""Mixture-of-Experts block (qwen3_moe-style top-k routing), in PyTorch.

Counterpart of ``quantizers_tpu/models/moe.py``. Expert weights are stacked
into leading-``E`` tensors (:class:`ExpertLinears`), whose per-expert slice
is a valid :class:`~quantizers_tpu_torch.ops.linear.QuantLinear`.

:func:`moe_forward` has the JAX package's two regimes:

* few tokens (decode): the gathered path computes only the routed
  (token, expert) slots, through the slot-FFN kernels
  (``ops.kernels.moe_slot_ffn`` / ``moe_slot_gu_ffn``) where their
  conditions hold, else through gathered dequantized weights;
* otherwise (prefill): a loop over all experts runs every expert on every
  token through ``QuantLinear.apply`` and zeroes the unrouted contributions
  with the dense combine weights.

Under expert parallelism (:func:`~quantizers_tpu_torch.parallel.shard_params`)
a rank's stacks hold experts ``[first, first + E/shards)`` of the ``E``
(``ExpertLinears.first`` / ``shards``): the router runs on the replicated
hidden state over all ``E`` experts, each rank computes its own experts'
slots (a slot routed elsewhere is remapped to a local index and its
output set to zero with ``torch.where``, so that shapes stay static and no
NaN of a foreign slot leaks in) and the outputs are summed over the ranks
of ``moe["expert_group"]`` in f32.

With a ``capture`` dict (calibration), the loop runs whatever the token
count and records the JAX package's keys: ``router``, ``moe_gate_proj`` and
``moe_up_proj`` (one tensor: the pre-routing tokens (N, D)),
``moe_down_proj`` (every expert's down-projection input, stacked (E, N,
Fe)), ``moe_weights`` (the dense (N, E) combine weights) and, with shared
experts, ``shared_gate_proj`` / ``shared_up_proj`` / ``shared_down_proj``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.linear import QuantLinear, dequantize_stack


@dataclasses.dataclass
class ExpertLinears:
    """E stacked :class:`QuantLinear` s sharing kind and meta: tensors with
    a leading expert axis; ``kind``/``meta`` describe one expert's layout.
    A rank's shard of a stack split over ``shards`` ranks holds experts
    ``[first, first + num_experts)``."""

    kind: str
    weight: torch.Tensor  # (E, ...)
    scale: Optional[torch.Tensor] = None
    zero_point: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    meta: Tuple[Tuple[str, Any], ...] = ()
    shards: int = 1
    first: int = 0

    @property
    def num_experts(self) -> int:
        return int(self.weight.shape[0])

    @property
    def meta_dict(self) -> Dict[str, Any]:
        return dict(self.meta)

    @classmethod
    def stack(cls, lins: List[QuantLinear]) -> "ExpertLinears":
        if not lins:
            raise ValueError("need at least one expert")
        kind, meta = lins[0].kind, lins[0].meta
        for lin in lins[1:]:
            if lin.kind != kind or lin.meta != meta:
                raise ValueError("experts must share kind and layout meta")

        def _stack(field: str) -> Optional[torch.Tensor]:
            vals = [getattr(lin, field) for lin in lins]
            return None if vals[0] is None else torch.stack(vals, dim=0)

        return cls(kind=kind, weight=_stack("weight"), scale=_stack("scale"),
                   zero_point=_stack("zero_point"), bias=_stack("bias"), meta=meta)

    def expert(self, e: int) -> QuantLinear:
        """Expert ``e`` as a QuantLinear (views of the stacked tensors)."""
        def sl(a):
            return None if a is None else a[e]
        return QuantLinear(kind=self.kind, weight=sl(self.weight), scale=sl(self.scale),
                           zero_point=sl(self.zero_point), bias=sl(self.bias), meta=self.meta)

    def to(self, device) -> "ExpertLinears":
        """The same stack with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(self, weight=mv(self.weight), scale=mv(self.scale),
                                   zero_point=mv(self.zero_point), bias=mv(self.bias))

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Every expert's W^T, (E, K, N) in ``dtype``."""
        return dequantize_stack(self.kind, self.weight, self.scale, self.zero_point,
                                self.meta, dtype)


def route_topk(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool,
               scoring_func: str = "softmax", bias: Optional[torch.Tensor] = None,
               routed_scaling_factor: float = 1.0) -> torch.Tensor:
    """(N, E) logits -> dense (N, E) combine weights, zero off the top-k."""
    topi, topv = route_topk_sparse(router_logits, top_k, norm_topk_prob, scoring_func,
                                   bias, routed_scaling_factor)
    E = router_logits.shape[-1]
    onehot = F.one_hot(topi.long(), E).float()  # (N, k, E)
    return torch.einsum("nk,nke->ne", topv, onehot)


def route_topk_sparse(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool,
                      scoring_func: str = "softmax", bias: Optional[torch.Tensor] = None,
                      routed_scaling_factor: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, E) logits -> (topi (N, k) int32, topv (N, k) f32).

    ``scoring_func="sigmoid"`` with ``bias`` is the DeepSeek-V3 router: the
    choice uses ``sigmoid(logits) + bias``, the combine weights the
    unbiased scores, renormalized over the k and scaled by
    ``routed_scaling_factor``."""
    lf = router_logits.float()
    probs = torch.sigmoid(lf) if scoring_func == "sigmoid" else torch.softmax(lf, dim=-1)
    choice = probs + bias.float() if bias is not None else probs
    topi = torch.topk(choice, top_k, dim=-1).indices
    topv = torch.gather(probs, -1, topi)
    if norm_topk_prob:
        topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-20)
    return topi.to(torch.int32), topv * routed_scaling_factor


#: at most this many tokens take the gathered top-k path, which reads only
#: the routed experts' weights
_GATHER_DECODE_MAX_TOKENS = 32


def _slot_dequant(el: ExpertLinears, idx: torch.Tensor) -> torch.Tensor:
    """Gather experts ``idx`` (S,) and dequantize -> (S, K, N) bf16."""
    i = idx.long()

    def g(a):
        return None if a is None else a[i]
    return dequantize_stack(el.kind, el.weight[i], g(el.scale), g(el.zero_point), el.meta,
                            torch.bfloat16)


def _slot_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("sk,skn->sn") of bf16 operands with f32 sums, f32 out (on the
    card a bf16 batched matmul, on the CPU widened to f32 first)."""
    a16, w16 = a.to(torch.bfloat16)[:, None, :], w.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a16, w16)[:, 0].float()
    return torch.bmm(a16.float(), w16.float())[:, 0]


def _gathered_topk_ffn(moe: Dict[str, Any], h2: torch.Tensor, topi: torch.Tensor,
                       topv: torch.Tensor) -> torch.Tensor:
    """Decode-path MoE over the routed (token, expert) slots only.

    h2 (N, D); topi/topv (N, k) -> (N, D) combined output (f32). The slot
    kernels run where their conditions hold; otherwise (a routing decision
    taken before any launch) the slots go through gathered dequantized
    weights, where the JAX package catches ``KernelUnsupported``."""
    from ..ops import kernels

    N, k = topi.shape
    idx = topi.reshape(-1).to(torch.int32)  # (N*k,)
    local = None
    first, E_l = moe["down_proj"].first, moe["down_proj"].num_experts
    if moe["down_proj"].shards > 1:  # another rank holds the slots outside [first, first + E_l)
        local = (idx >= first) & (idx < first + E_l)
        idx = torch.where(local, idx - first, torch.zeros_like(idx))
    xs = torch.repeat_interleave(h2, k, dim=0)  # (N*k, D)
    if "gate_up_proj" in moe:  # the fused w8pc serving layout
        gu, down = moe["gate_up_proj"], moe["down_proj"]
        if kernels.moe_slot_gu_reason(xs, gu, down) is None:
            y = kernels.moe_slot_gu_ffn(xs, idx, gu, down)
        else:
            guv = _slot_matmul(xs, _slot_dequant(gu, idx))
            Fe = guv.shape[-1] // 2
            a = (F.silu(guv[:, :Fe]) * guv[:, Fe:]).to(h2.dtype)
            y = _slot_matmul(a, _slot_dequant(down, idx))
    else:
        gate, up, down = moe["gate_proj"], moe["up_proj"], moe["down_proj"]
        if kernels.moe_slot_ffn_reason(xs, gate, up, down) is None:
            y = kernels.moe_slot_ffn(xs, idx, gate, up, down)
        else:
            g = _slot_matmul(xs, _slot_dequant(gate, idx))
            u = _slot_matmul(xs, _slot_dequant(up, idx))
            a = (F.silu(g) * u).to(h2.dtype)
            y = _slot_matmul(a, _slot_dequant(down, idx))
    if local is not None:
        y = torch.where(local[:, None], y, torch.zeros_like(y))
    y = y.reshape(N, k, -1) * topv[:, :, None].float()
    return y.sum(dim=1)


def _shared_ffn(shared: Dict[str, QuantLinear], h2: torch.Tensor,
                capture: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    a = F.silu(shared["gate_proj"].apply(h2).float()).to(h2.dtype) * shared["up_proj"].apply(h2)
    if capture is not None:
        capture.update(shared_gate_proj=h2, shared_up_proj=h2, shared_down_proj=a)
    return shared["down_proj"].apply(a).float()


def moe_forward(moe: Dict[str, Any], spec, x: torch.Tensor,
                all_experts: bool = False,
                capture: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D): the gathered path for at most
    ``_GATHER_DECODE_MAX_TOKENS`` tokens with N*k < E and bias-free expert
    stacks (and neither ``all_experts`` nor ``capture``), else the loop over
    every expert, which fills ``capture`` (module docstring)."""
    B, T, D = x.shape
    N = B * T
    h2 = x.reshape(N, D)

    router: QuantLinear = moe["router"]
    logits = router.apply(h2.float())  # the router stays in high precision
    k = spec.num_experts_per_tok
    topi, topv = route_topk_sparse(logits, k, spec.norm_topk_prob,
                                   scoring_func=spec.scoring_func,
                                   bias=moe.get("e_score_correction_bias"),
                                   routed_scaling_factor=spec.routed_scaling_factor)

    # the gathered path applies no expert biases: biased stacks take the loop
    bias_free = all(getattr(moe[key], "bias", None) is None
                    for key in ("gate_up_proj", "gate_proj", "up_proj", "down_proj")
                    if key in moe)
    shared = moe.get("shared_experts")
    group = moe.get("expert_group")
    if (capture is None and not all_experts and bias_free
            and N <= _GATHER_DECODE_MAX_TOKENS and N * k < spec.num_experts):
        y = _gathered_topk_ffn(moe, h2, topi, topv)
        if group is not None:
            y = group.all_reduce_f32(y)
        if shared is not None:
            y = y + _shared_ffn(shared, h2)
        return y.to(x.dtype).reshape(B, T, D)

    E = spec.num_experts
    onehot = F.one_hot(topi.long(), E).float()
    weights = torch.einsum("nk,nke->ne", topv, onehot)  # dense (N, E)
    down: ExpertLinears = moe["down_proj"]
    y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    down_inputs = []
    for e in range(down.num_experts):  # this rank's experts: first + e of the E
        if "gate_up_proj" in moe:  # fused w8pc layout: one apply gives gate|up
            guv = moe["gate_up_proj"].expert(e).apply(h2).float()
            Fe = guv.shape[-1] // 2
            a = (F.silu(guv[:, :Fe]) * guv[:, Fe:]).to(h2.dtype)
        else:
            g = moe["gate_proj"].expert(e).apply(h2)
            a = F.silu(g.float()).to(h2.dtype) * moe["up_proj"].expert(e).apply(h2)
        if capture is not None:
            down_inputs.append(a)
        out = down.expert(e).apply(a)  # (N, D)
        y = y + weights[:, down.first + e, None] * out.float()
    if group is not None:
        y = group.all_reduce_f32(y)
    if shared is not None:
        y = y + _shared_ffn(shared, h2, capture)
    if capture is not None:
        capture.update(router=h2, moe_gate_proj=h2, moe_up_proj=h2,
                       moe_down_proj=torch.stack(down_inputs), moe_weights=weights)
    return y.to(x.dtype).reshape(B, T, D)
