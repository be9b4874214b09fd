"""AutoRound: learned rounding by sign-gradient descent.

Counterpart of ``quantizers_tpu/oneshot/autoround.py``, the reference's
``AutoRoundModifier`` (``configs/recipes/recipe_ar_w4a16g32.yaml``, ``iters:
200``): instead of rounding to nearest, learn a per-weight rounding offset
``V`` in [-0.5, 0.5] that minimizes the layer's output MSE on captured
activations, with signSGD, a straight-through round and a linearly decaying
step. The best ``V`` so far is kept (step 0 is plain RTN), so the result is
never worse than RTN on those rows.

The loop runs on the weights' device as PyTorch f32 tensors, two matrix
products a step (TF32 off), with no host synchronization: the best loss
stays a device scalar, as in the JAX package's ``fori_loop``. The gradient
is taken in closed form: ``(2 / (R N)) (X Wq^T - Y)^T X s``, zero where the
clip bites. JAX's ``jnp.clip`` gives 0.5 at the clip's edges and this gives
1; only the sign enters the step, so the two agree. The step sizes
``lr * (1 - i / iters)`` are the JAX package's f32 numbers (computed in f32
on the host, once).

A near-zero gradient may take the other sign on another device (or in
another library), where f32 sums run in another order; after that the two
trajectories part. Runs on two devices are compared by their losses, not by
their codes.
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.numerics import QuantizedTensor, compute_scale_zp, minmax_along
from ..core.scheme import QuantizationArgs, QuantScheme, QuantType
from .awq import _observe_stats
from .gptq import _f32_matmuls
from .modifiers import (LayerCtx, Modifier, SiteResult, build_site_result, expert_weights_enk,
                        weight_nk)
from .sites import LinearSite

logger = logging.getLogger(__name__)

MAX_ROWS = 1024


def _qparams(W: torch.Tensor, args: QuantizationArgs):
    """The RTN (scale, zero point) of ``W`` (N, K) shaped (N, n_groups) (a
    tensor or channel strategy's as one group of K), and the group size."""
    g = int(args.group_size) if args.group_size else W.shape[1]
    mn, mx = minmax_along(W, args)
    scale, zp = compute_scale_zp(mn, mx, args)
    if scale.ndim < 2:
        scale = scale.reshape(-1, 1)
        zp = zp.reshape(-1, 1)
    return scale, (None if args.symmetric else zp), g


class _Problem:
    """One site's rounding problem: W (N, K), X (R, K), the group scales and
    zero points spread over the columns, the target ``Y = X W^T``."""

    def __init__(self, W: torch.Tensor, X: torch.Tensor, scale: torch.Tensor,
                 zp: Optional[torch.Tensor], group_size: int, qmin: float, qmax: float):
        K = W.shape[1]
        self.W, self.X = W, X
        self.s = torch.repeat_interleave(scale, group_size, dim=1)[:, :K]
        self.z = (None if zp is None else
                  torch.repeat_interleave(zp, group_size, dim=1)[:, :K].float())
        self.qmin, self.qmax = qmin, qmax
        self.Y = X @ W.t()
        self.inv_count = 2.0 / (X.shape[0] * W.shape[0])

    def grid(self, V: torch.Tensor) -> torch.Tensor:
        """``W / s + V`` (+ the zero point), in the JAX package's order."""
        x = self.W / self.s + V
        return x if self.z is None else x + self.z

    def codes(self, V: torch.Tensor) -> torch.Tensor:
        """The integer grid values at ``V`` (round half to even, clipped)."""
        return torch.clamp(torch.round(self.grid(V)), self.qmin, self.qmax)

    def wq(self, V: torch.Tensor) -> torch.Tensor:
        q = self.codes(V)
        return (q if self.z is None else q - self.z) * self.s

    def loss(self, V: torch.Tensor) -> torch.Tensor:
        return torch.mean((self.X @ self.wq(V).t() - self.Y) ** 2)

    def loss_and_grad(self, V: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loss at ``V`` and its straight-through gradient in V: through
        the round as the identity, through the clip where the rounded value
        lies in [qmin, qmax] (its edges included)."""
        r = torch.round(self.grid(V))
        inside = (r >= self.qmin) & (r <= self.qmax)
        q = torch.clamp(r, self.qmin, self.qmax)
        wq = (q if self.z is None else q - self.z) * self.s
        diff = self.X @ wq.t() - self.Y
        loss = torch.mean(diff ** 2)
        g = (diff.t() @ self.X) * self.inv_count * self.s
        return loss, torch.where(inside, g, torch.zeros((), device=g.device))


def _steps(iters: int, lr: float) -> np.ndarray:
    """``lr * (1 - i / iters)`` for each step i, each operation in f32, as
    the JAX package computes it."""
    i = np.arange(iters, dtype=np.float32)
    decay = np.float32(1.0) - i / np.float32(iters)
    return np.float32(lr) * decay


def _autoround_solve(W: torch.Tensor, X: torch.Tensor, scale: torch.Tensor,
                     zp: Optional[torch.Tensor], *, iters: int, group_size: int, qmin: float,
                     qmax: float, lr: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimize the rounding offsets of W (N, K) f32 on rows X (R, K) f32,
    on W's device. Returns the integer grid values (N, K) f32 at the best V,
    the best loss and the loss at V = 0 (RTN with round half to even), the
    losses as device scalars."""
    with _f32_matmuls():
        p = _Problem(W, X, scale, zp, group_size, qmin, qmax)
        steps = torch.from_numpy(_steps(iters, lr)).to(W.device)
        V = torch.zeros_like(W)
        bestV = V
        bestL = torch.full((), float("inf"), dtype=torch.float32, device=W.device)
        first = None
        for i in range(iters):
            loss, g = p.loss_and_grad(V)
            if first is None:
                first = loss
            # the best-so-far snapshot takes the V the loss was measured at
            # (step 0: V = 0, RTN)
            better = loss < bestL
            bestV = torch.where(better, V, bestV)
            bestL = torch.where(better, loss, bestL)
            V = torch.clamp(V - steps[i] * torch.sign(g), -0.5, 0.5)
        final = p.loss(V)
        bestV = torch.where(final < bestL, V, bestV)
        bestL = torch.minimum(final, bestL)
        return p.codes(bestV), bestL, (final if first is None else first)


def autoround_quantize(w_nk: torch.Tensor, x_rows: torch.Tensor, args: QuantizationArgs,
                       iters: int = 200, lr: float = 0.05) -> QuantizedTensor:
    """AutoRound one weight (N, K) on its device over the activation rows
    ``x_rows`` (R, K): the RTN scales and zero points, the learned codes
    (int8 for INT)."""
    N, K = w_nk.shape
    W = w_nk.float()
    scale, zp, g = _qparams(W, args)
    X = torch.as_tensor(x_rows).to(device=W.device, dtype=torch.float32)
    qmin, qmax = args.qrange
    q, _, _ = _autoround_solve(W, X, scale, zp, iters=int(iters), group_size=g,
                               qmin=float(qmin), qmax=float(qmax), lr=float(lr))
    vals = q.to(torch.int8) if args.type == QuantType.INT else q
    return QuantizedTensor(values=vals, scale=scale, zero_point=zp, global_scale=None,
                           shape=(N, K))


class AutoRoundModifier(Modifier):
    name = "AutoRoundModifier"
    needs_capture = True

    def begin_layer(self, ctx: LayerCtx, matched) -> Any:
        state = super().begin_layer(ctx, matched)
        state["X"] = {}  # key -> list of (take, K) row blocks on the device
        state["rows"] = {}
        return state

    def _keep(self, state, key: str, x2: torch.Tensor, mask: Optional[torch.Tensor],
              valid_rows: Optional[int]) -> None:
        """Keep up to MAX_ROWS valid rows of ``key``'s input, sampled on the
        device (``awq._observe_stats``); the budget counts valid rows."""
        kept = state["rows"].get(key, 0)
        if kept >= MAX_ROWS:
            return
        rows_total = int(np.prod(x2.shape[:-1]))
        masked = mask is not None and mask.numel() == rows_total
        n_valid = valid_rows if (masked and valid_rows is not None) else rows_total
        take = min(MAX_ROWS - kept, n_valid)
        if take <= 0:
            return
        _, _, rows = _observe_stats(x2, mask if masked else None, take)
        state["X"].setdefault(key, []).append(rows)
        state["rows"][key] = kept + take

    def observe(self, state, site: LinearSite, x_in, mask, capture) -> None:
        super().observe(state, site, x_in, mask, capture)
        vr = capture.get("_valid_rows")
        if site.is_expert and x_in.ndim == 3:
            for e in range(x_in.shape[0]):
                self._keep(state, site.expert_prefix(e), x_in[e], mask, vr)
            return
        self._keep(state, site.prefix, x_in.reshape(-1, x_in.shape[-1]), mask, vr)

    def _rows_for(self, state, key: str, k: int, device: torch.device) -> torch.Tensor:
        blocks = state["X"].get(key)
        if not blocks:
            logger.warning("AutoRound: no activations for %s; using unit rows", key)
            return torch.ones((1, k), dtype=torch.float32, device=device)
        return torch.cat(blocks, dim=0)

    def compress(self, state, site: LinearSite, group: str, scheme: QuantScheme) -> SiteResult:
        args = scheme.weights
        iters = self.spec.iters
        if site.is_expert:
            el = site.get()
            w = expert_weights_enk(el)
            qts = []
            for e in range(el.num_experts):
                key = site.expert_prefix(e) if site.name == "down_proj" else site.prefix
                X = self._rows_for(state, key, w.shape[-1], w.device)
                qts.append(autoround_quantize(w[e], X, args, iters))
            del w
            res = build_site_result(site, args, group, qt_per_expert=qts,
                                    act_args=scheme.input_activations)
        else:
            w = weight_nk(site.get())
            X = self._rows_for(state, site.prefix, w.shape[-1], w.device)
            qt = autoround_quantize(w, X, args, iters)
            del w
            res = build_site_result(site, args, group, qt=qt,
                                    act_args=scheme.input_activations)
        return self.finalize_site(state, site, scheme, res)
