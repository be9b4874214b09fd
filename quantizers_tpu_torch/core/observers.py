"""Functional observers for calibration statistics.

Counterpart of ``quantizers_tpu/core/observers.py``: the observers the
reference's recipes name (``observer: minmax`` / ``memoryless_minmax`` at
reference ``configs/recipes/recipe_awq_w4a16.yaml:24`` and
``recipe_Minimax-M2.1-AWQ-MixedPrec.yaml:35,48``).

Observers are pure: ``init(batch, args) -> state``,
``update(state, batch, args) -> state``, ``qparams(state, args) ->
(scale, zero_point)``, over tensors on any device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .numerics import compute_scale_zp, minmax_along
from .scheme import QuantizationArgs


class MinMaxState(NamedTuple):
    min_val: torch.Tensor
    max_val: torch.Tensor
    count: torch.Tensor  # number of update() calls folded in


class Observer(NamedTuple):
    """A bundle of pure functions implementing one observer."""

    init: Callable[[torch.Tensor, QuantizationArgs], MinMaxState]
    update: Callable[[MinMaxState, torch.Tensor, QuantizationArgs], MinMaxState]
    qparams: Callable[[MinMaxState, QuantizationArgs], Tuple[torch.Tensor, torch.Tensor]]


def _init_from(batch: torch.Tensor, args: QuantizationArgs) -> MinMaxState:
    mn, mx = minmax_along(batch.float(), args)
    return MinMaxState(mn, mx, torch.ones((), dtype=torch.int32, device=batch.device))


def _minmax_update(state: MinMaxState, batch: torch.Tensor,
                   args: QuantizationArgs) -> MinMaxState:
    """Running min/max across all batches (llmcompressor ``minmax`` with
    averaging disabled: the envelope over every observed batch)."""
    mn, mx = minmax_along(batch.float(), args)
    return MinMaxState(torch.minimum(state.min_val, mn), torch.maximum(state.max_val, mx),
                       state.count + 1)


def _memoryless_update(state: MinMaxState, batch: torch.Tensor,
                       args: QuantizationArgs) -> MinMaxState:
    """``memoryless_minmax``: only the most recent batch matters."""
    mn, mx = minmax_along(batch.float(), args)
    return MinMaxState(mn, mx, state.count + 1)


def _moving_average_update(state: MinMaxState, batch: torch.Tensor, args: QuantizationArgs,
                           momentum: float = 0.9) -> MinMaxState:
    mn, mx = minmax_along(batch.float(), args)
    new_min = momentum * state.min_val + (1.0 - momentum) * mn
    new_max = momentum * state.max_val + (1.0 - momentum) * mx
    return MinMaxState(new_min, new_max, state.count + 1)


def _qparams(state: MinMaxState, args: QuantizationArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    return compute_scale_zp(state.min_val, state.max_val, args)


OBSERVERS: Dict[str, Observer] = {
    "minmax": Observer(_init_from, _minmax_update, _qparams),
    "memoryless_minmax": Observer(_init_from, _memoryless_update, _qparams),
    "moving_average_minmax": Observer(_init_from, _moving_average_update, _qparams),
}


def get_observer(name: str) -> Observer:
    if name in OBSERVERS:
        return OBSERVERS[name]
    if name == "mse":
        # over running statistics the mse search degenerates to the min/max
        # envelope, as in the JAX package; the data-aware search runs where
        # the weights are at hand (``core.numerics._mse_scale_zp``)
        return Observer(_init_from, _minmax_update, _qparams)
    raise ValueError(f"Unknown observer: {name!r}. Known: {sorted(OBSERVERS) + ['mse']}")


def observe_batches(batches: Any, args: QuantizationArgs,
                    observer_name: str = "minmax") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an iterable of tensors through an observer."""
    obs = get_observer(observer_name)
    state = None
    for b in batches:
        state = obs.init(b, args) if state is None else obs.update(state, b, args)
    if state is None:
        raise ValueError("observe_batches received no batches")
    return obs.qparams(state, args)
