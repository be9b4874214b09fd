"""Tiny-model language-model fitting.

Counterpart of ``quantizers_tpu/models/fit.py``. The perplexity protocol's
quality number is a *delta*: quantized perplexity minus bf16 perplexity.
On random weights that delta is noise, so the protocol first fits the tiny
model to its evaluation corpus, which makes the bf16 model a (local)
optimum that quantization can only damage.

This is protocol machinery, not a training framework: one device, full
gradients through the same ``forward`` the serving path uses, AdamW with
the JAX package's optax settings. The forward under autograd launches no
kernel: the kernels have no backward (the JAX package has none either),
so the no-cache attention takes its einsum branch wherever gradients are
recorded, and every kernel wrapper refuses an input that requires grad.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..ops.linear import QuantLinear
from .moe import ExpertLinears
from .transformer import forward

logger = logging.getLogger(__name__)

#: optax.adamw's defaults (b1, b2, eps, weight_decay); torch's AdamW
#: defaults to weight_decay 1e-2
ADAM_BETAS, ADAM_EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def _map_floats(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``tree`` with ``fn`` applied to every floating tensor, in a fixed
    order (dict keys in order, then list items; a linear's weight, scale,
    zero point, bias). Raises ``ValueError`` on a quantized linear: its
    codes take no gradient."""
    if isinstance(tree, dict):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, fn) for v in tree)
    if isinstance(tree, (QuantLinear, ExpertLinears)):
        if tree.kind != "dense":
            raise ValueError(f"fit_lm takes the dense params of init_params, not a "
                             f"{tree.kind} linear")
        return dataclasses.replace(tree, **{
            f: _map_floats(getattr(tree, f), fn)
            for f in ("weight", "scale", "zero_point", "bias")})
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def trainable(params: Dict[str, Any]) -> tuple:
    """(params32, leaves): a copy of ``params`` whose floating tensors are
    f32 leaves that require grad, and those leaves in :func:`_map_floats`'s
    order. ``params`` is left as it is."""
    leaves: List[torch.Tensor] = []

    def leaf(t: torch.Tensor) -> torch.Tensor:
        p = t.detach().to(torch.float32, copy=True).requires_grad_(True)
        leaves.append(p)
        return p

    return _map_floats(params, leaf), leaves


def lm_loss(spec, params: Dict[str, Any], batch: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` (B, T + 1) ids: the logits of
    ``batch[:, :-1]`` in f32, log-softmax, scored against ``batch[:, 1:]``
    (the JAX package's ``fit.py`` loss)."""
    logits, _ = forward(params, spec, batch[:, :-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, batch[:, 1:, None].long()).mean()


def cosine_decay(steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, steps)`` as a factor of ``lr`` at
    update ``i`` (from 0): ½(1 + cos(π · min(i, steps) / steps))."""
    steps = max(steps, 1)
    return lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))


def make_optimizer(leaves: List[torch.Tensor], lr: float, steps: int) -> tuple:
    """(AdamW, LambdaLR): ``optax.adamw(optax.cosine_decay_schedule(lr,
    steps))`` in PyTorch, the decay on every leaf (optax has no mask).
    Fused: the foreach path allocates temporaries the size of each list of
    parameters."""
    opt = torch.optim.AdamW(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                            weight_decay=WEIGHT_DECAY, fused=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))


def fit_lm(
    spec,
    params: Dict[str, Any],
    ids: np.ndarray,
    steps: int = 300,
    batch_size: int = 8,
    seq_len: int = 64,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 100,
) -> Dict[str, Any]:
    """Fit ``params`` on next-token prediction over ``ids``, on the device
    the params are on.

    Parameters are trained in float32 and returned in their original
    dtypes and structure. ``params`` must be the dense (unquantized) tree
    from ``init_params`` or a loaded bf16 checkpoint; ``params`` itself is
    not modified. Each step's windows are drawn as the JAX package draws
    them (``default_rng(seed).integers(0, n_starts, batch_size)``), so both
    packages fit on the same batches. The host reads the loss only at the
    steps it logs."""
    params32, leaves = trainable(params)
    ids = np.asarray(ids, np.int32)
    n_starts = len(ids) - seq_len - 1
    if n_starts <= 0:
        raise ValueError(f"corpus too short: {len(ids)} tokens for seq_len={seq_len}")
    rng = np.random.default_rng(seed)
    windows = np.lib.stride_tricks.sliding_window_view(ids, seq_len + 1)
    starts = np.array([rng.integers(0, n_starts, size=batch_size) for _ in range(steps)],
                      np.int64).reshape(steps, batch_size)
    dev = leaves[0].device
    # every step's batch goes to the device in one copy: no host sync a step
    batches = torch.as_tensor(windows[starts], device=dev)
    opt, sched = make_optimizer(leaves, lr, steps)
    for i in range(steps):
        loss = lm_loss(spec, params32, batches[i])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            logger.info("fit step %d/%d loss %.4f", i, steps, float(loss.detach()))

    dtypes: List[torch.dtype] = []
    _map_floats(params, lambda t: dtypes.append(t.dtype) or t)
    restore = iter(dtypes)
    return _map_floats(params32, lambda t: t.detach().to(next(restore)))
