"""Decode engine: prefill, then a Python decode loop over in-place caches.

Counterpart of ``quantizers_tpu/serve/engine.py`` (``lax.scan`` becomes a
loop). The caches are updated in place, so the loop keeps the same device
buffers from the first step to the last: any caller that replays a decode
from one starting state clones the caches first. :func:`perplexity`, the
quality metric of ``cli/eval_ppl.py``, scores windows with a no-cache
forward, whose attention runs through the flash kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.config import ModelSpec
from ..models.transformer import KVCache, forward, tree_to

_PAD_MULT = 64


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64. Greedy at temperature 0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def prefill(params: Dict[str, Any], spec: ModelSpec, ids: torch.Tensor,
            caches: List[KVCache]) -> Tuple[torch.Tensor, List[KVCache]]:
    """Run the prompt into the caches; returns (last-position logits (B, V), caches)."""
    logits, caches = forward(params, spec, ids, caches=caches)
    return logits[:, -1], caches


@torch.no_grad()
def _decode_scan(params: Dict[str, Any], spec: ModelSpec, caches: List[KVCache],
                 first: torch.Tensor, generator: Optional[torch.Generator], *,
                 steps: int, temperature: float, top_k: int
                 ) -> Tuple[torch.Tensor, List[KVCache]]:
    """Emit ``steps`` tokens after ``first``; returns ((B, steps), caches)."""
    tok = first
    out = []
    for _ in range(steps):
        logits, caches = forward(params, spec, tok[:, None], caches=caches)
        tok = _sample(logits[:, 0], generator, temperature, top_k)
        out.append(tok)
    return torch.stack(out, dim=1), caches


def generate(spec: ModelSpec, params: Dict[str, Any], prompt_ids: Any,
             max_new_tokens: int = 32, temperature: float = 0.0, top_k: int = 0,
             seed: int = 0, max_len: Optional[int] = None,
             device: DeviceLike = None) -> np.ndarray:
    """Batch generation from equal-length prompts (B, T); returns
    (B, max_new_tokens) int32 ids. Sampling draws from a ``torch.Generator``
    seeded with ``seed``, so sampled ids differ from the JAX package's."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long, device=dev)
    B, T = ids.shape
    if max_len is None:
        max_len = -(-(T + max_new_tokens) // _PAD_MULT) * _PAD_MULT
    caches = KVCache.init(spec, B, max_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    last_logits, caches = prefill(params, spec, ids, caches)
    first = _sample(last_logits, gen, temperature, top_k)
    toks = first[:, None]
    if max_new_tokens > 1:
        rest, _ = _decode_scan(params, spec, caches, first, gen,
                               steps=max_new_tokens - 1,
                               temperature=float(temperature), top_k=int(top_k))
        toks = torch.cat([toks, rest], dim=1)
    return toks.to(torch.int32).cpu().numpy()


#: rows of the f32 log-softmax taken at a time in :func:`_nll`
_NLL_ROWS = 1024


@torch.no_grad()
def token_logprobs(params: Dict[str, Any], spec: ModelSpec, ids: torch.Tensor) -> torch.Tensor:
    """(B, T) ids -> (B, T - 1) f32 log-probabilities of the next tokens
    ``ids[:, 1:]`` under a no-cache forward: the f32 ``log_softmax`` of
    ``logits[:, :-1]``, taken over ``_NLL_ROWS`` positions at a time, which
    bounds its f32 transient (each row's values are those of one full call)."""
    logits, _ = forward(params, spec, ids)
    B, T, V = logits.shape
    lg = logits[:, :-1].reshape(-1, V)
    tgt = ids[:, 1:].reshape(-1, 1).long()
    return torch.cat([
        torch.gather(torch.log_softmax(lg[i:i + _NLL_ROWS].float(), dim=-1), -1,
                     tgt[i:i + _NLL_ROWS])[:, 0]
        for i in range(0, lg.shape[0], _NLL_ROWS)]).reshape(B, T - 1)


def _nll(params: Dict[str, Any], spec: ModelSpec, ids: torch.Tensor,
         mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked next-token NLL sum of one (B, T) batch and its token count
    (0-d f32 tensors), weighted by ``mask[:, 1:]``."""
    m = mask[:, 1:].float()
    return -(token_logprobs(params, spec, ids) * m).sum(), m.sum()


def perplexity(spec: ModelSpec, params: Dict[str, Any], batches,
               device: DeviceLike = None) -> float:
    """Masked next-token perplexity over numpy ``(ids, mask)`` batches."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    total, count = 0.0, 0.0
    for ids, mask in batches:
        nll, n = _nll(params, spec, torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev),
                      torch.as_tensor(np.asarray(mask), device=dev))
        total += float(nll)
        count += float(n)
    return float(np.exp(total / max(count, 1.0)))
