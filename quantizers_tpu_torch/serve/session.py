"""Continuous batching: a slot-based serving session.

Counterpart of ``quantizers_tpu/serve/session.py``. A fixed decode batch
of ``max_batch`` slots runs over per-row KV-cache lengths. New requests are
prefilled as single rows (bucketed prompt lengths) and copied into a free
slot; every decode step advances all slots at once. Finished rows free
their slot for the next queued request between steps.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.config import ModelSpec
from ..models.transformer import (
    KVCache,
    forward,
    fuse_for_decode,
    quantize_lm_head,
    tree_to,
)
from .engine import prefill as _prefill_fn


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # (T,)
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)


@torch.no_grad()
def _decode_step(params, spec: ModelSpec, caches: List[KVCache], tokens: torch.Tensor):
    """One greedy decode step for the whole slot batch."""
    logits, caches = forward(params, spec, tokens[:, None], caches=caches)
    return torch.argmax(logits[:, 0], dim=-1), caches


def _merge_row(caches: List[KVCache], row_caches: List[KVCache], slot: int) -> List[KVCache]:
    """Copy a single-row prefilled cache into slot ``slot``, in place."""
    for c, rc in zip(caches, row_caches):
        c.k[slot] = rc.k[0]
        c.v[slot] = rc.v[0]
        c.length[slot] = rc.length[0]
    return caches


MOE_LAYOUTS = ("w8pc", "int8", "packed")
NVFP4_LAYOUTS = ("int8", "packed")
FP8_LAYOUTS = ("resident", "auto")


def _layout_arg(value: Optional[str], env: str, default: Optional[str], allowed) -> Optional[str]:
    if value is None:
        value = os.environ.get(env) or default
    if value is not None and value not in allowed:
        raise ValueError(f"{env.lower()} must be one of {allowed}, got {value!r}")
    return value


def serving_layout(spec: ModelSpec, params: Dict[str, Any],
                   head_bits: Optional[int] = None,
                   device: DeviceLike = None,
                   moe_layout: Optional[str] = None,
                   nvfp4_layout: Optional[str] = None,
                   fp8_layout: Optional[str] = None) -> Dict[str, Any]:
    """The params dict that :class:`ContinuousBatcher` serves, on ``device``.

    1. an optional quantized logits head (``head_bits``, per-channel int8:
       half the bytes of the tied bf16 table each step);
    2. :func:`~quantizers_tpu_torch.models.transformer.fuse_for_decode`
       (for MLA layers, the absorbed-decode weights);
    3. the MoE expert layout (``moe_layout``; ``None`` reads
       ``QTPU_MOE_LAYOUT``, default ``"w8pc"``): ``"w8pc"`` requantizes the
       expert stacks to the fused int8 per-channel layout
       (:func:`~quantizers_tpu_torch.ops.linear.moe_w8pc_layout`) when the
       int8 bytes fit the device, one layer at a time; ``"int8"`` keeps
       exact NVFP4 numerics in the int8-doubled layout; ``"packed"`` keeps
       the packed E2M1 experts;
    4. the NVFP4 layout of the other linears (``nvfp4_layout``; ``None``
       reads ``QTPU_NVFP4_LAYOUT``, else the capacity plan): ``"int8"``
       (int8-doubled) or ``"packed"``
       (:func:`~quantizers_tpu_torch.ops.linear.nvfp4_device_layout`);
    5. the fp8 layout (``fp8_layout``; ``None`` reads ``QTPU_FP8_LAYOUT``,
       default ``"resident"``): ``"resident"`` keeps fp8 weights at rest,
       served by the fp8 kernel, one byte per weight; ``"auto"`` hoists
       them to bf16 dense copies when the NVFP4 decision of step 4 takes
       the int8 layout (the JAX package's default, which it takes because
       no fused fp8 kernel serves them on a TPU v5e)
       (:func:`~quantizers_tpu_torch.ops.linear.fp8_device_layout`).

    On a CUDA device, steps 3 and 4 (and step 5's ``"auto"``) follow the
    capacity plan against the device's memory
    (:func:`~quantizers_tpu_torch.ops.linear.nvfp4_capacity_plan`), as the
    JAX package's do on a TPU. On the CPU no plan runs: the layouts are
    those the arguments name, defaulting to the card's defaults (w8pc
    experts, int8 NVFP4, resident fp8), so the CPU serves what the card
    serves.

    A layer's expert stacks are dropped as soon as they are requantized:
    when the caller keeps no other reference to ``params``, the packed and
    the w8pc experts are not resident in full at the same time.

    Under a mesh, ``params`` is a rank's own tree
    (:func:`~quantizers_tpu_torch.parallel.shard_params`, with its local
    spec): the layout runs on the shards in the JAX package's order (shard,
    then these steps), each step applying itself to the shard inside a
    parallel wrapper, and the plan sees the expert stacks' real shard
    count."""
    from ..ops.linear import (
        _nvfp4_layout_decision,
        fp8_device_layout,
        infer_expert_shards,
        moe_w8pc_layout,
        nvfp4_capacity_plan,
        nvfp4_device_layout,
    )

    dev = resolve_device(device)
    moe_layout = _layout_arg(moe_layout, "QTPU_MOE_LAYOUT", "w8pc", MOE_LAYOUTS)
    nvfp4_layout = _layout_arg(nvfp4_layout, "QTPU_NVFP4_LAYOUT", None, NVFP4_LAYOUTS)
    fp8_layout = _layout_arg(fp8_layout, "QTPU_FP8_LAYOUT", "resident", FP8_LAYOUTS)
    params = tree_to(params, dev)
    if head_bits:
        params = quantize_lm_head(spec, params, num_bits=head_bits)
    params = fuse_for_decode(spec, params)
    shards = infer_expert_shards(params)
    int8_ok = True  # the card's default where no plan runs
    if dev.type == "cuda":
        int8_ok = nvfp4_capacity_plan(params, expert_shards=shards, device=dev)["int8_ok"]
    if int8_ok and moe_layout == "w8pc":
        layers = params["layers"]  # a list of fuse_for_decode's own
        for i, layer in enumerate(layers):
            layers[i] = moe_w8pc_layout(layer)
    if nvfp4_layout is None:  # the legacy QTPU_KEEP_PACKED_NVFP4, else the plan
        nvfp4_int8 = _nvfp4_layout_decision(params, int8_ok, shards)
    else:
        nvfp4_int8 = nvfp4_layout == "int8"
    params = nvfp4_device_layout(params, nvfp4_int8=nvfp4_int8,
                                 nvfp4_int8_experts=int8_ok and moe_layout != "packed")
    return fp8_device_layout(params, fp8_dense=fp8_layout == "auto" and nvfp4_int8)


class ContinuousBatcher:
    """Greedy continuous-batching decoder.

    >>> s = ContinuousBatcher(spec, params, max_batch=4, max_len=256)
    >>> rid = s.submit([1, 2, 3], max_new_tokens=16)
    >>> results = s.run()          # {rid: [tokens...]}
    """

    def __init__(self, spec: ModelSpec, params: Dict[str, Any],
                 max_batch: int = 8, max_len: int = 2048,
                 prefill_buckets: Sequence[int] = (32, 128, 512, 2048),
                 eos_ids: Sequence[int] = (),
                 head_bits: Optional[int] = None,
                 device: DeviceLike = None,
                 moe_layout: Optional[str] = None,
                 nvfp4_layout: Optional[str] = None,
                 fp8_layout: Optional[str] = None) -> None:
        self.device = resolve_device(device)
        self.spec = spec
        self.params = serving_layout(spec, params, head_bits=head_bits, device=self.device,
                                     moe_layout=moe_layout, nvfp4_layout=nvfp4_layout,
                                     fp8_layout=fp8_layout)
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = sorted(b for b in prefill_buckets if b <= max_len) or [max_len]
        self.eos_ids = set(int(e) for e in eos_ids)
        self.caches = KVCache.init(spec, max_batch, max_len, device=self.device)
        self.tokens = torch.zeros((max_batch,), dtype=torch.long, device=self.device)
        self.slots: List[Optional[_Request]] = [None] * max_batch
        self.queue: Deque[_Request] = deque()
        self.finished: Dict[int, List[int]] = {}
        self._rid = itertools.count()
        self.steps = 0  # decode steps run

    # -- submission ----------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 64) -> int:
        prompt = np.asarray(list(prompt_ids), np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) >= max_len ({self.max_len})")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({self.max_len}); the KV cache cannot hold "
                f"the full generation")
        req = _Request(next(self._rid), prompt, max_new_tokens)
        self.queue.append(req)
        return req.rid

    # -- internals -----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            T = len(req.prompt)
            ids = np.zeros((1, self._bucket(T)), np.int64)
            ids[0, :T] = req.prompt
            row_caches = KVCache.init(self.spec, 1, self.max_len, device=self.device)
            _prefill_fn(self.params, self.spec, torch.from_numpy(ids).to(self.device),
                        row_caches)
            _merge_row(self.caches, row_caches, slot)
            # bucket padding advanced the row past T; rewind to T - 1 and
            # re-feed the last prompt token, so the first generated token
            # comes from the logits of true position T - 1 (the junk slots
            # beyond are overwritten before attention admits them)
            self.tokens[slot] = int(req.prompt[-1])
            for c in self.caches:
                c.length[slot] = T - 1
            self.slots[slot] = req

    def _retire(self) -> None:
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            done = len(req.out) >= req.max_new_tokens or (
                req.out and req.out[-1] in self.eos_ids)
            if done:
                self.finished[req.rid] = req.out
                self.slots[slot] = None
                # freed slots keep decoding as padding rows; reset their
                # length so an idle slot never walks toward the cache's end
                for c in self.caches:
                    c.length[slot] = 0

    # -- stepping ------------------------------------------------------------
    def step(self) -> None:
        """Admit, one decode step, collect."""
        self._admit()
        if all(s is None for s in self.slots):
            return
        self.tokens, self.caches = _decode_step(self.params, self.spec, self.caches,
                                                self.tokens)
        self.steps += 1
        host = self.tokens.cpu().numpy()
        for slot, req in enumerate(self.slots):
            if req is not None:
                req.out.append(int(host[slot]))
        self._retire()

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.finished)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)
