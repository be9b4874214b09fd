#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA kernels of ``quantizers_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and evaluation paths give it, with timings
   beside the bound (the fp8 matmul and MLA decode kernels at path E's);
4. serve, slice 1: a Qwen3-4B-shaped W4A16 model at full width and depth
   (random weights from a seeded generator), ``serving_layout(head_bits=8)``,
   an 8 x 128 prefill and 256 greedy decode steps, with the kernels'
   launch counts checked; then the tied bf16 head layout;
5. serve, slice 2, path A (the main path): Qwen3-30B-A3B at full width and
   depth (48 layers) with NVFP4 experts and bf16 attention, laid out by
   ``serving_layout(head_bits=8)`` (w8pc experts on the card), an 8 x 128
   prefill, a greedy decode with exact per-step launch counts, a
   teacher-forced timed decode with the distinct experts per layer and the
   fraction of the bytes bound, and a profiled window; then 12 requests
   through ``ContinuousBatcher`` on the same params;
6. paths B and C at 8 layers: the packed and int8 expert layouts (slot
   kernel at decode, NVFP4 matmul in a row prefill) and dense NVFP4
   Qwen3-4B in both NVFP4 layouts, each with its launch counts checked;
7. card against CPU: slice 1 and path A at 2 layers, full width, through
   the same converted weights on both devices, prefill plus 15
   teacher-forced decode steps (path A: router choices compared too);
8. batcher, slice 1: 12 requests at full width;
9. path D (slice 3's main path), checkpoints in and perplexity out: a
   Qwen3-4B-shaped W4A16 g32 checkpoint at full width and depth (random
   weights from a seeded generator, quantized by the port and written with
   its ``save_compressed_model`` into a temporary directory), evaluated by
   ``cli/eval_ppl.main`` on the card over two (4, 2048) batches of a seeded
   synthetic text, with exact launch counts (flash attention only);
10. ``cli/serve.main`` on the same checkpoint: 8 prompts, int8 head;
11. card against CPU, path D: the checkpoint at 2 layers, one (1, 512)
    window scored on both devices (per-token NLL and perplexity);
12. path E (slice 5's main path), FP8_BLOCK MLA serving: DeepSeek-V2-Lite
    attention with a dense 8192-wide MLP at full width and all 27 layers
    (random bf16 weights from a seeded generator, quantized to FP8_BLOCK by
    the port), ``serving_layout(head_bits=8)`` (fp8 resident), an 8 x 128
    prefill and 128 greedy steps with exact per-step launch counts (the fp8
    matmul and the MLA decode kernel), the fraction of the bytes bound and
    a profiled window;
13. 12 requests through ``ContinuousBatcher`` on path E's params;
14. card against CPU, path E at 2 layers, full width: logits and greedy
    tokens with the bf16 latent cache and with the fp8 one, and one
    no-cache perplexity window (the flash kernel at head dim 256);
15. one JSON line of per-kernel numbers, then the card's nvidia-smi line,
    then the final ``{"ok": true, ...}`` line.

Longer per-shape numbers go to ``chiprun_out/chip_smoke_detail.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Qwen3-4B geometry (the JAX package's bench.py), tied embeddings
GEOMETRY = dict(vocab_size=151936, hidden_size=2560, num_layers=36, num_heads=32,
                num_kv_heads=8, head_dim=128, intermediate_size=9728,
                qk_norm=True, tie_word_embeddings=True, model_type="qwen3")
BATCH, PREFILL, STEPS, MAX_LEN, GROUP = 8, 128, 256, 512, 32

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: tolerances of the kernel checks. The matmuls: a fraction of the plain
#: output's largest |value|, 1e-2, about 2.5 bf16 ulps there (each side
#: rounds once, from f32 sums taken in another order); the NVFP4 matmuls per
#: output row. The slot FFNs: 1e-2 of each slot row's largest |value| (f32
#: outputs; a, rounded to bf16 on both sides, may round the other way after
#: f32 sums in another order, 2^-8 of one term). Decode attention: a
#: fraction of each (row, KV head)'s own largest |value|, so that the long
#: rows, whose values are small, are held as closely as the short ones; both
#: round p to bf16, the kernel before it normalises (against the running max
#: of its share of positions, with ex2.approx) and the plain version after
#: (at most 2^-9 of each term apart), which with the output's rounding
#: stays under 1e-2, and the limit is twice that. Flash attention: the same
#: limit of each (b, h, t) row's own largest |value|, for the same reasons
#: (a causal row averages ever more keys, so the late rows' values are
#: small): the kernel rounds p to bf16 against a running max over 128-key
#: tiles (64 at head dim 256) and takes exp as ex2.approx of a product with
#: log2 e, the plain version over 256-key tiles with exp (at most 2^-9 of
#: each term apart), and each side rounds its output once. The fp8 matmul: as the
#: other matmuls. MLA decode attention: each (row, head) against its own
#: largest |value|, as decode attention (both sides round p to bf16, after
#: f32 sums in other orders)
RTOL = {"w4_matmul": 1e-2, "w8_matmul": 1e-2, "decode_attention": 2e-2,
        "nvfp4_matmul": 1e-2, "nvfp4_i8_matmul": 1e-2, "moe_slot_ffn": 1e-2,
        "moe_slot_gu_ffn": 1e-2, "flash_attention": 2e-2, "fp8_matmul": 1e-2,
        "mla_decode_attention": 2e-2}
#: card against CPU, logits: f32 sums in other orders and cuBLAS for prefill
#: move a few bf16 roundings of the activations over two layers. Largest
#: |err| within 2e-2 of the largest |logit| (2.5 bf16 ulps there), and each
#: position's error norm within 2e-2 of its logits' norm
LOGIT_RTOL = 2e-2
LOGIT_NORM_RTOL = 2e-2
#: the card may pick another greedy token than the CPU only where the CPU's
#: top two logits lie within this many bf16 ulps of the top one
TIE_ULPS = 2


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def expect(**nonzero) -> dict:
    """Launch counts with every kernel at 0 but the ones named."""
    from quantizers_tpu_torch.ops import kernels as K

    want = {fn.__name__: 0 for fn in K.ALL_KERNELS}
    want.update(nonzero)
    return want


def fail(msg: str) -> None:
    log(f"chip_smoke: FAILED: {msg}")
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotating(items):
    """A callable source that cycles through copies of the inputs, so that a
    timed loop finds its weights out of the 50 MB L2 as the decode loop does."""
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]
    return nxt


def copies_for(nbytes: int) -> int:
    return max(1, min(16, math.ceil(160e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 tensor rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def w4_linear(gen, k: int, n: int, g: int = GROUP, random_scale: bool = False):
    from quantizers_tpu_torch.ops.linear import QuantLinear

    dev = gen.device
    packed = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, device=dev, generator=gen)
    if random_scale:
        scale = (torch.rand((k // g, n), device=dev, generator=gen) * 0.008 + 0.004).bfloat16()
    else:
        scale = torch.full((k // g, n), 0.008, dtype=torch.bfloat16, device=dev)
    return QuantLinear(kind="w4", weight=packed, scale=scale,
                       meta=(("k", k), ("n", n), ("group_size", g)))


def w8_linear(gen, k: int, n: int, g=None, scale_dtype=torch.bfloat16):
    from quantizers_tpu_torch.ops.linear import QuantLinear

    dev = gen.device
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
    rows = k // g if g else 1
    scale = (torch.rand((rows, n), device=dev, generator=gen) * 0.004 + 0.001).to(scale_dtype)
    return QuantLinear(kind="w8", weight=w, scale=scale, meta=(("k", k), ("n", n), ("group_size", g)))


def matmul_bytes(lin, m: int) -> int:
    k, n = lin.in_features, lin.out_features
    payload = lin.weight.numel() * lin.weight.element_size()
    scales = lin.scale.numel() * lin.scale.element_size()
    return m * k * 2 + payload + scales + m * n * 2


def time_matmul(wrapper, plain_fn, x, lin, row: dict) -> dict:
    """Kernel, plain and library times of ``x @ W^T`` (the library call is
    ``torch.matmul`` on the pre-dequantized bf16 weight), the kernel's and
    the library's device times, the weights rotated through copies past
    the L2, and the bound, into ``row``.
    ``plain_fn(x, lin)`` is the kernel's plain version."""
    m, k, n = x.shape[0], lin.in_features, lin.out_features
    nbytes = matmul_bytes(lin, m)
    copies = [lin] + [dataclasses.replace(lin, weight=lin.weight.clone(), scale=lin.scale.clone())
                      for _ in range(copies_for(nbytes) - 1)]
    wsrc = rotating(copies)
    dsrc = rotating([c.dequantize(torch.bfloat16) for c in copies[:2]])
    before = wrapper.launches
    row["ms"] = cuda_ms(lambda: wrapper(x, wsrc()))
    # a short kernel's launch-to-launch time is the host's cost of a call:
    # the profiler's device time is the kernel's own
    row["dev_ms"] = device_ms(lambda: wrapper(x, wsrc()))
    wrapper.launches = before  # timing launches are not main-path launches
    row["plain_ms"] = cuda_ms(lambda: plain_fn(x, wsrc()), iters=5, warmup=1)
    row["library_ms"] = cuda_ms(lambda: torch.matmul(x, dsrc()))
    row["library_dev_ms"] = device_ms(lambda: torch.matmul(x, dsrc()))
    row.update(bound(nbytes, 2 * m * k * n))
    return row


def check_matmul(name, kernel, plain_fn, gen, k, n, m, g, timed: bool,
                 scale_dtype=torch.bfloat16):
    lin = (w4_linear(gen, k, n, g, random_scale=True) if name == "w4_matmul"
           else w8_linear(gen, k, n, g, scale_dtype))
    x = torch.randn((m, k), device=gen.device, generator=gen).bfloat16()
    got = kernel(x, lin)
    ref = plain_fn(x, lin)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = RTOL[name] * scale
    check(bool(torch.isfinite(got).all()), f"{name} {m}x{k}x{n}: non-finite output")
    check(err <= tol, f"{name} {m}x{k}x{n}: max |err| {err:.4g} > tol {tol:.4g}")
    check(torch.equal(kernel(x, lin), got), f"{name} {m}x{k}x{n}: differs from run to run")
    row = {"m": m, "k": k, "n": n, "g": g, "max_abs_err": err, "tol": tol}
    return time_matmul(kernel, plain_fn, x, lin, row) if timed else row


def w8_plain(x, lin):
    """K3's plain version on a w8 linear."""
    from quantizers_tpu_torch.ops import kernels as K

    return K.w8_matmul_plain(x, lin.weight, lin.scale, lin.meta_dict["group_size"])


#: K3's int8 logits heads (K, N) at decode, m 8, bf16 scales per channel:
#: slice 1's (Qwen3-4B, the kernels line's row) and path A's (Qwen3-30B-A3B),
#: vocab 151936 padded to 152064, and path E's (DeepSeek-V2-Lite attention),
#: 102400 padded to 102912 (quantize_lm_head pads to a multiple of 1536)
W8_HEADS = {"head": (2560, 152064), "head_A": (2048, 152064), "head_E": (2048, 102912)}
#: the w8pc experts' (K, N) (f32 scales per channel), which path A's row
#: prefills run at m 32 and 128, two calls per expert and layer
W8PC_EXPERTS = {"w8pc_gate_up": (2048, 1536), "w8pc_down": (768, 2048)}


def w8_heads(gen, timed: bool = True) -> dict:
    """K3 at the three heads (m 8), each checked against its plain version
    and timed (time_matmul), and at one g 32 shape checked."""
    from quantizers_tpu_torch.ops import kernels as K

    rows = {f"{label}@m8": check_matmul("w8_matmul", K.w8_matmul, w8_plain, gen, k, n, 8, None,
                                        timed)
            for label, (k, n) in W8_HEADS.items()}
    rows["group32@m8"] = check_matmul("w8_matmul", K.w8_matmul, w8_plain, gen, 2560, 6144, 8, 32,
                                      timed=False)
    for label, r in rows.items():
        log(f"[kernels] w8 {label}: {r}")
    return rows


def w8_experts(gen, timed: bool = True) -> dict:
    """K3 at the w8pc expert shapes with f32 scales, m 32 and 128."""
    from quantizers_tpu_torch.ops import kernels as K

    rows = {f"{label}@m{m}": check_matmul("w8_matmul", K.w8_matmul, w8_plain, gen, k, n, m, None,
                                          timed, scale_dtype=torch.float32)
            for m in (32, 128) for label, (k, n) in W8PC_EXPERTS.items()}
    for label, r in rows.items():
        log(f"[kernels] w8 f32 scales {label}: {r}")
    return rows


#: the four w4 calls of a Qwen3-4B decoder layer (K, N): qkv, o_proj,
#: gate|up and down, as serving_layout fuses them
W4_LAYER = {"qkv": (2560, 4096 + 2 * 1024), "o_proj": (4096, 2560), "gate_up": (2560, 2 * 9728),
            "down": (9728, 2560)}


def w4_layer(gen, m: int, timed: bool = True) -> dict:
    """K1 at the four W4_LAYER shapes with ``m`` rows of x, each checked
    against its plain version and, with ``timed``, timed (time_matmul);
    logs the sum of the four device times."""
    from quantizers_tpu_torch.ops import kernels as K

    plain4 = lambda x, lin: K.w4_matmul_plain(x, lin.weight, lin.scale, GROUP)  # noqa: E731
    rows = {}
    for label, (k, n) in W4_LAYER.items():
        rows[label] = check_matmul("w4_matmul", K.w4_matmul, plain4, gen, k, n, m, GROUP, timed)
        log(f"[kernels] w4 {label} m={m}: {rows[label]}")
    if timed:
        log(f"[kernels] w4 layer m={m}: dev_ms {sum(r['dev_ms'] for r in rows.values())}, "
            f"library_dev_ms {sum(r['library_dev_ms'] for r in rows.values())}")
    return rows


#: K2's shapes at batch 8: (KV heads, query heads per KV head, cache slots,
#: the L every row is timed at). main() runs the two serving shapes, slice
#: 1's Qwen3-4B and path A's Qwen3-30B-A3B mid-decode; "long" (slice 1's
#: heads over a full 2048-slot cache) is for timing a redesign by hand
DECODE_SHAPES = {"slice1": (8, 4, MAX_LEN, 255), "path_A": (4, 8, MAX_LEN, 255),
                 "long": (8, 4, 2048, 2047)}


def check_decode_attention(gen, timed: bool, shape: str = "slice1"):
    from quantizers_tpu_torch.ops import kernels as K

    (KV, rep, S, L_timed), B, hd = DECODE_SHAPES[shape], BATCH, 128
    dev = gen.device

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen).bfloat16()

    q, nk, nv = rnd(B, KV, rep, hd), rnd(B, KV, hd), rnd(B, KV, hd)
    ck, cv = rnd(B, KV, S, hd), rnd(B, KV, S, hd)
    # empty, early, middle, S-1 and past the end (clamped to S-1)
    lengths = torch.tensor([0, 1, 100, 255, 256, 400, S - 1, S + 88],
                           dtype=torch.int32, device=dev)
    # stale rows past each length hold NaN: they must never reach a product
    pos = torch.arange(S, device=dev)[None, :]
    stale = pos > lengths.clamp(max=S - 1)[:, None]
    ck[stale[:, None, :, None].expand_as(ck)] = float("nan")
    cv[stale[:, None, :, None].expand_as(cv)] = float("nan")
    sm = 1.0 / math.sqrt(hd)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got = K.decode_attention(q, nk, nv, k1, v1, lengths, sm)
    ref = K.decode_attention_plain(q, nk, nv, k2, v2, lengths, sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"decode_attention {shape}: non-finite output")
    # each (row, KV head) against its own largest |value|
    errs = (got.float() - ref.float()).abs().amax(dim=(2, 3))
    tols = RTOL["decode_attention"] * ref.float().abs().amax(dim=(2, 3))
    ratio = errs / tols
    b, h = divmod(int(ratio.argmax()), KV)
    err, tol = errs[b, h].item(), tols[b, h].item()
    worst = f"b={b} kv={h} L={int(lengths[b])}"
    check(bool((ratio <= 1).all()),
          f"decode_attention {shape}: {worst}: max |err| {err:.4g} > tol {tol:.4g}")
    same = lambda a, b: bool(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))  # noqa: E731
    check(same(k1, k2) and same(v1, v2), f"decode_attention {shape}: cache rows written differ")
    L = lengths.clamp(max=S - 1).long()
    rows = torch.arange(B, device=dev)
    check(torch.equal(k1[rows, :, L], nk) and torch.equal(v1[rows, :, L], nv),
          f"decode_attention {shape}: new row not at min(length, S-1)")
    check(torch.equal(K.decode_attention(q, nk, nv, ck.clone(), cv.clone(), lengths, sm), got),
          f"decode_attention {shape}: differs from run to run")
    row = {"shape": shape, "B": B, "KV": KV, "rep": rep, "S": S, "lengths": lengths.tolist(),
           "max_abs_err": err, "tol": tol, "worst_at": worst,
           "max_err_per_row": errs.amax(1).tolist(), "tol_per_row": tols.amin(1).tolist()}
    if not timed:
        return row
    # timing with every row at L_timed (the serving path's mid-decode state)
    Lt = torch.full((B,), L_timed, dtype=torch.int32, device=dev)
    ck, cv = rnd(B, KV, S, hd), rnd(B, KV, S, hd)
    cache_bytes = 2 * ck.numel() * 2
    caches = rotating([(ck, cv)] + [(ck.clone(), cv.clone())
                                    for _ in range(copies_for(cache_bytes // 2) - 1)])

    def kern():
        a, b = caches()
        return K.decode_attention(q, nk, nv, a, b, Lt, sm)

    def plain():
        a, b = caches()
        return K.decode_attention_plain(q, nk, nv, a, b, Lt, sm)

    mask = (pos <= L_timed)[:, None, None, :].expand(B, 1, 1, S)
    qh = q.reshape(B, KV * rep, 1, hd)

    def library():
        a, b = caches()
        return F.scaled_dot_product_attention(qh, a, b, attn_mask=mask, scale=sm,
                                              enable_gqa=True)

    before = K.decode_attention.launches
    row["ms"] = cuda_ms(kern)
    row["dev_ms"] = device_ms(kern)
    K.decode_attention.launches = before
    row["plain_ms"] = cuda_ms(plain, iters=10)
    row["library_ms"] = cuda_ms(library)
    row["library_dev_ms"] = device_ms(library)
    n_pos = L_timed + 1  # positions 0..L_timed
    nbytes = (q.numel() * 2 * 2  # q in, ctx out
              + 2 * nk.numel() * 2  # new rows in
              + 2 * B * KV * L_timed * hd * 2  # cached K and V read
              + 2 * nk.numel() * 2)  # new rows written
    row.update(bound(nbytes, 4 * B * KV * rep * n_pos * hd))
    row["timed_at"] = f"L={L_timed} all rows"
    return row


# ---------------------------------------------------------------------------
# phase 4: the served model, slice 1
# ---------------------------------------------------------------------------

def build_params(spec, gen):
    """Random packed w4 payloads and constant 0.008 scales, as bench.py."""
    dev = gen.device
    D, Ff = spec.hidden_size, spec.intermediate_size

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    layers = []
    for _ in range(spec.num_layers):
        layers.append({
            "input_layernorm": ones(D), "post_attention_layernorm": ones(D),
            "q_proj": w4_linear(gen, D, spec.q_dim), "k_proj": w4_linear(gen, D, spec.kv_dim),
            "v_proj": w4_linear(gen, D, spec.kv_dim), "o_proj": w4_linear(gen, spec.q_dim, D),
            "q_norm": ones(spec.head_dim), "k_norm": ones(spec.head_dim),
            "mlp": {"gate_proj": w4_linear(gen, D, Ff), "up_proj": w4_linear(gen, D, Ff),
                    "down_proj": w4_linear(gen, Ff, D)},
        })
    embed = (torch.randn((spec.vocab_size, D), device=dev, generator=gen) * 0.02).bfloat16()
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": None}


def tensor_bytes(tree) -> int:
    from quantizers_tpu_torch.models.moe import ExpertLinears
    from quantizers_tpu_torch.ops.linear import QuantLinear

    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, (QuantLinear, ExpertLinears)):
        return sum(tensor_bytes(t) for t in (tree.weight, tree.scale, tree.zero_point, tree.bias))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def step_bytes(spec, params, tied: bool) -> dict:
    """Bytes one decode step must read: every weight once (the embedding
    gather reads B rows; the tied head reads the whole table) plus the KV
    cache, as the full window or as the valid prefix averaged over the run."""
    layers = tensor_bytes(params["layers"]) + tensor_bytes(params["final_norm"])
    head = tensor_bytes(params["embed"]) if tied else tensor_bytes(params["lm_head"])
    row_kv = spec.num_layers * BATCH * spec.num_kv_heads * spec.head_dim * 2 * 2
    full_kv = row_kv * MAX_LEN
    mean_valid = sum(PREFILL + i + 1 for i in range(STEPS)) / STEPS
    return {"weights": layers + head, "kv_full": full_kv, "kv_valid": int(row_kv * mean_valid)}


def time_decode(spec, params, caches0, first, label, steps: int = STEPS):
    from quantizers_tpu_torch.serve.engine import _decode_scan

    warm = [c.clone() for c in caches0]
    _decode_scan(params, spec, warm, first, None, steps=4, temperature=0.0, top_k=0)
    del warm
    caches = [c.clone() for c in caches0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, first, None, steps=steps,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[serve:{label}] {steps} steps x batch {BATCH}: {dt:.3f} s, "
        f"{dt / steps * 1e3:.3f} ms/step, {BATCH * steps / dt:.1f} tok/s")
    return toks, dt


def device_profile(run, steps: int) -> dict:
    """Device busy time per step from a torch.profiler trace of ``run``
    (which takes ``steps`` steps), beside the wall time of the same
    (profiled, so slower) window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels and copies only
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    return {"steps": steps, "device_busy_ms_per_step": busy_ms,
            "profiled_wall_ms_per_step": wall_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top": [{"name": k[:60], "ms_per_step": us / 1e3 / steps, "calls_per_step": c / steps}
                    for us, k, c in rows[:10]]}


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn`` (every kernel and copy it runs),
    from a profiled run of ``iters`` calls."""
    return device_profile(lambda: [fn() for _ in range(iters)], iters)["device_busy_ms_per_step"]


def profile_decode(spec, params, caches0, first, steps: int = 8) -> dict:
    from quantizers_tpu_torch.serve.engine import _decode_scan

    caches = [c.clone() for c in caches0]
    return device_profile(lambda: _decode_scan(params, spec, caches, first, None, steps=steps,
                                               temperature=0.0, top_k=0), steps)


def serve_phase(gen, detail):
    from quantizers_tpu_torch.models import KVCache, ModelSpec
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    spec = ModelSpec(**GEOMETRY)
    dev = gen.device
    t0 = time.perf_counter()
    raw = build_params(spec, gen)
    params = serving_layout(spec, raw, head_bits=8, device=dev)
    torch.cuda.synchronize()
    log(f"[serve] params + serving_layout(head_bits=8): {time.perf_counter() - t0:.1f} s")
    head = params["lm_head"]
    check(head.kind == "w8" and head.meta_dict["orig_n"] == spec.vocab_size
          and head.out_features == 152064, "int8 head layout")
    check("qkv_proj" in params["layers"][0] and "gateup_proj" in params["layers"][0]["mlp"],
          "fused decode layout")
    ids = ((torch.arange(BATCH * PREFILL, device=dev).reshape(BATCH, PREFILL) * 97 + 1)
           % spec.vocab_size)

    # warm-up run (cuBLAS handles, allocator): not counted
    wc = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    last, wc = prefill(params, spec, ids, wc)
    _decode_scan(params, spec, wc, last.argmax(-1), None, steps=2, temperature=0.0, top_k=0)
    del wc

    # the main path, with every launch count set to 0 just before it
    caches = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = prefill(params, spec, ids, caches)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = K.launch_counts()
    first = last.argmax(-1)
    caches0 = [c.clone() for c in caches]
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, first, None, steps=STEPS,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"[serve] prefill {BATCH}x{PREFILL}: {t_prefill * 1e3:.1f} ms; launches {after_prefill}")
    log(f"[serve] decode {STEPS} steps: {t_decode:.3f} s; launches {counts}")
    check(not any(after_prefill.values()),
          f"prefill at m={BATCH * PREFILL} must launch no kernel: {after_prefill}")
    L = spec.num_layers
    want = expect(w4_matmul=L * 4 * STEPS, w8_matmul=STEPS, decode_attention=L * STEPS)
    check(counts == want, f"decode launch counts {counts} != {want}")
    check(toks.shape == (BATCH, STEPS) and bool(((toks >= 0) & (toks < spec.vocab_size)).all()),
          "decoded ids out of range")
    check(all(int(c.length[0]) == PREFILL + STEPS for c in caches), "cache lengths")

    # a second timed run from the same start (the caches are cloned: the
    # loop writes them in place), then short profiled windows of decode and
    # of one more prefill
    _, t_decode2 = time_decode(spec, params, caches0, first, "w8-head")
    detail["profile"] = profile_decode(spec, params, caches0, first)
    log(f"[serve] profile: {json.dumps(detail['profile'])}")
    pc = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    detail["profile_prefill"] = device_profile(lambda: prefill(params, spec, ids, pc), 1)
    log(f"[serve] profile prefill: {json.dumps(detail['profile_prefill'])}")
    del pc
    sb = step_bytes(spec, params, tied=False)
    best = min(t_decode, t_decode2) / STEPS
    bound_valid = (sb["weights"] + sb["kv_valid"]) / HBM_BYTES_PER_S
    bound_full = (sb["weights"] + sb["kv_full"]) / HBM_BYTES_PER_S
    w8 = {"tok_s": BATCH / best, "ms_per_step": best * 1e3,
          "prefill_ms": t_prefill * 1e3, "bytes_per_step": sb,
          "bound_ms_valid_kv": bound_valid * 1e3, "bound_ms_full_kv": bound_full * 1e3,
          "frac_of_bound_valid_kv": bound_valid / best, "frac_of_bound_full_kv": bound_full / best}
    log(f"[serve] w8 head: {w8['tok_s']:.1f} tok/s, {w8['ms_per_step']:.3f} ms/step; "
        f"bound {w8['bound_ms_valid_kv']:.3f} ms (valid KV) / {w8['bound_ms_full_kv']:.3f} ms "
        f"(full window): {w8['frac_of_bound_valid_kv']:.4f} / {w8['frac_of_bound_full_kv']:.4f}")
    del params, caches, caches0

    # the tied bf16 head layout
    tied = serving_layout(spec, raw, device=dev)
    c = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    last, c = prefill(tied, spec, ids, c)
    before = K.launch_counts()
    _, t_tied = time_decode(spec, tied, c, last.argmax(-1), "bf16-head")
    detail["profile_bf16_head"] = profile_decode(spec, tied, c, last.argmax(-1))
    log(f"[serve] profile bf16 head: {json.dumps(detail['profile_bf16_head'])}")
    got = K.launch_counts()
    check(got["w8_matmul"] == before["w8_matmul"], "the tied head launched the w8 kernel")
    sbt = step_bytes(spec, tied, tied=True)
    bt = (sbt["weights"] + sbt["kv_valid"]) / HBM_BYTES_PER_S
    detail["serve"] = {"w8_head": w8, "bf16_head": {
        "tok_s": BATCH * STEPS / t_tied, "ms_per_step": t_tied / STEPS * 1e3,
        "bound_ms_valid_kv": bt * 1e3, "frac_of_bound_valid_kv": bt / (t_tied / STEPS)}}
    log(f"[serve] bf16 head: {detail['serve']['bf16_head']}")
    del tied, c
    return spec, raw, counts


# ---------------------------------------------------------------------------
# phase 7: card against CPU through the same converted weights
# ---------------------------------------------------------------------------

def logits_agree(label: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The card's logits against the CPU's: largest |err| within LOGIT_RTOL
    of the largest |logit|, each position's error norm within
    LOGIT_NORM_RTOL, the same greedy token except where the CPU's top two
    logits are a near-tie (the top one's bf16 ulp is
    2^(floor(log2 |top|) - 7))."""
    check(bool(torch.isfinite(got).all()), f"{label}: card logits not finite")
    err = (got - ref).abs().max().item()
    tol = LOGIT_RTOL * ref.abs().max().item()
    norm_err = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    top2 = ref.topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[..., 0].abs())) - 7)
    tie = (top2[..., 0] - top2[..., 1]) <= TIE_ULPS * ulp
    agree = got.argmax(-1) == ref.argmax(-1)
    row = {"max_abs_err": err, "tol": tol, "max_abs_logit": ref.abs().max().item(),
           "max_rel_norm_err": norm_err, "rel_norm_tol": LOGIT_NORM_RTOL,
           "positions": agree.numel(), "argmax_agreement": agree.float().mean().item(),
           "near_ties": int(tie.sum())}
    log(f"[{label}] {row}")
    check(err <= tol, f"{label}: max |err| {err:.4g} > tol {tol:.4g}")
    check(norm_err <= LOGIT_NORM_RTOL,
          f"{label}: relative error norm {norm_err:.4g} > {LOGIT_NORM_RTOL}")
    check(bool((agree | tie).all()), f"{label}: greedy token differs at "
          f"{int((~agree & ~tie).sum())} positions that are no near-tie")
    return row


def card_vs_cpu(detail, devices=("cuda", "cpu")):
    from quantizers_tpu_torch.convert import params_from_numpy
    from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
    from quantizers_tpu_torch.serve import serving_layout

    spec = ModelSpec(**dict(GEOMETRY, num_layers=2))
    rng = np.random.default_rng(1234)
    D, Ff = spec.hidden_size, spec.intermediate_size

    def lin(k, n):
        return {"kind": "w4", "weight": rng.integers(0, 256, (k // 2, n), dtype=np.uint8),
                "scale": rng.uniform(0.004, 0.012, (k // GROUP, n)).astype(np.float32),
                "meta": (("k", k), ("n", n), ("group_size", GROUP))}

    ones = lambda n: np.ones((n,), np.float32)  # noqa: E731
    tree = {"embed": (rng.standard_normal((spec.vocab_size, D)) * 0.02).astype(np.float32),
            "layers": [{"input_layernorm": ones(D), "post_attention_layernorm": ones(D),
                        "q_proj": lin(D, spec.q_dim), "k_proj": lin(D, spec.kv_dim),
                        "v_proj": lin(D, spec.kv_dim), "o_proj": lin(spec.q_dim, D),
                        "q_norm": ones(spec.head_dim), "k_norm": ones(spec.head_dim),
                        "mlp": {"gate_proj": lin(D, Ff), "up_proj": lin(D, Ff),
                                "down_proj": lin(Ff, D)}}
                       for _ in range(spec.num_layers)],
            "final_norm": ones(D), "lm_head": None}

    def as_bf16(p):
        # numpy has no bf16: norms, embedding and scales cross as f32
        for layer in p["layers"]:
            for key, v in list(layer.items()):
                if isinstance(v, torch.Tensor):
                    layer[key] = v.bfloat16()
            for q in [layer[k] for k in ("q_proj", "k_proj", "v_proj", "o_proj")] + \
                    list(layer["mlp"].values()):
                q.scale = q.scale.bfloat16()
        p["embed"], p["final_norm"] = p["embed"].bfloat16(), p["final_norm"].bfloat16()
        return p

    B, T, n_dec = 2, 16, 16
    ids = rng.integers(1, spec.vocab_size, (B, T + n_dec))
    out = {}
    for dev in devices:
        t0 = time.perf_counter()
        p = serving_layout(spec, as_bf16(params_from_numpy(tree, device=dev)),
                           head_bits=8, device=dev)
        caches = KVCache.init(spec, B, 64, device=dev)
        logits = []
        with torch.no_grad():
            lg, caches = forward(p, spec, torch.as_tensor(ids[:, :T], device=dev), caches=caches)
            logits.append(lg[:, -1].float().cpu())
            for t in range(T, T + n_dec - 1):
                lg, caches = forward(p, spec, torch.as_tensor(ids[:, t:t + 1], device=dev),
                                     caches=caches)
                logits.append(lg[:, -1].float().cpu())
        out[dev] = torch.stack(logits, 1)
        log(f"[card-vs-cpu] {dev}: {time.perf_counter() - t0:.1f} s")
        del p, caches
    got, ref = (out[d] for d in devices)
    detail["card_vs_cpu"] = {"layers": 2, "prefill": [B, T], "decode_steps": n_dec - 1,
                             **logits_agree("card-vs-cpu", got, ref)}


# ---------------------------------------------------------------------------
# phase 8: the batcher, slice 1
# ---------------------------------------------------------------------------

def batcher_phase(spec, raw, gen, detail):
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import ContinuousBatcher

    rng = torch.Generator().manual_seed(7)
    t0 = time.perf_counter()
    s = ContinuousBatcher(spec, raw, max_batch=8, max_len=MAX_LEN, head_bits=8, device=gen.device)
    reqs = {}
    for _ in range(12):
        T = int(torch.randint(5, 121, (1,), generator=rng))
        n = int(torch.randint(16, 33, (1,), generator=rng))
        prompt = torch.randint(1, spec.vocab_size, (T,), generator=rng).tolist()
        reqs[s.submit(prompt, n)] = n
    K.reset_launch_counts()
    res = s.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    check(sorted(res) == sorted(reqs), "batcher: not every request finished")
    for rid, n in reqs.items():
        check(len(res[rid]) == n, f"batcher: request {rid} has {len(res[rid])} != {n} tokens")
        check(all(0 <= t < spec.vocab_size for t in res[rid]), "batcher: id out of range")
    check(all(counts[k] > 0 for k in ("w4_matmul", "w8_matmul", "decode_attention"))
          and counts == expect(**{k: counts[k] for k in ("w4_matmul", "w8_matmul",
                                                           "decode_attention")}),
          f"batcher: a slice-1 kernel never launched, or another one did: {counts}")
    detail["batcher"] = {"requests": 12, "tokens": sum(reqs.values()), "seconds": dt,
                         "launches": counts}
    log(f"[batcher] {detail['batcher']}")


# ---------------------------------------------------------------------------
# slice 2: NVFP4 and MoE (phase 3's second half, phases 5-7)
# ---------------------------------------------------------------------------

#: Qwen3-30B-A3B geometry (the JAX package's benchmarks/bench_moe.py), tied
#: embeddings, all 48 layers
MOE_GEOMETRY = dict(vocab_size=151936, hidden_size=2048, num_layers=48, num_heads=32,
                    num_kv_heads=4, head_dim=128, intermediate_size=6144, qk_norm=True,
                    tie_word_embeddings=True, num_experts=128, num_experts_per_tok=8,
                    moe_intermediate_size=768, norm_topk_prob=True, model_type="qwen3_moe")
#: greedy steps with exact launch counts, then teacher-forced timed steps
MOE_STEPS, MOE_TIMED_STEPS = 16, 64
#: depth of paths B (packed and int8 experts) and C (dense NVFP4 Qwen3-4B)
SIDE_LAYERS, SIDE_STEPS = 8, 8
NVFP4_G = 16
#: card against CPU, path A: a token's top-k experts may differ between the
#: two devices only where the CPU's k-th and (k+1)-th router probabilities
#: lie within this fraction of the k-th (the router's f32 logits come from
#: bf16 activations that the two devices round apart by an ulp or so)
ROUTE_GAP_RTOL = 2e-2


def nvfp4_linear(gen, k: int, n: int, layout: str = "packed"):
    """Random E2M1 codes with bf16 scales in [0.004, 0.012]; ``int8``: the
    int8-doubled layout of the same weights."""
    from quantizers_tpu_torch.ops.linear import QuantLinear, nvfp4_packed_to_i8

    dev = gen.device
    packed = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8, device=dev, generator=gen)
    scale = (torch.rand((k // NVFP4_G, n), device=dev, generator=gen) * 0.008 + 0.004).bfloat16()
    if layout == "int8":
        packed, scale = nvfp4_packed_to_i8(packed), (scale.float() * 0.5).bfloat16()
    return QuantLinear(kind="nvfp4", weight=packed, scale=scale,
                       meta=(("k", k), ("n", n), ("group_size", NVFP4_G)))


def row_check(name: str, got, ref, label: str):
    """Each output row against its own largest |value|; returns the worst
    row's (err, tol)."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
    errs = (got.float() - ref.float()).abs().amax(dim=1)
    tols = RTOL[name] * ref.float().abs().amax(dim=1)
    ratio = errs / tols
    i = int(ratio.argmax())
    err, tol = errs[i].item(), tols[i].item()
    check(bool((ratio <= 1).all()), f"{name} {label}: row {i}: max |err| {err:.4g} > tol {tol:.4g}")
    return err, tol


def check_nvfp4(gen, k: int, n: int, m: int, layout: str, timed: bool) -> dict:
    from quantizers_tpu_torch.ops import kernels as K

    name = "nvfp4_i8_matmul" if layout == "int8" else "nvfp4_matmul"
    wrapper = getattr(K, name)
    lin = nvfp4_linear(gen, k, n, layout)
    x = torch.randn((m, k), device=gen.device, generator=gen).bfloat16()
    label = f"{m}x{k}x{n}"
    got = wrapper(x, lin)
    err, tol = row_check(name, got, K.nvfp4_matmul_plain(x, lin.weight, lin.scale, NVFP4_G), label)
    check(torch.equal(wrapper(x, lin), got), f"{name} {label}: differs from run to run")
    row = {"m": m, "k": k, "n": n, "max_abs_err": err, "tol": tol}
    if not timed:
        return row
    return time_matmul(wrapper, lambda x, c: K.nvfp4_matmul_plain(x, c.weight, c.scale, NVFP4_G),
                       x, lin, row)


def moe_stacks(gen, payload: str, E: int, D: int, Fe: int, damp: float = 1.0):
    """gate, up (E, D, F) and down (E, F, D) stacks of random payloads with
    constant 0.01 scales (down scaled by ``damp``), as benchmarks/bench_moe.py
    builds them: packed w4 (g 32), packed E2M1 or int8-doubled E2M1 (g 16)."""
    from quantizers_tpu_torch.models.moe import ExpertLinears
    from quantizers_tpu_torch.ops.linear import nvfp4_packed_to_i8

    dev = gen.device
    kind, g = ("w4", 32) if payload == "w4" else ("nvfp4", NVFP4_G)

    def one(k, n, s):
        w = torch.randint(0, 256, (E, k // 2, n), dtype=torch.uint8, device=dev, generator=gen)
        sc = torch.full((E, k // g, n), s, dtype=torch.bfloat16, device=dev)
        if payload == "int8":
            w, sc = nvfp4_packed_to_i8(w), (sc.float() * 0.5).bfloat16()
        return ExpertLinears(kind=kind, weight=w, scale=sc,
                             meta=(("k", k), ("n", n), ("group_size", g)))
    return one(D, Fe, 0.01), one(D, Fe, 0.01), one(Fe, D, 0.01 * damp)


def w8pc_stacks(gen, E: int, D: int, Fe: int, scale_dtype=torch.float32):
    """The fused w8pc layout: gate|up int8 (E, D, 2F) and down int8 (E, F, D),
    codes over the full range -128..127, per-channel scales (E, 1, N), f32
    as the serving layout holds them (or ``scale_dtype``)."""
    from quantizers_tpu_torch.models.moe import ExpertLinears

    dev = gen.device

    def one(k, n, meta):
        return ExpertLinears(
            kind="w8", weight=torch.randint(-128, 128, (E, k, n), dtype=torch.int8, device=dev,
                                            generator=gen),
            scale=(torch.rand((E, 1, n), device=dev, generator=gen) * 0.0015
                   + 5e-4).to(scale_dtype),
            meta=(("k", k), ("n", n), ("group_size", None)) + meta)
    return one(D, 2 * Fe, (("fused", "gate_up"),)), one(Fe, D, ())


def routed_ids(gen, tokens: int = BATCH, E: int = 128, k: int = 8) -> torch.Tensor:
    """Slot expert ids as a router gives them: top-k of random logits per
    token (64 slots over about 50 distinct experts)."""
    logits = torch.randn((tokens, E), device=gen.device, generator=gen)
    return torch.topk(logits, k, dim=-1).indices.reshape(-1).to(torch.int32)


#: K6's routings and their slot counts: the router's top-8 of 8 tokens (path
#: B), every slot on one expert, 8 experts of 8 slots, every slot on its own
#: expert, and the router's top-8 of 15 tokens (the most slots the gathered
#: path reaches at E 128)
SLOT_ROUTINGS = {"router": 64, "one_expert": 64, "eight_by_eight": 64, "all_distinct": 64,
                 "router_s120": 120}


def slot_ids(gen, routing: str, S: int, E: int = 128) -> torch.Tensor:
    """S slot expert ids under one of ``SLOT_ROUTINGS`` (or ``random``:
    uniform draws); a group's slots lie scattered in slot order."""
    dev = gen.device
    if routing.startswith("router"):
        return routed_ids(gen, S // 8, E)
    if routing == "random":
        return torch.randint(0, E, (S,), device=dev, generator=gen, dtype=torch.int32)
    experts = torch.randperm(E, device=dev, generator=gen)
    if routing == "one_expert":
        ids = experts[:1].repeat(S)
    elif routing == "eight_by_eight":
        ids = experts[:S // 8].repeat_interleave(8)[torch.randperm(S, device=dev, generator=gen)]
    elif routing == "all_distinct":
        ids = experts[:S]
    else:
        raise ValueError(f"unknown routing {routing}")
    return ids.to(torch.int32)


def check_slot(gen, payload: str, timed: bool, routing: str = "router") -> dict:
    """K6 (packed w4, packed E2M1, int8-doubled E2M1) or K7 (``w8pc``) at
    the Qwen3-30B-A3B decode shape, its slots routed as ``routing`` says
    (``SLOT_ROUTINGS``; the router: 8 tokens x top-8 = 64 slots). Timed:
    the device times of the kernel and of the yardstick, and at the router
    routing the launch-to-launch and plain times too."""
    from quantizers_tpu_torch.models.moe import _slot_dequant
    from quantizers_tpu_torch.ops import kernels as K

    E, D, Fe = 128, 2048, 768
    dev = gen.device
    if payload == "w8pc":
        name, wrapper, plain = "moe_slot_gu_ffn", K.moe_slot_gu_ffn, K.moe_slot_gu_ffn_plain
        stacks = w8pc_stacks(gen, E, D, Fe)
    else:
        name, wrapper, plain = "moe_slot_ffn", K.moe_slot_ffn, K.moe_slot_ffn_plain
        stacks = moe_stacks(gen, payload, E, D, Fe)
    idx = slot_ids(gen, routing, SLOT_ROUTINGS[routing], E)
    S = idx.numel()
    x = torch.randn((S, D), device=dev, generator=gen).bfloat16()
    label = f"{payload} {routing}"
    got = wrapper(x, idx, *stacks)
    err, tol = row_check(name, got, plain(x, idx, *stacks), label)
    check(torch.equal(wrapper(x, idx, *stacks), got), f"{name} {label}: differs from run to run")
    distinct = int(torch.unique(idx).numel())
    row = {"routing": routing, "S": S, "D": D, "F": Fe, "E": E, "distinct_experts": distinct,
           "max_abs_err": err, "tol": tol}
    if not timed:
        return row
    per_expert = tensor_bytes(list(stacks)) / E
    copies = rotating([stacks, tuple(dataclasses.replace(el, weight=el.weight.clone(),
                                                         scale=el.scale.clone())
                                     for el in stacks)])
    before = wrapper.launches
    prof = device_profile(lambda: [wrapper(x, idx, *copies()) for _ in range(20)], 20)
    row["dev_ms"] = prof["device_busy_ms_per_step"]
    # each launched kernel's device time, largest first (gate|up, then down)
    row["dev_kernels_ms"] = [t["ms_per_step"] for t in prof["top"]]
    if routing == "router":
        row["ms"] = cuda_ms(lambda: wrapper(x, idx, *copies()))
        row["plain_ms"] = cuda_ms(lambda: plain(x, idx, *copies()), iters=3, warmup=1)
    wrapper.launches = before
    # the yardstick: two torch.bmm calls on experts gathered and dequantized
    # to bf16 beforehand (no single PyTorch call computes the slot FFN)
    if payload == "w8pc":
        gu_b = _slot_dequant(stacks[0], idx)
    else:
        gu_b = torch.cat([_slot_dequant(stacks[0], idx), _slot_dequant(stacks[1], idx)], dim=-1)
    dn_b = _slot_dequant(stacks[-1], idx)

    def library():
        guv = torch.bmm(x[:, None, :], gu_b)[:, 0]
        a = (F.silu(guv[:, :Fe].float()) * guv[:, Fe:].float()).bfloat16()
        return torch.bmm(a[:, None, :], dn_b)[:, 0]

    if routing == "router":
        row["library_ms"] = cuda_ms(library)
    row["library_dev_ms"] = device_ms(library)
    row["library"] = "two torch.bmm on pre-gathered bf16 experts"
    del gu_b, dn_b
    nbytes = S * D * 2 + S * 4 + distinct * per_expert + S * D * 4
    row.update(bound(nbytes, 2 * S * 3 * D * Fe))
    return row


def slice2_kernels(gen, detail) -> dict:
    """K3 with f32 scales (the w8pc experts at m 32 and 128), K5a/K5b at the
    four Qwen3-4B decode shapes (m 8) and the expert shapes (m 128), K6 in
    its three payloads and K7."""
    D, Fq, Q, KVD = 2560, 9728, 4096, 1024
    decode_shapes = {"qkv": (D, Q + 2 * KVD), "o_proj": (Q, D), "gate_up": (D, 2 * Fq),
                     "down": (Fq, D)}
    expert_shapes = {"expert_gate": (2048, 768), "expert_down": (768, 2048)}
    rows = {"nvfp4_matmul": {}, "nvfp4_i8_matmul": {}, "w8_matmul_f32": {}}
    for layout, key in (("packed", "nvfp4_matmul"), ("int8", "nvfp4_i8_matmul")):
        for label, (k, n) in decode_shapes.items():
            rows[key][f"{label}@m8"] = check_nvfp4(gen, k, n, 8, layout, timed=True)
        for label, (k, n) in expert_shapes.items():
            # the row prefills of paths B (packed) and C (int8) run these
            rows[key][f"{label}@m128"] = check_nvfp4(gen, k, n, 128, layout, timed=True)
        for label, r in rows[key].items():
            log(f"[kernels] {key} {label}: {r}")
    rows["w8_matmul_f32"] = w8_experts(gen)
    # K6: the router's routing under the payload's name (the kernels line's
    # row), the others beside it
    rows["moe_slot_ffn"] = {
        p if r == "router" else f"{p}@{r}": check_slot(gen, p, timed=True, routing=r)
        for r in SLOT_ROUTINGS for p in ("packed", "int8", "w4")}
    # K7 the same way: its router row is the kernels line's
    rows["moe_slot_gu_ffn"] = {
        "w8pc" if r == "router" else f"w8pc@{r}": check_slot(gen, "w8pc", timed=True, routing=r)
        for r in SLOT_ROUTINGS}
    for key in ("moe_slot_ffn", "moe_slot_gu_ffn"):
        for label, r in rows[key].items():
            log(f"[kernels] {key} {label}: {r}")
    detail["kernels"].update(rows)
    return rows


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view at element offset 3 of a flat
    buffer: a base that is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 3, dtype=t.dtype, device=t.device)
    view = buf[3:].view(t.shape)
    view.copy_(t)
    return view


def offset_views(gen, detail) -> dict:
    """Phase 3's last part: each wrapper that aligns its inputs by copying
    them (the matmuls through ``_flatten_x``, K4 through ``_kernel_view``,
    K2's and K8's q and new rows, K6's and K7's x), called once with every
    input at an unaligned base, must give the aligned call's bits; K2 and K8
    refuse an unaligned cache with a ValueError before they launch."""
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.ops.flash import flash_attention

    dev = gen.device
    rows = {}

    def same(name, got, want, inputs):
        check(all(t.data_ptr() % 16 for t in inputs), f"{name}: the offset view is aligned")
        ok = bool(torch.equal(got, want))
        check(ok, f"{name}: a call on offset views differs from the aligned call")
        rows[name] = {"offset_bytes": [t.data_ptr() % 16 for t in inputs], "equal": ok}

    matmuls = {"w4_matmul": (K.w4_matmul, w4_linear(gen, 2560, 6144, GROUP, random_scale=True)),
               "w8_matmul": (K.w8_matmul, w8_linear(gen, 2560, 6144)),
               "nvfp4_matmul": (K.nvfp4_matmul, nvfp4_linear(gen, 2560, 6144)),
               "nvfp4_i8_matmul": (K.nvfp4_i8_matmul, nvfp4_linear(gen, 2560, 6144, "int8")),
               "fp8_matmul": (K.fp8_matmul, fp8_linear(gen, 2048, 3072))}
    for name, (wrapper, lin) in matmuls.items():
        x = torch.randn((8, lin.in_features), device=dev, generator=gen).bfloat16()
        xo = offset_view(x)
        same(name, wrapper(xo, lin), wrapper(x, lin), [xo])

    stacks = moe_stacks(gen, "packed", 128, 2048, 768)
    idx = routed_ids(gen)
    x = torch.randn((idx.numel(), 2048), device=dev, generator=gen).bfloat16()
    xo = offset_view(x)
    same("moe_slot_ffn", K.moe_slot_ffn(xo, idx, *stacks), K.moe_slot_ffn(x, idx, *stacks), [xo])
    stacks = w8pc_stacks(gen, 128, 2048, 768)
    same("moe_slot_gu_ffn", K.moe_slot_gu_ffn(xo, idx, *stacks),
         K.moe_slot_gu_ffn(x, idx, *stacks), [xo])
    del stacks

    q, k, v = (torch.randn((1, 8, 256, 128), device=dev, generator=gen).bfloat16()
               for _ in range(3))
    qkv = [offset_view(t) for t in (q, k, v)]
    same("flash_attention", flash_attention(*qkv, 0.0884), flash_attention(q, k, v, 0.0884), qkv)

    B, H, r, dp, S = BATCH, MLA_GEOMETRY["num_heads"], MLA_GEOMETRY["kv_lora_rank"], 128, MAX_LEN
    ins = [torch.randn(shape, device=dev, generator=gen).bfloat16()
           for shape in ((B, H, r), (B, H, dp), (B, r), (B, dp))]
    cc = torch.randn((B, 1, S, r), device=dev, generator=gen).bfloat16()
    cp = torch.randn((B, 1, S, dp), device=dev, generator=gen).bfloat16()
    lengths = torch.full((B,), 192, dtype=torch.int32, device=dev)
    offs = [offset_view(t) for t in ins]
    same("mla_decode_attention",
         K.mla_decode_attention(*offs, cc.clone(), cp.clone(), lengths, 0.0722),
         K.mla_decode_attention(*ins, cc.clone(), cp.clone(), lengths, 0.0722), offs)
    q = torch.randn((B, 4, 8, 128), device=dev, generator=gen).bfloat16()
    nk, nv = (torch.randn((B, 4, 128), device=dev, generator=gen).bfloat16() for _ in range(2))
    ck, cv = (torch.randn((B, 4, S, 128), device=dev, generator=gen).bfloat16()
              for _ in range(2))
    offs = [offset_view(t) for t in (q, nk, nv)]
    same("decode_attention",
         K.decode_attention(*offs, ck.clone(), cv.clone(), lengths, 0.0884),
         K.decode_attention(q, nk, nv, ck.clone(), cv.clone(), lengths, 0.0884), offs)
    refusals = [("decode_attention", K.decode_attention, which,
                 lambda kc, vc: K.decode_attention(q, nk, nv, kc, vc, lengths, 0.0884),
                 {"cache_k": ck, "cache_v": cv}) for which in ("cache_k", "cache_v")]
    refusals += [("mla_decode_attention", K.mla_decode_attention, which,
                  lambda c_, p_: K.mla_decode_attention(*ins, c_, p_, lengths, 0.0722),
                  {"cache_c": cc, "cache_p": cp}) for which in ("cache_c", "cache_p")]
    for name, wrapper, which, call, pair in refusals:
        caches = {key: t.clone() for key, t in pair.items()}
        caches[which] = offset_view(caches[which])
        before = wrapper.launches
        try:
            call(*caches.values())
            refused = False
        except ValueError as e:
            refused = which in str(e)
        check(refused and wrapper.launches == before,
              f"{name}: an unaligned {which} was not refused by a ValueError")
        rows[f"{name} {which}"] = {"refused": refused}
    torch.cuda.synchronize()
    for name, row in rows.items():
        log(f"[kernels] offset view {name}: {row}")
    detail["offset_views"] = rows
    return rows


def build_moe_params(spec, gen, payload: str = "packed"):
    """Synthetic Qwen3-30B-A3B params as benchmarks/bench_moe.py builds them,
    on the card: random E2M1 expert codes with constant 0.01 scales, unit-scale
    embeddings, o_proj and down damped by 1e-3 (so that the residual stream
    does not collapse across rows and the routing stays diverse); attention
    bf16 and an f32 router, as in recipe_moe_rtn_nvfp4."""
    from quantizers_tpu_torch.ops.linear import QuantLinear

    dev = gen.device
    D, E, Fe, hd = spec.hidden_size, spec.num_experts, spec.moe_intermediate_size, spec.head_dim

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    def dense(k, n, std=0.02, dtype=torch.bfloat16):
        w = (torch.randn((k, n), device=dev, generator=gen) * std).to(dtype)
        return QuantLinear(kind="dense", weight=w, meta=(("k", k), ("n", n)))

    layers = []
    for _ in range(spec.num_layers):
        g, u, d = moe_stacks(gen, payload, E, D, Fe, damp=1e-3)
        layers.append({
            "input_layernorm": ones(D), "post_attention_layernorm": ones(D),
            "q_proj": dense(D, spec.q_dim), "k_proj": dense(D, spec.kv_dim),
            "v_proj": dense(D, spec.kv_dim), "o_proj": dense(spec.q_dim, D, 0.02e-3),
            "q_norm": ones(hd), "k_norm": ones(hd),
            "moe": {"router": dense(D, E, dtype=torch.float32),
                    "gate_proj": g, "up_proj": u, "down_proj": d}})
    embed = torch.randn((spec.vocab_size, D), device=dev, generator=gen).bfloat16()
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": None}


class RouteRecorder:
    """Records every router decision of ``moe_forward`` while active: the
    top-k ids, and the k-th and (k+1)-th softmax probabilities. Given the
    ``calls`` of another run, it makes each decision take that run's ids
    instead (the combine weights still come from this run's router
    probabilities), after recording its own choice."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from quantizers_tpu_torch.models import moe as M

        self.M, self.orig, self.calls = M, M.route_topk_sparse, []

        def rec(logits, top_k, norm_topk_prob, **kw):
            topi, topv = self.orig(logits, top_k, norm_topk_prob, **kw)
            probs = torch.softmax(logits.float(), dim=-1)
            pk = probs.topk(top_k + 1, dim=-1).values
            self.calls.append((topi.cpu(), pk[:, -2].cpu(), pk[:, -1].cpu()))
            if self.replay is not None:  # the softmax router of qwen3_moe
                topi = self.replay[len(self.calls) - 1][0].to(logits.device)
                topv = torch.gather(probs, -1, topi.long())
                if norm_topk_prob:
                    topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-20)
                topv = topv * kw.get("routed_scaling_factor", 1.0)
            return topi, topv
        M.route_topk_sparse = rec
        return self

    def __exit__(self, *exc):
        self.M.route_topk_sparse = self.orig
        return False


@torch.no_grad()
def forced_decode(params, spec, caches, first, forced):
    """Decode steps fed a teacher-forced token stream (as bench_moe.py: a
    random model under argmax repeats one token, and its rows route alike);
    the argmax stays in each step through a dead data dependency."""
    from quantizers_tpu_torch.models import forward

    tok = first
    for ft in forced:
        logits, caches = forward(params, spec, tok[:, None], caches=caches)
        tok = ft + torch.argmax(logits[:, 0], dim=-1).clamp(max=0)
    return tok


def moe_step_bytes(spec, params, distinct: float, steps: int) -> dict:
    """Bytes one decode step must read: the attention weights, norms and
    router of every layer, ``distinct`` experts per layer (w8pc as served;
    the packed NVFP4 expert size beside it), the head, B embedding rows, and
    the KV cache's valid prefix averaged over ``steps`` steps."""
    layers = params["layers"]
    E, D, Fe = spec.num_experts, spec.hidden_size, spec.moe_intermediate_size
    dense = sum(tensor_bytes({k: v for k, v in lyr.items() if k != "moe"})
                + tensor_bytes(lyr["moe"]["router"]) for lyr in layers)
    moe0 = layers[0]["moe"]
    w8pc_expert = tensor_bytes([moe0["gate_up_proj"], moe0["down_proj"]]) / E
    packed_expert = 3 * (D * Fe // 2 + (D // NVFP4_G) * Fe * 2)
    head = tensor_bytes(params["lm_head"]) + tensor_bytes(params["final_norm"])
    row_kv = spec.num_layers * BATCH * spec.num_kv_heads * spec.head_dim * 2 * 2
    kv = row_kv * sum(PREFILL + i + 1 for i in range(steps)) / steps
    base = dense + head + BATCH * D * 2 + kv
    L = spec.num_layers
    return {"dense_and_head": dense + head, "kv_valid": kv, "w8pc_expert": w8pc_expert,
            "packed_expert": packed_expert, "distinct_per_layer": distinct,
            "w8pc_total": base + L * distinct * w8pc_expert,
            "packed_total": base + L * distinct * packed_expert}


def serve_moe_phase(gen, detail):
    """Path A: Qwen3-30B-A3B, 48 layers, NVFP4 experts served as w8pc."""
    from quantizers_tpu_torch.models import KVCache, ModelSpec
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    spec = ModelSpec(**MOE_GEOMETRY)
    dev = gen.device
    L = spec.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # no reference to the packed params outlives this call: serving_layout
    # frees each layer's packed experts once they are requantized
    params = serving_layout(spec, build_moe_params(spec, gen), head_bits=8, device=dev)
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    log(f"[moe] params + serving_layout(head_bits=8): {t_layout:.1f} s; peak "
        f"{peak / 1e9:.2f} GB, resident {resident / 1e9:.2f} GB")
    E, D, Fe = spec.num_experts, spec.hidden_size, spec.moe_intermediate_size
    for lyr in params["layers"]:
        m = lyr["moe"]
        check(sorted(m) == ["down_proj", "gate_up_proj", "router"]
              and m["gate_up_proj"].weight.shape == (E, D, 2 * Fe)
              and m["gate_up_proj"].scale.dtype == torch.float32
              and m["down_proj"].weight.dtype == torch.int8, "path A: w8pc expert layout")
    check(params["lm_head"].kind == "w8" and "qkv_proj" in params["layers"][0], "head, fused qkv")
    ids = ((torch.arange(BATCH * PREFILL, device=dev).reshape(BATCH, PREFILL) * 97 + 1)
           % spec.vocab_size)

    # warm-up (allocator, cuBLAS): not counted
    wc = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    last, wc = prefill(params, spec, ids, wc)
    _decode_scan(params, spec, wc, last.argmax(-1), None, steps=2, temperature=0.0, top_k=0)
    del wc

    # the main path, with every launch count set to 0 just before it
    caches = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = prefill(params, spec, ids, caches)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = K.launch_counts()
    first = last.argmax(-1)
    caches0 = [c.clone() for c in caches]
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, first, None, steps=MOE_STEPS,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"[moe] prefill {BATCH}x{PREFILL}: {t_prefill:.3f} s; launches {after_prefill}")
    log(f"[moe] greedy decode {MOE_STEPS} steps: {t_greedy:.3f} s; launches {counts}")
    check(not any(after_prefill.values()),
          f"path A prefill at m={BATCH * PREFILL} must launch no kernel: {after_prefill}")
    want = expect(moe_slot_gu_ffn=L * MOE_STEPS, decode_attention=L * MOE_STEPS,
                  w8_matmul=MOE_STEPS)
    check(counts == want, f"path A decode launch counts {counts} != {want}")
    check(toks.shape == (BATCH, MOE_STEPS) and bool(((toks >= 0) & (toks < spec.vocab_size)).all()),
          "path A: decoded ids out of range")

    # teacher-forced timed decode from the prefilled state
    forced = torch.randint(0, spec.vocab_size, (MOE_TIMED_STEPS, BATCH),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    with RouteRecorder() as rec:
        forced_decode(params, spec, [c.clone() for c in caches0], first, forced[:4])
    distinct = [int(torch.unique(topi).numel()) for topi, _, _ in rec.calls]
    d_mean = sum(distinct) / len(distinct)
    forced_decode(params, spec, [c.clone() for c in caches0], first, forced[:2])  # warm
    c = [cc.clone() for cc in caches0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forced_decode(params, spec, c, first, forced)
    torch.cuda.synchronize()
    t_forced = (time.perf_counter() - t0) / MOE_TIMED_STEPS
    del c
    sb = moe_step_bytes(spec, params, d_mean, MOE_TIMED_STEPS)
    bound_w8pc = sb["w8pc_total"] / HBM_BYTES_PER_S
    bound_packed = sb["packed_total"] / HBM_BYTES_PER_S
    prof = device_profile(lambda: forced_decode(params, spec, [cc.clone() for cc in caches0],
                                                first, forced[:8]), 8)
    res = {"layers": L, "layout": "w8pc", "serving_layout_s": t_layout,
           "peak_memory_gb": peak / 1e9, "resident_gb": resident / 1e9,
           "prefill_ms": t_prefill * 1e3, "greedy_ms_per_step": t_greedy / MOE_STEPS * 1e3,
           "ms_per_step": t_forced * 1e3, "tok_s": BATCH / t_forced,
           "distinct_experts_per_layer": {"mean": d_mean, "min": min(distinct),
                                          "max": max(distinct)},
           "bytes_per_step": sb, "bound_ms_w8pc": bound_w8pc * 1e3,
           "bound_ms_packed": bound_packed * 1e3, "frac_of_bound_w8pc": bound_w8pc / t_forced,
           "frac_of_bound_packed": bound_packed / t_forced, "profile": prof}
    detail["serve_moe"] = res
    log(f"[moe] forced decode: {res['ms_per_step']:.2f} ms/step, {res['tok_s']:.1f} tok/s; "
        f"distinct experts/layer {d_mean:.1f} ({min(distinct)}-{max(distinct)}); bytes bound "
        f"{res['bound_ms_w8pc']:.3f} ms (w8pc) / {res['bound_ms_packed']:.3f} ms (packed): "
        f"{res['frac_of_bound_w8pc']:.4f} / {res['frac_of_bound_packed']:.4f}")
    log(f"[moe] profile: {json.dumps(prof)}")
    del caches, caches0
    return spec, params, counts


def moe_batcher_phase(spec, params, gen, detail):
    """Path A through ``ContinuousBatcher``: a dozen mixed-length requests
    on the served params (their layout is kept as it is). Each row prefill
    (a 32- or 128-token bucket) loops over the experts through the w8
    kernel; each decode step runs the slot kernel."""
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import ContinuousBatcher

    rng = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    s = ContinuousBatcher(spec, params, max_batch=BATCH, max_len=MAX_LEN, device=gen.device)
    reqs = {}
    for _ in range(12):
        T = int(torch.randint(5, 121, (1,), generator=rng))
        n = int(torch.randint(8, 17, (1,), generator=rng))
        prompt = torch.randint(1, spec.vocab_size, (T,), generator=rng).tolist()
        reqs[s.submit(prompt, n)] = n
    K.reset_launch_counts()
    res = s.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    check(sorted(res) == sorted(reqs), "path A batcher: not every request finished")
    for rid, n in reqs.items():
        check(len(res[rid]) == n, f"path A batcher: request {rid} has {len(res[rid])} != {n} tokens")
        check(all(0 <= t < spec.vocab_size for t in res[rid]), "path A batcher: id out of range")
    L, E = spec.num_layers, spec.num_experts
    steps = counts["decode_attention"] // L
    # each row prefill: 2 w8 calls per expert and layer, plus the head
    want = expect(decode_attention=L * steps, moe_slot_gu_ffn=L * steps,
                  w8_matmul=len(reqs) * (2 * E * L + 1) + steps)
    check(steps > 0 and counts == want, f"path A batcher launches {counts} != {want}")
    detail["batcher_moe"] = {"requests": len(reqs), "tokens": sum(reqs.values()),
                             "decode_steps": steps, "seconds": dt, "launches": counts}
    log(f"[moe batcher] {detail['batcher_moe']}")


def build_nvfp4_dense(spec, gen):
    """Qwen3-4B with every projection NVFP4 (recipe_dense_nvfp4): random E2M1
    codes with scales in [0.004, 0.012]."""
    dev = gen.device
    D, Ff = spec.hidden_size, spec.intermediate_size

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    layers = [{"input_layernorm": ones(D), "post_attention_layernorm": ones(D),
               "q_proj": nvfp4_linear(gen, D, spec.q_dim),
               "k_proj": nvfp4_linear(gen, D, spec.kv_dim),
               "v_proj": nvfp4_linear(gen, D, spec.kv_dim),
               "o_proj": nvfp4_linear(gen, spec.q_dim, D),
               "q_norm": ones(spec.head_dim), "k_norm": ones(spec.head_dim),
               "mlp": {"gate_proj": nvfp4_linear(gen, D, Ff), "up_proj": nvfp4_linear(gen, D, Ff),
                       "down_proj": nvfp4_linear(gen, Ff, D)}}
              for _ in range(spec.num_layers)]
    embed = (torch.randn((spec.vocab_size, D), device=dev, generator=gen) * 0.02).bfloat16()
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": None}


def drive_side_path(label, spec, params, per_step: dict, row_prefill: dict = None) -> dict:
    """Prefill 8 x 128 (no kernel), SIDE_STEPS greedy steps with exact
    launch counts, and optionally a 1 x 128 row prefill (the batcher's)."""
    from quantizers_tpu_torch.models import KVCache
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import prefill
    from quantizers_tpu_torch.serve.engine import _decode_scan

    dev = params["embed"].device
    ids = ((torch.arange(BATCH * PREFILL, device=dev).reshape(BATCH, PREFILL) * 89 + 3)
           % spec.vocab_size)
    caches = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    K.reset_launch_counts()
    last, caches = prefill(params, spec, ids, caches)
    check(not any(K.launch_counts().values()), f"{label}: prefill launched a kernel")
    _decode_scan(params, spec, caches, last.argmax(-1), None, steps=1, temperature=0.0, top_k=0)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, last.argmax(-1), None, steps=SIDE_STEPS,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SIDE_STEPS
    counts = K.launch_counts()
    want = expect(**{k: v * SIDE_STEPS for k, v in per_step.items()})
    check(counts == want, f"{label}: decode launch counts {counts} != {want}")
    check(bool(((toks >= 0) & (toks < spec.vocab_size)).all()), f"{label}: ids out of range")
    row = {"layers": spec.num_layers, "steps": SIDE_STEPS, "ms_per_step": dt * 1e3,
           "launches_per_step": {k: v // SIDE_STEPS for k, v in counts.items() if v}}
    prof = device_profile(lambda: _decode_scan(params, spec, caches, toks[:, -1], None,
                                               steps=SIDE_STEPS, temperature=0.0, top_k=0),
                          SIDE_STEPS)
    row.update({k: prof[k] for k in ("device_busy_ms_per_step", "idle_share")})
    if row_prefill is not None:
        rc = KVCache.init(spec, 1, MAX_LEN, device=dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prefill(params, spec, ids[:1], rc)
        torch.cuda.synchronize()
        row["row_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        got = K.launch_counts()
        check(got == expect(**row_prefill), f"{label}: row prefill launches {got} != {row_prefill}")
        row["row_prefill_launches"] = {k: v for k, v in got.items() if v}
    log(f"[side] {label}: {row}")
    return row


def side_paths_phase(gen, detail) -> dict:
    """Paths B (packed and int8 experts, Qwen3-30B-A3B width) and C (dense
    NVFP4 Qwen3-4B, int8 and packed layouts), SIDE_LAYERS layers each."""
    from quantizers_tpu_torch.models import ModelSpec
    from quantizers_tpu_torch.serve import serving_layout

    dev = gen.device
    rows = {}
    spec = ModelSpec(**dict(MOE_GEOMETRY, num_layers=SIDE_LAYERS))
    L, E = SIDE_LAYERS, spec.num_experts
    for layout, k5 in (("packed", "nvfp4_matmul"), ("int8", "nvfp4_i8_matmul")):
        params = serving_layout(spec, build_moe_params(spec, gen), head_bits=8, device=dev,
                                moe_layout=layout)
        gate = params["layers"][0]["moe"]["gate_proj"]
        check(gate.kind == "nvfp4" and gate.weight.dtype == (torch.uint8 if layout == "packed"
                                                             else torch.int8),
              f"path B {layout}: expert layout")
        rows[f"B_{layout}"] = drive_side_path(
            f"path B {layout}", spec, params,
            {"moe_slot_ffn": L, "decode_attention": L, "w8_matmul": 1},
            row_prefill={k5: 3 * E * L, "w8_matmul": 1})
        del params
    spec_c = ModelSpec(**dict(GEOMETRY, num_layers=SIDE_LAYERS))
    for layout, k5 in ((None, "nvfp4_i8_matmul"), ("packed", "nvfp4_matmul")):
        params = serving_layout(spec_c, build_nvfp4_dense(spec_c, gen), head_bits=8, device=dev,
                                nvfp4_layout=layout)
        qkv = params["layers"][0]["qkv_proj"]
        check(qkv.kind == "nvfp4" and qkv.weight.dtype == (torch.uint8 if layout == "packed"
                                                           else torch.int8),
              f"path C {layout or 'default'}: layout")
        rows[f"C_{layout or 'default_int8'}"] = drive_side_path(
            f"path C {layout or 'default (int8)'}", spec_c, params,
            {k5: 4 * L, "decode_attention": L, "w8_matmul": 1})
        del params
    detail["side_paths"] = rows
    return rows


def card_vs_cpu_moe(detail, devices=("cuda", "cpu")):
    """Path A at 2 layers, full width, through the same converted weights
    and the same (w8pc) layout on both devices: prefill 2 x 16 (the loop
    over every expert), then 15 teacher-forced decode steps (the slot path).
    The CPU runs first. Each of the card's router decisions is compared
    with the CPU's: a token whose top-k differs must be a near-tie on the
    CPU. The card then takes the CPU's choice, so that the logits compare
    the same function at every position."""
    from quantizers_tpu_torch.convert import params_from_numpy
    from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
    from quantizers_tpu_torch.serve import serving_layout

    spec = ModelSpec(**dict(MOE_GEOMETRY, num_layers=2))
    rng = np.random.default_rng(4321)
    D, E, Fe = spec.hidden_size, spec.num_experts, spec.moe_intermediate_size

    def dense(kk, n, std=0.02):
        return {"kind": "dense", "weight": (rng.standard_normal((kk, n)) * std).astype(np.float32),
                "meta": (("k", kk), ("n", n))}

    def stack(kk, n):
        return {"kind": "nvfp4", "weight": rng.integers(0, 256, (E, kk // 2, n), dtype=np.uint8),
                "scale": rng.uniform(0.005, 0.015, (E, kk // NVFP4_G, n)).astype(np.float32),
                "meta": (("k", kk), ("n", n), ("group_size", NVFP4_G))}

    ones = lambda n: np.ones((n,), np.float32)  # noqa: E731
    tree = {"embed": rng.standard_normal((spec.vocab_size, D), dtype=np.float32),
            "layers": [{"input_layernorm": ones(D), "post_attention_layernorm": ones(D),
                        "q_proj": dense(D, spec.q_dim), "k_proj": dense(D, spec.kv_dim),
                        "v_proj": dense(D, spec.kv_dim), "o_proj": dense(spec.q_dim, D),
                        "q_norm": ones(spec.head_dim), "k_norm": ones(spec.head_dim),
                        "moe": {"router": dense(D, E), "gate_proj": stack(D, Fe),
                                "up_proj": stack(D, Fe), "down_proj": stack(Fe, D)}}
                       for _ in range(spec.num_layers)],
            "final_norm": ones(D), "lm_head": None}

    def as_bf16(p):
        # numpy has no bf16: attention, norms, embedding and scales cross as
        # f32; the router stays f32
        for layer in p["layers"]:
            for key, v in list(layer.items()):
                if isinstance(v, torch.Tensor):
                    layer[key] = v.bfloat16()
                elif key.endswith("_proj"):
                    v.weight = v.weight.bfloat16()
            for key in ("gate_proj", "up_proj", "down_proj"):
                layer["moe"][key].scale = layer["moe"][key].scale.bfloat16()
        p["embed"], p["final_norm"] = p["embed"].bfloat16(), p["final_norm"].bfloat16()
        return p

    B, T, n_dec = 2, 16, 16
    ids = rng.integers(1, spec.vocab_size, (B, T + n_dec))
    out, routes = {}, {}
    for dev in reversed(devices):  # the reference first: the card replays its routes
        t0 = time.perf_counter()
        p = serving_layout(spec, as_bf16(params_from_numpy(tree, device=dev)), head_bits=8,
                           device=dev)
        check("gate_up_proj" in p["layers"][0]["moe"], f"card vs CPU: w8pc layout on {dev}")
        caches = KVCache.init(spec, B, 64, device=dev)
        logits = []
        with torch.no_grad(), RouteRecorder(routes.get(devices[1])) as rec:
            lg, caches = forward(p, spec, torch.as_tensor(ids[:, :T], device=dev), caches=caches)
            logits.append(lg[:, -1].float().cpu())
            for t in range(T, T + n_dec - 1):
                lg, caches = forward(p, spec, torch.as_tensor(ids[:, t:t + 1], device=dev),
                                     caches=caches)
                logits.append(lg[:, -1].float().cpu())
        out[dev], routes[dev] = torch.stack(logits, 1), rec.calls
        log(f"[card-vs-cpu moe] {dev}: {time.perf_counter() - t0:.1f} s")
        del p, caches
    got, ref = (out[d] for d in devices)
    rgot, rref = (routes[d] for d in devices)
    check(len(rgot) == len(rref) == spec.num_layers * n_dec, "card vs CPU moe: router calls")
    flips = near = 0
    for c, ((ti, _, _), (ri, pk, pk1)) in enumerate(zip(rgot, rref)):
        step = c // spec.num_layers  # 0: prefill (B x T tokens), then one token per step
        for n in range(ri.shape[0]):
            b, t = (n // T, n % T) if step == 0 else (n, T + step - 1)
            tie = bool(pk[n] - pk1[n] <= ROUTE_GAP_RTOL * pk[n])
            near += int(tie)
            if set(ti[n].tolist()) != set(ri[n].tolist()):
                flips += 1
                check(tie, f"card vs CPU moe: router choice differs at row {b} position {t} "
                           f"(call {c}), where the CPU's gap {float(pk[n] - pk1[n]):.3g} is no "
                           f"near-tie")
    detail["card_vs_cpu_moe"] = {
        "layers": spec.num_layers, "prefill": [B, T], "decode_steps": n_dec - 1,
        "router_decisions": sum(x[0].shape[0] for x in rref), "router_flips": flips,
        "router_near_ties": near, "router_gap_rtol": ROUTE_GAP_RTOL,
        **logits_agree("card-vs-cpu moe", got, ref)}


# ---------------------------------------------------------------------------
# slice 3: flash attention (phase 3's third part) and path D, checkpoints in
# and perplexity out (phases 9-11)
# ---------------------------------------------------------------------------

#: (B, H, KV, T, d, dv, causal): the perplexity path's shape and the MLA
#: prefill's padded qk head (both timed), a single ragged tile, Qwen3-30B-A3B's
#: heads (rep 8), a non-causal call, less than one 128-row block, a T ragged
#: over eight blocks (which the JAX package's 256-row blocks refuse: the
#: kernel is called through its C entry) and d 256 over several key tiles
FLASH_SHAPES = {"path_D": (4, 32, 8, 2048, 128, 128, True),
                "ragged_T200": (1, 32, 8, 200, 128, 128, True),
                "rep8": (2, 32, 4, 512, 128, 128, True),
                "non_causal": (1, 8, 8, 256, 128, 128, False),
                "mla_d256": (1, 16, 16, 512, 256, 128, True),
                "T64": (1, 8, 8, 64, 128, 128, True),
                "ragged_T1000": (1, 16, 4, 1000, 128, 128, True),
                "d256_T1024": (2, 16, 16, 1024, 256, 128, True)}
FLASH_TIMED = ("path_D", "mla_d256")
#: path D's eval: windows of 2048 at stride 1024 (later windows score their
#: last 1024 tokens only), 4 windows a batch, 8 windows: two (4, 2048) batches
EVAL_ARGS = ["--window", "2048", "--stride", "1024", "--batch-size", "4", "--max-windows", "8"]
#: card against CPU, path D, per-token NLL: a token's NLL is the difference of
#: the logsumexp of its logits and its target logit, each within the logit
#: error of LOGIT_RTOL (2e-2 of the largest |logit|, 2.5 bf16 ulps there) of
#: the CPU's; so |err| <= 2e-2 * max(1, |NLL|)
NLL_RTOL = 2e-2
#: and the perplexity, exp of the mean NLL: the per-token errors, of either
#: sign, average out to well under the per-token limit; 1e-2 relative
PPL_RTOL = 1e-2


def flash_c_entry(q, k, v, sm: float, causal: bool):
    """K4 through its C entry, as the wrapper launches it but without the
    JAX package's block conditions (``flash_reason``): the kernel takes any
    T and S. Adds nothing to the wrapper's launch count."""
    from quantizers_tpu_torch.ops import _build
    from quantizers_tpu_torch.ops._launch import _stream
    from quantizers_tpu_torch.ops.flash import _kernel_view

    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    B, H, T, d = q.shape
    KV, S, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, T, H, dv), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    err = _build.load().qtt_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            out.data_ptr(), *strides, B, H, KV, T, S, d, dv,
                                            float(sm), int(causal), _stream(q.device))
    _build.check(err, "flash_attention")
    return out


def check_flash(gen, label, shape, timed: bool) -> dict:
    """K4 against its plain version at one shape, with q as the transformer
    passes it (a transpose(1, 2) view); each (b, h, t) row is held to RTOL
    of its own largest |value|. A shape that the JAX package's blocks refuse
    goes to the kernel's C entry and to the plain version over one block."""
    from quantizers_tpu_torch.ops import flash as FL

    B, H, KV, T, d, dv, causal = shape
    dev = gen.device

    def inputs():
        q = torch.randn((B, T, H, d), device=dev, generator=gen).bfloat16().transpose(1, 2)
        k = torch.randn((B, KV, T, d), device=dev, generator=gen).bfloat16()
        v = torch.randn((B, KV, T, dv), device=dev, generator=gen).bfloat16()
        return q, k, v

    q, k, v = inputs()
    sm = 1.0 / math.sqrt(d)
    blocks = {}
    kernel = FL.flash_attention
    if FL.flash_reason(q, k, v) is not None:
        blocks, kernel = {"block_q": T, "block_k": T}, flash_c_entry
    got = kernel(q, k, v, sm, causal)
    ref = FL.flash_attention_plain(q, k, v, sm, causal, **blocks)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash_attention {label}: non-finite output")
    errs = (got.float() - ref.float()).abs().amax(dim=3)
    tols = RTOL["flash_attention"] * ref.float().abs().amax(dim=3)
    ratio = errs / tols
    b, h, t = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
    err, tol = errs[b, h, t].item(), tols[b, h, t].item()
    check(bool((ratio <= 1).all()),
          f"flash_attention {label}: b={b} h={h} t={t}: max |err| {err:.4g} > tol {tol:.4g}")
    check(torch.equal(kernel(q, k, v, sm, causal), got),
          f"flash_attention {label}: differs from run to run")
    row = {"shape": dict(zip(("B", "H", "KV", "T", "d", "dv", "causal"), shape)),
           "max_abs_err": err, "tol": tol, "worst_row": [int(b), int(h), int(t)],
           "worst_ratio": ratio.max().item(), "largest_abs_err": errs.max().item()}
    if not timed:
        return row
    src = rotating([(q, k, v), inputs()])  # path D: 2 x 168 MB, past the 50 MB L2

    def library():
        return F.scaled_dot_product_attention(*src(), is_causal=causal, scale=sm, enable_gqa=True)

    before = FL.flash_attention.launches
    row["ms"] = cuda_ms(lambda: kernel(*src(), sm, causal))
    # launch to launch includes the wrapper's host path; the profiler's
    # device time is the kernel's own
    row["dev_ms"] = device_ms(lambda: kernel(*src(), sm, causal))
    FL.flash_attention.launches = before  # timing launches are not main-path launches
    row["plain_ms"] = cuda_ms(lambda: FL.flash_attention_plain(*src(), sm, causal, **blocks),
                              iters=3, warmup=1)
    row["library_ms"] = cuda_ms(library)
    row["library_dev_ms"] = device_ms(library)
    row["library"] = "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True)"
    pairs = T * (T + 1) // 2 if causal else T * T  # the (row, key) pairs this data needs
    nbytes = 2 * (B * H * T * d + B * KV * T * (d + dv) + B * H * T * dv)
    row.update(bound(nbytes, 2 * B * H * pairs * (d + dv)))
    return row


def flash_kernels(gen, detail) -> dict:
    rows = {label: check_flash(gen, label, shape, timed=label in FLASH_TIMED)
            for label, shape in FLASH_SHAPES.items()}
    for label, r in rows.items():
        log(f"[kernels] flash_attention {label}: {r}")
    detail["kernels"]["flash_attention"] = rows
    return rows


def write_checkpoint(spec, gen, out_dir) -> dict:
    """A W4A16 g32 checkpoint of random weights (bf16, std 0.02, from the
    seeded generator on the card) quantized by the port's
    ``core.numerics.quantize`` and written by its ``save_compressed_model``."""
    from quantizers_tpu_torch.core import PRESET_SCHEMES, quantize
    from quantizers_tpu_torch.formats import CompressedParam, save_compressed_model

    dev = gen.device
    D, Ff, hd = spec.hidden_size, spec.intermediate_size, spec.head_dim
    scheme = PRESET_SCHEMES["W4A16_G32"]
    t0 = time.perf_counter()
    plain = {"model.embed_tokens.weight":
             (torch.randn((spec.vocab_size, D), device=dev, generator=gen) * 0.02).bfloat16(),
             "model.norm.weight": torch.ones((D,), dtype=torch.bfloat16, device=dev)}
    quant = {}
    shapes = {"self_attn.q_proj": (spec.q_dim, D), "self_attn.k_proj": (spec.kv_dim, D),
              "self_attn.v_proj": (spec.kv_dim, D), "self_attn.o_proj": (D, spec.q_dim),
              "mlp.gate_proj": (Ff, D), "mlp.up_proj": (Ff, D), "mlp.down_proj": (D, Ff)}
    for i in range(spec.num_layers):
        p = f"model.layers.{i}"
        for name, n in (("input_layernorm", D), ("post_attention_layernorm", D),
                        ("self_attn.q_norm", hd), ("self_attn.k_norm", hd)):
            plain[f"{p}.{name}.weight"] = torch.ones((n,), dtype=torch.bfloat16, device=dev)
        for name, shape in shapes.items():
            w = (torch.randn(shape, device=dev, generator=gen) * 0.02).bfloat16()
            quant[f"{p}.{name}"] = CompressedParam(quantize(w, scheme.weights), scheme.weights)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_compressed_model(out_dir, plain, quant, {"group_0": scheme}, ["lm_head"],
                          base_config=spec.to_hf_config())
    t_write = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(out_dir).iterdir())
    return {"layers": spec.num_layers, "quantize_s": t_quant, "write_s": t_write,
            "bytes": nbytes, "dir": str(out_dir)}


def synthetic_text(n_chars: int = 12_000, seed: int = 5) -> str:
    """Seeded words of lowercase letters; the byte tokenizer makes one token
    of each character."""
    rng = np.random.default_rng(seed)
    words = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append("".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(1, 9))))
    return " ".join(words)[:n_chars]


class Records(logging.Handler):
    """The log records of one logger while active (the CLIs log their load
    and run times there)."""

    def __init__(self, name: str):
        super().__init__()
        self.logger, self.records = logging.getLogger(name), []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        return False

    def args(self, prefix: str):
        return next(r.args for r in self.records if r.msg.startswith(prefix))


def run_cli(main_fn, argv, logger_name: str):
    """A CLI's ``main`` in-process: (exit code, stdout, log records)."""
    out = io.StringIO()
    with Records(logger_name) as rec, contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, out.getvalue(), rec


def eval_phase(gen, detail, tmp: Path):
    """Path D (the main path of slice 3): write the full-depth checkpoint,
    then ``cli/eval_ppl.main`` on the card over two (4, 2048) batches, every
    launch count set to 0 just before it."""
    from quantizers_tpu_torch.cli import eval_ppl
    from quantizers_tpu_torch.models import ModelSpec
    from quantizers_tpu_torch.ops import kernels as K

    spec = ModelSpec(**GEOMETRY)
    ckpt = tmp / "qwen3_4b_w4a16"
    info = write_checkpoint(spec, gen, ckpt)
    log(f"[path D] checkpoint: {info}")
    text = tmp / "text.txt"
    text.write_text(synthetic_text())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    rc, out, rec = run_cli(eval_ppl.main, [str(ckpt), str(text), *EVAL_ARGS],
                           "quantizers_tpu_torch.eval_ppl")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[path D] eval_ppl: {out.strip()}; launches {counts}")
    m = re.search(r"^ppl=(\S+) tokens=(\d+) windows=(\d+) eval_s=", out, re.M)
    check(rc == 0 and m is not None, f"path D: eval_ppl printed no result line: {out!r}")
    ppl, n_tok, n_win = float(m.group(1)), int(m.group(2)), int(m.group(3))
    check(math.isfinite(ppl) and ppl > 1.0, f"path D: perplexity {ppl} is not finite")
    # the CLI counts each window's mask, its unscored first position included
    check(n_win == 8 and n_tok == 2048 + 7 * 1024, f"path D: {n_win} windows, {n_tok} tokens")
    want = expect(flash_attention=spec.num_layers * 2)
    check(counts == want, f"path D: eval launch counts {counts} != {want}")
    load_s = rec.args("loaded")[1]
    eval_s = rec.args("scored")[2]
    # where one batch's time goes: a profiled (4, 2048) scoring call, after
    # the counted run
    from quantizers_tpu_torch.models import load_compressed_model
    from quantizers_tpu_torch.serve.engine import token_logprobs

    _, params = load_compressed_model(ckpt)
    ids = torch.randint(0, spec.vocab_size, (4, 2048), device=gen.device, generator=gen)
    token_logprobs(params, spec, ids)  # warm
    prof = device_profile(lambda: token_logprobs(params, spec, ids), 1)
    del params
    res = {"checkpoint": info, "tmp_dir": str(tmp), "ppl": ppl, "tokens": n_tok,
           "windows": n_win, "load_s": load_s, "eval_s": eval_s, "tok_s": n_tok / eval_s,
           "peak_memory_gb": peak / 1e9, "launches": counts, "profile_one_batch": prof}
    detail["path_D"] = res
    log(f"[path D] {res}")
    return spec, ckpt, text, counts


def serve_cli_phase(ckpt, text, detail):
    """``cli/serve.main`` on path D's checkpoint: 8 prompts through the
    continuous batcher with the int8 head. Row prefills and decode steps run
    K1 (w4) and K2; the head K3; prefills with a cache take the einsum
    attention, as in the JAX package, so K4 never launches."""
    from quantizers_tpu_torch.cli import serve
    from quantizers_tpu_torch.ops import kernels as K

    words = text.read_text().split()
    argv = [str(ckpt), "--max-new-tokens", "32", "--max-batch", "8", "--max-len", "512",
            "--head-bits", "8"]
    for i in range(8):
        argv += ["--prompt", " ".join(words[i * 7: i * 7 + 3 + 4 * i])]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out, rec = run_cli(serve.main, argv, "quantizers_tpu_torch.serve")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    rids = re.findall(r"^(\d+)\t", out, re.M)
    log(f"[path D serve] {len(rids)} lines; launches {counts}")
    check(rc == 0 and rids == [str(i) for i in range(8)],
          f"path D serve: want one line per prompt, got rids {rids}")
    served = ("w4_matmul", "decode_attention", "w8_matmul")
    check(all(counts[k] > 0 for k in served) and counts == expect(**{k: counts[k] for k in served}),
          f"path D serve: K1, K2 and K3 must launch, and nothing else: {counts}")
    n_tok, gen_s = rec.args("generated")[0], rec.args("generated")[2]
    detail["path_D_serve"] = {"prompts": 8, "tokens": n_tok, "load_s": rec.args("loaded")[1],
                              "generate_s": gen_s, "total_s": dt, "launches": counts}
    log(f"[path D serve] {detail['path_D_serve']}")


def card_vs_cpu_ppl(gen, detail, tmp: Path, text: Path, devices=("cuda", "cpu")):
    """Path D at 2 layers, full width: one checkpoint, loaded on the card
    and on the CPU, one (1, 512) window scored on each (the card's flash and
    w4 kernels against the CPU's plain versions): per-token NLL and
    perplexity."""
    from quantizers_tpu_torch.data import ByteTokenizer
    from quantizers_tpu_torch.models import ModelSpec, load_compressed_model
    from quantizers_tpu_torch.serve import perplexity
    from quantizers_tpu_torch.serve.engine import token_logprobs

    spec = ModelSpec(**dict(GEOMETRY, num_layers=2))
    ckpt = tmp / "qwen3_4b_w4a16_2layers"
    write_checkpoint(spec, gen, ckpt)
    ids = np.asarray(ByteTokenizer()(text.read_text())["input_ids"][:512], np.int32)[None]
    batch = [(ids, np.ones(ids.shape, np.float32))]
    nll, ppl = {}, {}
    for dev in devices:
        t0 = time.perf_counter()
        _, params = load_compressed_model(ckpt, device=dev)
        nll[dev] = -token_logprobs(params, spec, torch.as_tensor(ids, device=dev).long()).cpu()
        ppl[dev] = perplexity(spec, params, batch, device=dev)
        log(f"[card-vs-cpu path D] {dev}: {time.perf_counter() - t0:.1f} s")
        del params
    got, ref = (nll[d] for d in devices)
    check(bool(torch.isfinite(got).all()), "card vs CPU path D: NLL not finite")
    ratio = ((got - ref).abs() / (NLL_RTOL * ref.abs().clamp(min=1.0))).max().item()
    ppl_err = abs(ppl[devices[0]] - ppl[devices[1]]) / ppl[devices[1]]
    detail["card_vs_cpu_ppl"] = {
        "layers": 2, "window": list(ids.shape), "max_abs_nll_err": (got - ref).abs().max().item(),
        "mean_nll": ref.mean().item(), "worst_err_over_tol": ratio, "nll_rtol": NLL_RTOL,
        "ppl": {d: ppl[d] for d in devices}, "ppl_rel_err": ppl_err, "ppl_rtol": PPL_RTOL}
    log(f"[card-vs-cpu path D] {detail['card_vs_cpu_ppl']}")
    check(ratio <= 1, f"card vs CPU path D: per-token NLL error {ratio:.3g} x its limit")
    check(ppl_err <= PPL_RTOL, f"card vs CPU path D: perplexity {ppl} differ by {ppl_err:.3g}")


# ---------------------------------------------------------------------------
# slice 5: FP8_BLOCK MLA serving, path E (phase 3's fourth part, phases 12-14)
# ---------------------------------------------------------------------------

#: DeepSeek-V2-Lite attention (16 heads, kv_lora_rank 512, nope 128 / rope
#: 64 / v 128, no q LoRA, vocab 102400) with the dense 8192-wide MLP of the
#: JAX package's benchmarks/bench_fp8.py:93-135, tied embeddings, all 27
#: layers (the bench cut them to 12 for a 16 GB chip)
MLA_GEOMETRY = dict(vocab_size=102400, hidden_size=2048, num_layers=27, num_heads=16,
                    num_kv_heads=16, head_dim=128, intermediate_size=8192, qk_norm=False,
                    tie_word_embeddings=True, q_lora_rank=0, kv_lora_rank=512,
                    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
                    model_type="deepseek_v3")
#: bench_fp8.py:79: batch 8, a 128-token prefill, 128 greedy steps, 512 slots
MLA_STEPS = 128
#: the FP8_BLOCK linears of configs/recipes/recipe_fp8_block_mla.yaml (its
#: ignore list keeps kv_a_proj_with_mqa bf16)
FP8_ATTN, FP8_MLP = ("q_proj", "kv_b_proj", "o_proj"), ("gate_proj", "up_proj", "down_proj")
#: (K, N) of the four fp8 calls of a path-E decoder layer at decode
FP8_SHAPES = {"q_proj": (2048, 3072), "o_proj": (2048, 2048), "gate_up": (2048, 16384),
              "down": (8192, 2048)}
#: fill lengths of the MLA decode check: empty, the path's mean and full
#: (both timed)
MLA_FILLS = (0, 192, MAX_LEN - 1)
MLA_TIMED = (192, MAX_LEN - 1)
#: one batch of rows at different fills: empty, the first chunk's last
#: position, the second's first, the ends and starts of shares of an 8-rank
#: split (L 31 and 32: shares of 16; 127, 128: 16 and 32), full
MLA_MIXED = (0, 15, 16, 31, 32, 127, 128, MAX_LEN - 1)


def fp8_linear(gen, k: int, n: int, std: float = 0.02):
    """A random bf16 (N, K) weight (std ``std``, from the seeded generator)
    quantized to FP8_BLOCK 128 x 128 by the port's ``core.numerics``."""
    from quantizers_tpu_torch.core import PRESET_SCHEMES, quantize
    from quantizers_tpu_torch.ops.linear import from_quantized

    args = PRESET_SCHEMES["FP8_BLOCK"].weights
    w = (torch.randn((n, k), device=gen.device, generator=gen) * std).bfloat16()
    return from_quantized(quantize(w, args), args)


def check_fp8(gen, k: int, n: int, m: int, timed: bool) -> dict:
    """K9 against its plain version: 1e-2 of the plain output's largest
    |value|, the same bits from a second call."""
    from quantizers_tpu_torch.ops import kernels as K

    lin = fp8_linear(gen, k, n)
    x = torch.randn((m, k), device=gen.device, generator=gen).bfloat16()
    label = f"{m}x{k}x{n}"
    got = K.fp8_matmul(x, lin)
    ref = K.fp8_matmul_plain(x, lin.weight, lin.scale)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = RTOL["fp8_matmul"] * ref.float().abs().max().item()
    check(bool(torch.isfinite(got).all()), f"fp8_matmul {label}: non-finite output")
    check(err <= tol, f"fp8_matmul {label}: max |err| {err:.4g} > tol {tol:.4g}")
    check(torch.equal(K.fp8_matmul(x, lin), got), f"fp8_matmul {label}: differs from run to run")
    row = {"m": m, "k": k, "n": n, "max_abs_err": err, "tol": tol}
    if not timed:
        return row
    return time_matmul(K.fp8_matmul, lambda x, c: K.fp8_matmul_plain(x, c.weight, c.scale),
                       x, lin, row)


def sdpa_backends(*args, **kw) -> list:
    """The scaled_dot_product_attention backends that take these inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ok = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                F.scaled_dot_product_attention(*args, **kw)
            ok.append(b.name)
        except RuntimeError:
            pass
    return ok


def check_mla_decode(gen, fill, timed: bool) -> dict:
    """K8 at the path-E shape (B 8, H 16, r 512, rope 64 padded to 128,
    S 512), every row at fill length ``fill`` (or row b at ``fill[b]``),
    stale rows past it NaN: each (row, head) held to 2e-2 of its own
    largest |value|, the written rows and the untouched ones exactly."""
    from quantizers_tpu_torch.ops import kernels as K

    B, H, S = BATCH, MLA_GEOMETRY["num_heads"], MAX_LEN
    r, dr, dp = MLA_GEOMETRY["kv_lora_rank"], MLA_GEOMETRY["qk_rope_head_dim"], 128
    dev = gen.device
    fills = [fill] * B if isinstance(fill, int) else list(fill)

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen).bfloat16()

    q_abs, new_c = rnd(B, H, r), rnd(B, r)
    q_pe, new_p = F.pad(rnd(B, H, dr), (0, dp - dr)), F.pad(rnd(B, dr), (0, dp - dr))
    cc, cp = rnd(B, 1, S, r), F.pad(rnd(B, 1, S, dr), (0, dp - dr))
    lengths = torch.tensor(fills, dtype=torch.int32, device=dev)
    stale = (torch.arange(S, device=dev)[None, :] > lengths[:, None])[:, None, :, None]
    cc, cp = cc.masked_fill(stale, float("nan")), cp.masked_fill(stale, float("nan"))
    sm = 1.0 / math.sqrt(MLA_GEOMETRY["qk_nope_head_dim"] + dr)
    c1, p1, c2, p2 = cc.clone(), cp.clone(), cc.clone(), cp.clone()
    got = K.mla_decode_attention(q_abs, q_pe, new_c, new_p, c1, p1, lengths, sm)
    ref = K.mla_decode_attention_plain(q_abs, q_pe, new_c, new_p, c2, p2, lengths, sm)
    torch.cuda.synchronize()
    label = f"L={fill}" if isinstance(fill, int) else "L=" + ",".join(map(str, fills))
    check(bool(torch.isfinite(got).all()), f"mla_decode_attention {label}: non-finite output")
    errs = (got.float() - ref.float()).abs().amax(dim=2)
    tols = RTOL["mla_decode_attention"] * ref.float().abs().amax(dim=2)
    ratio = errs / tols
    b, h = divmod(int(ratio.argmax()), H)
    err, tol = errs[b, h].item(), tols[b, h].item()
    check(bool((ratio <= 1).all()),
          f"mla_decode_attention {label}: b={b} h={h}: max |err| {err:.4g} > tol {tol:.4g}")
    same = lambda a, b: bool(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))  # noqa: E731
    check(same(c1, c2) and same(p1, p2), f"mla_decode_attention {label}: cache rows differ")
    rows = torch.arange(B, device=dev)
    written = torch.zeros_like(stale)
    written[rows, 0, lengths.long()] = True
    check(torch.equal(c1[rows, 0, lengths.long()], new_c)
          and torch.equal(p1[rows, 0, lengths.long()], new_p)
          and same(c1.masked_fill(written, 0.0), cc.masked_fill(written, 0.0))
          and same(p1.masked_fill(written, 0.0), cp.masked_fill(written, 0.0)),
          f"mla_decode_attention {label}: the new row is not at L alone")
    check(torch.equal(K.mla_decode_attention(q_abs, q_pe, new_c, new_p, cc.clone(), cp.clone(),
                                             lengths, sm), got),
          f"mla_decode_attention {label}: differs from run to run")
    row = {"B": B, "H": H, "r": r, "rope_pad": dp, "S": S, "L": fill, "max_abs_err": err,
           "tol": tol, "worst_at": f"b={b} h={h}", "worst_ratio": ratio.max().item()}
    if not timed:
        return row
    L = fills[0]
    check(fills == [L] * B, "mla_decode_attention: a timed check takes one fill for every row")
    cc, cp = cc.nan_to_num(0.0), cp.nan_to_num(0.0)
    cache_bytes = (cc.numel() + cp.numel()) * 2
    caches = rotating([(cc, cp)] + [(cc.clone(), cp.clone())
                                    for _ in range(copies_for(cache_bytes) - 1)])

    def kern():
        a, b = caches()
        return K.mla_decode_attention(q_abs, q_pe, new_c, new_p, a, b, lengths, sm)

    def plain():
        a, b = caches()
        return K.mla_decode_attention_plain(q_abs, q_pe, new_c, new_p, a, b, lengths, sm)

    # the yardstick: one SDPA call, q = [q_abs | q_pe], k = [C | P], v = C
    qcat = torch.cat([q_abs, q_pe], dim=-1)[:, :, None, :]
    kv = rotating([(torch.cat([a, b], dim=-1), a) for a, b in
                   (caches() for _ in range(copies_for(cache_bytes)))])
    mask = (torch.arange(S, device=dev) <= L)[None, None, None, :].expand(B, 1, 1, S)

    def library():
        k, v = kv()
        return F.scaled_dot_product_attention(qcat, k, v, attn_mask=mask, scale=sm,
                                              enable_gqa=True)

    before = K.mla_decode_attention.launches
    row["ms"] = cuda_ms(kern)
    row["dev_ms"] = device_ms(kern)
    K.mla_decode_attention.launches = before  # timing launches are not main-path launches
    row["plain_ms"] = cuda_ms(plain, iters=10)
    row["library_ms"] = cuda_ms(library)
    row["library_dev_ms"] = device_ms(library)
    row["library"] = ("scaled_dot_product_attention(enable_gqa=True), backends taking it: "
                      + ",".join(sdpa_backends(qcat, *kv(), attn_mask=mask, scale=sm,
                                               enable_gqa=True)))
    del kv
    width = r + dp
    nbytes = (q_abs.numel() + q_pe.numel()) * 2 + 2 * B * width * 2 + B * L * width * 2 \
        + got.numel() * 2  # queries, new rows in and written, the prefix read, ctx out
    row.update(bound(nbytes, 2 * B * H * (L + 1) * (width + r)))
    return row


def slice5_kernels(gen, detail) -> dict:
    """K9 at the four path-E decode shapes (m 8 timed, m 128 checked, and
    timed for gate|up), q_proj at the no-cache window's m 512 (timed) and a
    ragged shape; K8 at three fill lengths (L 192 and 511 timed) and one
    batch of mixed fills."""
    rows = {"fp8_matmul": {}, "mla_decode_attention": {}}
    for label, (k, n) in FP8_SHAPES.items():
        rows["fp8_matmul"][f"{label}@m8"] = check_fp8(gen, k, n, 8, timed=True)
        rows["fp8_matmul"][f"{label}@m128"] = check_fp8(gen, k, n, 128,
                                                        timed=label == "gate_up")
    rows["fp8_matmul"]["q_proj@m512"] = check_fp8(gen, *FP8_SHAPES["q_proj"], 512, timed=True)
    rows["fp8_matmul"]["ragged@m3"] = check_fp8(gen, 384, 256, 3, timed=False)
    for L in MLA_FILLS:
        rows["mla_decode_attention"][f"L{L}"] = check_mla_decode(gen, L, timed=L in MLA_TIMED)
    rows["mla_decode_attention"]["mixed"] = check_mla_decode(gen, MLA_MIXED, timed=False)
    for key in rows:
        for label, r in rows[key].items():
            log(f"[kernels] {key} {label}: {r}")
    detail["kernels"].update(rows)
    return rows


def build_fp8_mla_params(spec, gen):
    """Path E's params on the card, as the FP8_BLOCK MLA recipe makes them:
    random bf16 weights (std 0.02, the seeded generator) quantized to
    FP8_BLOCK for q_proj, kv_b_proj, o_proj and the MLP, kv_a_proj_with_mqa
    bf16, unit norms, a bf16 embedding of std 0.02 (tied)."""
    from quantizers_tpu_torch.ops.linear import dense_linear

    dev = gen.device
    D, Ff, H = spec.hidden_size, spec.intermediate_size, spec.num_heads
    r, dr = spec.kv_lora_rank, spec.qk_rope_head_dim

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    layers = []
    for _ in range(spec.num_layers):
        kva = (torch.randn((r + dr, D), device=dev, generator=gen) * 0.02).bfloat16()
        layers.append({
            "input_layernorm": ones(D), "post_attention_layernorm": ones(D),
            "q_proj": fp8_linear(gen, D, H * spec.qk_head_dim),
            "kv_a_proj_with_mqa": dense_linear(kva), "kv_a_layernorm": ones(r),
            "kv_b_proj": fp8_linear(gen, r, H * (spec.qk_nope_head_dim + spec.v_head_dim)),
            "o_proj": fp8_linear(gen, H * spec.v_head_dim, D),
            "mlp": {"gate_proj": fp8_linear(gen, D, Ff), "up_proj": fp8_linear(gen, D, Ff),
                    "down_proj": fp8_linear(gen, Ff, D)}})
    embed = (torch.randn((spec.vocab_size, D), device=dev, generator=gen) * 0.02).bfloat16()
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": None}


def mla_step_bytes(spec, params, steps: int) -> dict:
    """Bytes one path-E decode step must read: each layer's tensors but
    kv_b_proj (the absorbed weights stand in for it), the int8 head, B
    embedding rows, and the valid latent prefix (r + rope_pad per token)
    averaged over ``steps`` steps from the prefill."""
    layers = sum(tensor_bytes({k: v for k, v in lyr.items() if k != "kv_b_proj"})
                 for lyr in params["layers"])
    head = tensor_bytes(params["lm_head"]) + tensor_bytes(params["final_norm"])
    (_, r), (_, dp) = spec.kv_cache_dims()
    row = spec.num_layers * BATCH * (r + dp) * 2
    latent = row * sum(PREFILL + i + 1 for i in range(steps)) / steps
    total = layers + head + BATCH * spec.hidden_size * 2 + latent
    return {"layers": layers, "head": head, "latent_valid": latent, "total": total}


def serve_mla_phase(gen, detail):
    """Path E: FP8_BLOCK MLA at 27 layers, batch 8, 128 + 128 tokens."""
    from quantizers_tpu_torch.models import KVCache, ModelSpec
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    spec = ModelSpec(**MLA_GEOMETRY)
    dev = gen.device
    L = spec.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serving_layout(spec, build_fp8_mla_params(spec, gen), head_bits=8, device=dev)
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    peak, resident = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    log(f"[mla] params + serving_layout(head_bits=8): {t_layout:.1f} s; peak "
        f"{peak / 1e9:.2f} GB, resident {resident / 1e9:.2f} GB")
    lyr = params["layers"][0]
    check(all(lyr[k].kind == "fp8" for k in ("q_proj", "o_proj"))
          and lyr["mlp"]["gateup_proj"].kind == "fp8" and lyr["mlp"]["down_proj"].kind == "fp8"
          and lyr["kv_a_proj_with_mqa"].kind == "dense" and "mla_absorb" in lyr,
          "path E: resident fp8 layout with absorbed weights")
    head = params["lm_head"]
    check(head.kind == "w8" and head.meta_dict["orig_n"] == spec.vocab_size
          and head.out_features == 102912, "path E: int8 head padded to 102912")
    ids = ((torch.arange(BATCH * PREFILL, device=dev).reshape(BATCH, PREFILL) * 97 + 1)
           % spec.vocab_size)

    # warm-up (allocator, cuBLAS): not counted
    wc = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    last, wc = prefill(params, spec, ids, wc)
    _decode_scan(params, spec, wc, last.argmax(-1), None, steps=2, temperature=0.0, top_k=0)
    del wc

    # the main path, with every launch count set to 0 just before it
    caches = KVCache.init(spec, BATCH, MAX_LEN, device=dev)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = prefill(params, spec, ids, caches)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = K.launch_counts()
    first = last.argmax(-1)
    caches0 = [c.clone() for c in caches]
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, first, None, steps=MLA_STEPS,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"[mla] prefill {BATCH}x{PREFILL}: {t_prefill * 1e3:.1f} ms; launches {after_prefill}")
    log(f"[mla] decode {MLA_STEPS} steps: {t_decode:.3f} s; launches {counts}")
    check(bool(torch.isfinite(last).all()), "path E: prefill logits not finite")
    check(not any(after_prefill.values()),
          f"path E prefill at m={BATCH * PREFILL} must launch no kernel: {after_prefill}")
    want = expect(fp8_matmul=4 * L * MLA_STEPS, mla_decode_attention=L * MLA_STEPS,
                  w8_matmul=MLA_STEPS)
    check(counts == want, f"path E decode launch counts {counts} != {want}")
    check(toks.shape == (BATCH, MLA_STEPS) and bool(((toks >= 0) & (toks < spec.vocab_size)).all()),
          "path E: decoded ids out of range")
    check(all(int(c.length[0]) == PREFILL + MLA_STEPS for c in caches), "path E: cache lengths")

    _, t_decode2 = time_decode(spec, params, caches0, first, "path E", steps=MLA_STEPS)
    prof = profile_decode(spec, params, caches0, first)
    sb = mla_step_bytes(spec, params, MLA_STEPS)
    best = min(t_decode, t_decode2) / MLA_STEPS
    bound_s = sb["total"] / HBM_BYTES_PER_S
    res = {"layers": L, "serving_layout_s": t_layout, "peak_memory_gb": peak / 1e9,
           "resident_gb": resident / 1e9, "prefill_ms": t_prefill * 1e3,
           "decode_s": [t_decode, t_decode2], "ms_per_step": best * 1e3, "tok_s": BATCH / best,
           "bytes_per_step": sb, "bound_ms": bound_s * 1e3, "frac_of_bound": bound_s / best,
           "launches_per_step": {k: v // MLA_STEPS for k, v in counts.items() if v},
           "profile": prof}
    detail["serve_mla"] = res
    log(f"[mla] decode: {res['ms_per_step']:.2f} ms/step, {res['tok_s']:.1f} tok/s; bytes bound "
        f"{res['bound_ms']:.3f} ms: {res['frac_of_bound']:.4f}")
    log(f"[mla] profile: {json.dumps(prof)}")
    del caches, caches0
    return spec, params, counts


def mla_batcher_phase(spec, params, gen, detail):
    """Path E through ``ContinuousBatcher``: 12 mixed-length requests on the
    served params (their layout kept). Each row prefill (a 32- or 128-token
    bucket) runs K9 for the four fp8 calls of every layer and K3 for the
    head; each decode step K9, K8 and K3."""
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import ContinuousBatcher

    rng = torch.Generator().manual_seed(13)
    t0 = time.perf_counter()
    s = ContinuousBatcher(spec, params, max_batch=BATCH, max_len=MAX_LEN, device=gen.device)
    reqs = {}
    for _ in range(12):
        T = int(torch.randint(5, 121, (1,), generator=rng))
        n = int(torch.randint(8, 17, (1,), generator=rng))
        prompt = torch.randint(1, spec.vocab_size, (T,), generator=rng).tolist()
        reqs[s.submit(prompt, n)] = n
    K.reset_launch_counts()
    res = s.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    check(sorted(res) == sorted(reqs), "path E batcher: not every request finished")
    for rid, n in reqs.items():
        check(len(res[rid]) == n, f"path E batcher: request {rid} has {len(res[rid])} != {n} tokens")
        check(all(0 <= t < spec.vocab_size for t in res[rid]), "path E batcher: id out of range")
    L = spec.num_layers
    steps = counts["mla_decode_attention"] // L
    want = expect(fp8_matmul=4 * L * (len(reqs) + steps), mla_decode_attention=L * steps,
                  w8_matmul=len(reqs) + steps)
    check(steps > 0 and counts == want, f"path E batcher launches {counts} != {want}")
    detail["batcher_mla"] = {"requests": len(reqs), "tokens": sum(reqs.values()),
                             "decode_steps": steps, "seconds": dt, "launches": counts}
    log(f"[mla batcher] {detail['batcher_mla']}")


def card_vs_cpu_mla(detail, text: str, devices=("cuda", "cpu")):
    """Path E at 2 layers, full width: the same FP8_BLOCK weights (made and
    quantized on the CPU) laid out on each device. Prefill 2 x 16 plus 15
    teacher-forced steps with the bf16 latent cache (K9 and K8 on the card)
    and again with the fp8 cache (the plain attention path on both); then
    one no-cache perplexity call over a (1, 512) window (K9 at m 512 and K4
    at head dim 256 on the card)."""
    from quantizers_tpu_torch.data import ByteTokenizer
    from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import perplexity, serving_layout
    from quantizers_tpu_torch.serve.engine import token_logprobs

    spec = ModelSpec(**dict(MLA_GEOMETRY, num_layers=2))
    raw = build_fp8_mla_params(spec, torch.Generator().manual_seed(4242))
    B, T, n_dec = 2, 16, 16
    ids = np.random.default_rng(77).integers(1, spec.vocab_size, (B, T + n_dec))
    win = np.asarray(ByteTokenizer()(text)["input_ids"][:512], np.int32)[None]
    batch = [(win, np.ones(win.shape, np.float32))]
    L = spec.num_layers
    out = {}
    for dev in devices:
        t0 = time.perf_counter()
        p = serving_layout(spec, raw, head_bits=8, device=dev)
        res = {}
        for fp8 in (False, True):
            caches = KVCache.init(spec, B, 64, device=dev, fp8=fp8)
            K.reset_launch_counts()
            logits = []
            with torch.no_grad():
                lg, caches = forward(p, spec, torch.as_tensor(ids[:, :T], device=dev),
                                     caches=caches)
                logits.append(lg[:, -1].float().cpu())
                for t in range(T, T + n_dec - 1):
                    lg, caches = forward(p, spec, torch.as_tensor(ids[:, t:t + 1], device=dev),
                                         caches=caches)
                    logits.append(lg[:, -1].float().cpu())
            res[fp8] = (torch.stack(logits, 1), K.launch_counts())
        K.reset_launch_counts()
        ppl = perplexity(spec, p, batch, device=dev)
        ppl_counts = K.launch_counts()
        nll = -token_logprobs(p, spec, torch.as_tensor(win, device=dev).long()).cpu()
        out[dev] = (res, ppl, ppl_counts, nll)
        log(f"[card-vs-cpu mla] {dev}: {time.perf_counter() - t0:.1f} s")
        del p, caches
    (res, ppl_c, counts_ppl, nll_c), (ref, ppl_r, _, nll_r) = (out[d] for d in devices)
    steps = n_dec - 1
    want_bf16 = expect(fp8_matmul=4 * L * (1 + steps), mla_decode_attention=L * steps,
                       w8_matmul=1 + steps)
    want_fp8 = expect(fp8_matmul=4 * L * (1 + steps), w8_matmul=1 + steps)
    check(res[False][1] == want_bf16, f"card vs CPU mla: launches {res[False][1]} != {want_bf16}")
    check(res[True][1] == want_fp8, f"card vs CPU mla, fp8 KV: launches {res[True][1]} != {want_fp8}")
    want_ppl = expect(fp8_matmul=5 * L, flash_attention=L, w8_matmul=1)
    check(counts_ppl == want_ppl, f"card vs CPU mla, perplexity: launches {counts_ppl} != {want_ppl}")
    row = {"layers": L, "prefill": [B, T], "decode_steps": steps,
           "bf16_cache": logits_agree("card-vs-cpu mla", res[False][0], ref[False][0]),
           "fp8_cache": logits_agree("card-vs-cpu mla fp8 KV", res[True][0], ref[True][0])}
    check(bool(torch.isfinite(nll_c).all()), "card vs CPU mla: NLL not finite")
    ratio = ((nll_c - nll_r).abs() / (NLL_RTOL * nll_r.abs().clamp(min=1.0))).max().item()
    ppl_err = abs(ppl_c - ppl_r) / ppl_r
    row["perplexity"] = {"window": list(win.shape), "max_abs_nll_err": (nll_c - nll_r).abs().max().item(),
                         "mean_nll": nll_r.mean().item(), "worst_err_over_tol": ratio,
                         "ppl": {devices[0]: ppl_c, devices[1]: ppl_r}, "ppl_rel_err": ppl_err,
                         "launches": counts_ppl}
    detail["card_vs_cpu_mla"] = row
    log(f"[card-vs-cpu mla] perplexity {row['perplexity']}")
    check(ratio <= 1, f"card vs CPU mla: per-token NLL error {ratio:.3g} x its limit")
    check(ppl_err <= PPL_RTOL, f"card vs CPU mla: perplexity {ppl_c} vs {ppl_r}: {ppl_err:.3g}")


# ---------------------------------------------------------------------------

def main() -> int:
    # the port is imported inside the phases, so that a copy of this script
    # without the package beside it says so plainly
    if not (ROOT / "quantizers_tpu_torch" / "csrc").is_dir():
        log("chip_smoke: the quantizers_tpu_torch package is not beside this script")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false: this script needs a CUDA card")
        return 2
    t_start = time.perf_counter()

    # phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{name}, {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from quantizers_tpu_torch.ops import _build

    _build.load()
    log(f"[build] {'built' if _build.INFO.built else 'loaded'} {_build.INFO.path} "
        f"in {_build.INFO.seconds:.1f} s")
    for line in _build.INFO.log.splitlines():
        if any(key in line for key in ("entry function", "registers", "spill")) or \
                line.startswith("=="):
            log(f"[build] {line.strip()}")

    # phase 3: kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    detail = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": _build.INFO.seconds}
    # K1 at decode (m 8: the kernels line's layer sum) and at the batcher's
    # row prefills (m 32, 128)
    w4_rows = {f"{label}@m{m}": r for m in (8, 32, 128) for label, r in w4_layer(gen, m).items()}
    w8_rows = w8_heads(gen)
    attn = check_decode_attention(gen, timed=True)
    log(f"[kernels] decode_attention: {attn}")
    attn_a = check_decode_attention(gen, timed=True, shape="path_A")
    log(f"[kernels] decode_attention path_A: {attn_a}")
    detail["kernels"] = {"w4_matmul": w4_rows, "w8_matmul": w8_rows, "decode_attention": attn,
                         "decode_attention path_A": attn_a}
    s2 = slice2_kernels(gen, detail)
    fl = flash_kernels(gen, detail)
    s5 = slice5_kernels(gen, detail)
    offset_views(gen, detail)

    # phase 4: serve, slice 1
    spec, raw, counts = serve_phase(gen, detail)

    # phase 5: serve, slice 2, path A (the main path), and its batcher
    spec_moe, params_moe, counts_moe = serve_moe_phase(gen, detail)
    moe_batcher_phase(spec_moe, params_moe, gen, detail)
    del params_moe
    torch.cuda.empty_cache()

    # phase 6: paths B and C
    side = side_paths_phase(gen, detail)
    torch.cuda.empty_cache()

    # phase 7: card against CPU
    card_vs_cpu(detail)
    card_vs_cpu_moe(detail)

    # phase 8: batcher, slice 1
    batcher_phase(spec, raw, gen, detail)
    del raw
    torch.cuda.empty_cache()

    # phases 9-11: path D (slice 3's main path), its serve run, card against
    # CPU; the checkpoints live in a temporary directory, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        _, ckpt, text, counts_d = eval_phase(gen, detail, Path(tmp))
        serve_cli_phase(ckpt, text, detail)
        torch.cuda.empty_cache()
        card_vs_cpu_ppl(gen, detail, Path(tmp), text)

    # phases 12-14: path E (slice 5's main path), its batcher, card against CPU
    spec_e, params_e, counts_e = serve_mla_phase(gen, detail)
    mla_batcher_phase(spec_e, params_e, gen, detail)
    del params_e
    torch.cuda.empty_cache()
    card_vs_cpu_mla(detail, synthetic_text())

    # phase 15: the kernels line (w4, the NVFP4 and the fp8 matmuls: the four
    # calls of one decoder layer at m = 8, summed)
    def total(rows, key):
        return sum(r[key] for r in rows)

    def worst(rows):
        """max_abs_err and tol from the shape that came closest to its limit."""
        label, r = max(rows.items(), key=lambda kv: kv[1]["max_abs_err"] / kv[1]["tol"])
        return {"max_abs_err": r["max_abs_err"], "tol": r["tol"], "worst_at": label}

    def layer_sum(rows):
        """The timed m = 8 (one decoder layer's decode) shapes, summed."""
        timed = [r for label, r in rows.items() if "ms" in r and label.endswith("@m8")]
        return {key: total(timed, key) for key in ("ms", "dev_ms", "plain_ms", "bound_ms",
                                                   "library_ms", "library_dev_ms")}

    src = "quantizers_tpu_torch/csrc/"
    w8_all = dict(w8_rows, **s2["w8_matmul_f32"])
    kernels_line = [
        {"name": "w4_matmul", "route": "cuda", "source": src + "w4_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:159", "launches": counts["w4_matmul"],
         "path": "slice 1 decode", **worst(w4_rows), **layer_sum(w4_rows), "bound_by": "bytes"},
        {"name": "w8_matmul", "route": "cuda", "source": src + "w8_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:581", "launches": counts_moe["w8_matmul"],
         "path": "A decode", **worst(w8_all),
         **{key: w8_rows["head@m8"][key]
            for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "library_dev_ms")}},
        {"name": "decode_attention", "route": "cuda", "source": src + "decode_attention.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:768",
         "launches": counts_moe["decode_attention"], "path": "A decode",
         "max_abs_err": attn["max_abs_err"], "tol": attn["tol"],
         "worst_at": attn["worst_at"],
         **{key: attn[key] for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "library_dev_ms")}},
        {"name": "nvfp4_matmul", "route": "cuda", "source": src + "nvfp4_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:329",
         "launches": side["C_packed"]["launches_per_step"]["nvfp4_matmul"] * SIDE_STEPS,
         "path": "C packed decode", **worst(s2["nvfp4_matmul"]),
         **layer_sum(s2["nvfp4_matmul"]), "bound_by": "bytes"},
        {"name": "nvfp4_i8_matmul", "route": "cuda", "source": src + "nvfp4_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:385",
         "launches": side["C_default_int8"]["launches_per_step"]["nvfp4_i8_matmul"] * SIDE_STEPS,
         "path": "C default (int8) decode", **worst(s2["nvfp4_i8_matmul"]),
         **layer_sum(s2["nvfp4_i8_matmul"]), "bound_by": "bytes"},
        {"name": "moe_slot_ffn", "route": "cuda", "source": src + "moe_slot_ffn.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:1134",
         "launches": side["B_packed"]["launches_per_step"]["moe_slot_ffn"] * SIDE_STEPS,
         "path": "B packed decode",
         **worst(s2["moe_slot_ffn"]),
         **{key: s2["moe_slot_ffn"]["packed"][key]
            for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "library_dev_ms")}},
        {"name": "moe_slot_gu_ffn", "route": "cuda", "source": src + "moe_slot_gu_ffn.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:1304",
         "launches": counts_moe["moe_slot_gu_ffn"], "path": "A decode",
         **worst(s2["moe_slot_gu_ffn"]),
         **{key: s2["moe_slot_gu_ffn"]["w8pc"][key]
            for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "library_dev_ms")}},
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": "quantizers_tpu/ops/flash.py:86",
         "launches": counts_d["flash_attention"], "path": "D eval", **worst(fl),
         **{key: fl["path_D"][key]
            for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "library_dev_ms")}},
        {"name": "fp8_matmul", "route": "cuda", "source": src + "fp8_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:488", "launches": counts_e["fp8_matmul"],
         "path": "E decode", **worst(s5["fp8_matmul"]), **layer_sum(s5["fp8_matmul"]),
         "bound_by": "bytes"},
        {"name": "mla_decode_attention", "route": "cuda", "source": src + "mla_decode_attention.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:961",
         "launches": counts_e["mla_decode_attention"], "path": "E decode",
         **worst(s5["mla_decode_attention"]),
         **{key: s5["mla_decode_attention"]["L192"][key]
            for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "library_dev_ms")},
         **{f"{key}_L{MAX_LEN - 1}": s5["mla_decode_attention"][f"L{MAX_LEN - 1}"][key]
            for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "library_ms",
                        "library_dev_ms")}},
    ]
    check(all(k["launches"] > 0 for k in kernels_line), "a kernel never launched on its path")
    detail["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(json.dumps(detail, indent=1))
    log(f"[done] {detail['total_s']:.1f} s; serve {json.dumps(detail['serve'])}; "
        f"path A {json.dumps({k: v for k, v in detail['serve_moe'].items() if k != 'profile'})}; "
        f"path E {json.dumps({k: v for k, v in detail['serve_mla'].items() if k != 'profile'})}")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
