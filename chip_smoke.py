#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA kernels of ``quantizers_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, with timings beside the bound;
4. serve: a Qwen3-4B-shaped W4A16 model at full width and depth (random
   weights from a seeded generator), ``serving_layout(head_bits=8)``, an
   8 x 128 prefill and 256 greedy decode steps, with the kernels' launch
   counts checked; then the tied bf16 head layout;
5. card against CPU: a 2-layer full-width model through the same converted
   weights on both devices, prefill plus 16 teacher-forced decode steps;
6. batcher: 12 requests through ``ContinuousBatcher`` at full width;
7. one JSON line of per-kernel numbers, then the card's nvidia-smi line,
   then the final ``{"ok": true, ...}`` line.

Longer per-shape numbers go to ``chiprun_out/chip_smoke_detail.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
#: rounds once, from f32 sums taken in another order). Decode attention: a
#: fraction of each (row, KV head)'s own largest |value|, so that the long
#: rows, whose values are small, are held as closely as the short ones; the
#: kernel keeps its probabilities in f32 where the plain version rounds them
#: to bf16 (at most 2^-9 of each term), which with the output's rounding
#: stays under 1e-2, and the limit is twice that
RTOL = {"w4_matmul": 1e-2, "w8_matmul": 1e-2, "decode_attention": 2e-2}
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


def w8_linear(gen, k: int, n: int, g=None):
    from quantizers_tpu_torch.ops.linear import QuantLinear

    dev = gen.device
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
    rows = k // g if g else 1
    scale = (torch.rand((rows, n), device=dev, generator=gen) * 0.004 + 0.001).bfloat16()
    return QuantLinear(kind="w8", weight=w, scale=scale, meta=(("k", k), ("n", n), ("group_size", g)))


def matmul_bytes(lin, m: int) -> int:
    k, n = lin.in_features, lin.out_features
    payload = lin.weight.numel() * lin.weight.element_size()
    scales = lin.scale.numel() * lin.scale.element_size()
    return m * k * 2 + payload + scales + m * n * 2


def check_matmul(name, kernel, plain_fn, gen, k, n, m, g, timed: bool):
    lin = (w4_linear(gen, k, n, g, random_scale=True) if name == "w4_matmul"
           else w8_linear(gen, k, n, g))
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
    if not timed:
        return row
    nbytes = matmul_bytes(lin, m)
    copies = [lin] + [
        type(lin)(kind=lin.kind, weight=lin.weight.clone(), scale=lin.scale.clone(),
                  meta=lin.meta) for _ in range(copies_for(nbytes) - 1)]
    wsrc = rotating(copies)
    wdense = [c.dequantize(torch.bfloat16) for c in copies[:2]]
    dsrc = rotating(wdense)
    before = kernel.launches
    row["ms"] = cuda_ms(lambda: kernel(x, wsrc()))
    kernel.launches = before  # timing launches are not main-path launches
    row["plain_ms"] = cuda_ms(lambda: plain_fn(x, wsrc()), iters=5, warmup=1)
    row["library_ms"] = cuda_ms(lambda: torch.matmul(x, dsrc()))
    row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS) * 1e3
    row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= 2 * m * k * n / BF16_FLOPS else "operations"
    del wdense
    return row


def check_decode_attention(gen, timed: bool):
    from quantizers_tpu_torch.ops import kernels as K

    B, KV, rep, hd, S = BATCH, 8, 4, 128, MAX_LEN
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
    check(bool(torch.isfinite(got).all()), "decode_attention: non-finite output")
    # each (row, KV head) against its own largest |value|
    errs = (got.float() - ref.float()).abs().amax(dim=(2, 3))
    tols = RTOL["decode_attention"] * ref.float().abs().amax(dim=(2, 3))
    ratio = errs / tols
    b, h = divmod(int(ratio.argmax()), KV)
    err, tol = errs[b, h].item(), tols[b, h].item()
    worst = f"b={b} kv={h} L={int(lengths[b])}"
    check(bool((ratio <= 1).all()),
          f"decode_attention: {worst}: max |err| {err:.4g} > tol {tol:.4g}")
    same = lambda a, b: bool(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))  # noqa: E731
    check(same(k1, k2) and same(v1, v2), "decode_attention: cache rows written differ")
    L = lengths.clamp(max=S - 1).long()
    rows = torch.arange(B, device=dev)
    check(torch.equal(k1[rows, :, L], nk) and torch.equal(v1[rows, :, L], nv),
          "decode_attention: new row not at min(length, S-1)")
    row = {"B": B, "KV": KV, "rep": rep, "S": S, "lengths": lengths.tolist(),
           "max_abs_err": err, "tol": tol, "worst_at": worst,
           "max_err_per_row": errs.amax(1).tolist(), "tol_per_row": tols.amin(1).tolist()}
    if not timed:
        return row
    # timing at the serving path's mid-decode state: every row at L = 255
    Lt = torch.full((B,), 255, dtype=torch.int32, device=dev)
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

    mask = (pos <= 255)[:, None, None, :].expand(B, 1, 1, S)
    qh = q.reshape(B, KV * rep, 1, hd)

    def library():
        a, b = caches()
        return F.scaled_dot_product_attention(qh, a, b, attn_mask=mask, scale=sm,
                                              enable_gqa=True)

    before = K.decode_attention.launches
    row["ms"] = cuda_ms(kern)
    K.decode_attention.launches = before
    row["plain_ms"] = cuda_ms(plain, iters=10)
    row["library_ms"] = cuda_ms(library)
    n_pos = 256  # positions 0..255
    nbytes = (q.numel() * 2 * 2  # q in, ctx out
              + 2 * nk.numel() * 2  # new rows in
              + 2 * B * KV * 255 * hd * 2  # cached K and V read
              + 2 * nk.numel() * 2)  # new rows written
    flops = 4 * B * KV * rep * n_pos * hd
    row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations"
    row["timed_at"] = "L=255 all rows"
    return row


# ---------------------------------------------------------------------------
# phase 4: the served model
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
    from quantizers_tpu_torch.ops.linear import QuantLinear

    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, QuantLinear):
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


def time_decode(spec, params, caches0, first, label):
    from quantizers_tpu_torch.serve.engine import _decode_scan

    warm = [c.clone() for c in caches0]
    _decode_scan(params, spec, warm, first, None, steps=4, temperature=0.0, top_k=0)
    del warm
    caches = [c.clone() for c in caches0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, first, None, steps=STEPS,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[serve:{label}] {STEPS} steps x batch {BATCH}: {dt:.3f} s, "
        f"{dt / STEPS * 1e3:.3f} ms/step, {BATCH * STEPS / dt:.1f} tok/s")
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
    check(after_prefill == {"w4_matmul": 0, "w8_matmul": 0, "decode_attention": 0},
          f"prefill at m={BATCH * PREFILL} must launch no kernel: {after_prefill}")
    L = spec.num_layers
    want = {"w4_matmul": L * 4 * STEPS, "w8_matmul": STEPS, "decode_attention": L * STEPS}
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
# phase 5: card against CPU through the same converted weights
# ---------------------------------------------------------------------------

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
    check(bool(torch.isfinite(got).all()), "card logits not finite")
    err = (got - ref).abs().max().item()
    tol = LOGIT_RTOL * ref.abs().max().item()
    norm_err = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    # positions where the CPU's top two logits are a near-tie: the top one's
    # bf16 ulp is 2^(floor(log2 |top|) - 7)
    top2 = ref.topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[..., 0].abs())) - 7)
    tie = (top2[..., 0] - top2[..., 1]) <= TIE_ULPS * ulp
    agree = got.argmax(-1) == ref.argmax(-1)
    detail["card_vs_cpu"] = {
        "layers": 2, "prefill": [B, T], "decode_steps": n_dec - 1, "max_abs_err": err,
        "tol": tol, "max_abs_logit": ref.abs().max().item(), "max_rel_norm_err": norm_err,
        "rel_norm_tol": LOGIT_NORM_RTOL, "positions": agree.numel(),
        "argmax_agreement": agree.float().mean().item(), "near_ties": int(tie.sum())}
    log(f"[card-vs-cpu] {detail['card_vs_cpu']}")
    check(err <= tol, f"card vs CPU logits: max |err| {err:.4g} > tol {tol:.4g}")
    check(norm_err <= LOGIT_NORM_RTOL,
          f"card vs CPU logits: relative error norm {norm_err:.4g} > {LOGIT_NORM_RTOL}")
    check(bool((agree | tie).all()),
          f"card vs CPU: greedy token differs at {int((~agree & ~tie).sum())} positions "
          f"that are no near-tie")


# ---------------------------------------------------------------------------
# phase 6: the batcher
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
    check(all(v > 0 for v in counts.values()), f"batcher: a kernel never launched: {counts}")
    detail["batcher"] = {"requests": 12, "tokens": sum(reqs.values()), "seconds": dt,
                         "launches": counts}
    log(f"[batcher] {detail['batcher']}")


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
    from quantizers_tpu_torch.ops import kernels as K

    _build.load()
    log(f"[build] {'built' if _build.INFO.built else 'loaded'} {_build.INFO.path} "
        f"in {_build.INFO.seconds:.1f} s")
    for line in _build.INFO.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")

    # phase 3: kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    detail = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": _build.INFO.seconds}
    D, F, Q, KVD = 2560, 9728, 4096, 1024
    w4_shapes = {"qkv": (D, Q + 2 * KVD), "o_proj": (Q, D), "gate_up": (D, 2 * F), "down": (F, D)}
    w4_rows = {}
    plain4 = lambda x, lin: K.w4_matmul_plain(x, lin.weight, lin.scale, GROUP)  # noqa: E731
    plain8 = lambda x, lin: K.w8_matmul_plain(x, lin.weight, lin.scale,  # noqa: E731
                                              lin.meta_dict["group_size"])
    for label, (k, n) in w4_shapes.items():
        for m in (8, 32, 128):
            r = check_matmul("w4_matmul", K.w4_matmul, plain4, gen, k, n, m, GROUP, timed=m == 8)
            w4_rows[f"{label}@m{m}"] = r
            log(f"[kernels] w4 {label} m={m}: {r}")
    w8_rows = {"head@m8": check_matmul("w8_matmul", K.w8_matmul, plain8, gen, 2560, 152064, 8,
                                       None, timed=True),
               "group32@m8": check_matmul("w8_matmul", K.w8_matmul, plain8, gen, 2560, 6144, 8,
                                          32, timed=False)}
    for label, r in w8_rows.items():
        log(f"[kernels] w8 {label}: {r}")
    attn = check_decode_attention(gen, timed=True)
    log(f"[kernels] decode_attention: {attn}")
    detail["kernels"] = {"w4_matmul": w4_rows, "w8_matmul": w8_rows, "decode_attention": attn}

    # phase 4: serve
    spec, raw, counts = serve_phase(gen, detail)

    # phase 5: card against CPU
    card_vs_cpu(detail)

    # phase 6: batcher
    batcher_phase(spec, raw, gen, detail)
    del raw

    # phase 7: the kernels line (w4: the four calls of one decoder layer, summed)
    timed4 = [w4_rows[f"{lbl}@m8"] for lbl in w4_shapes]

    def total(rows, key):
        return sum(r[key] for r in rows)

    def worst(rows):
        """max_abs_err and tol from the shape that came closest to its limit."""
        label, r = max(rows.items(), key=lambda kv: kv[1]["max_abs_err"] / kv[1]["tol"])
        return {"max_abs_err": r["max_abs_err"], "tol": r["tol"], "worst_at": label}

    src = "quantizers_tpu_torch/csrc/"
    kernels_line = [
        {"name": "w4_matmul", "route": "cuda", "source": src + "w4_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:159", "launches": counts["w4_matmul"],
         **worst(w4_rows), "ms": total(timed4, "ms"), "plain_ms": total(timed4, "plain_ms"),
         "bound_ms": total(timed4, "bound_ms"), "bound_by": "bytes",
         "library_ms": total(timed4, "library_ms")},
        {"name": "w8_matmul", "route": "cuda", "source": src + "w8_matmul.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:581", "launches": counts["w8_matmul"],
         **worst(w8_rows), "ms": w8_rows["head@m8"]["ms"], "plain_ms": w8_rows["head@m8"]["plain_ms"],
         "bound_ms": w8_rows["head@m8"]["bound_ms"], "bound_by": w8_rows["head@m8"]["bound_by"],
         "library_ms": w8_rows["head@m8"]["library_ms"]},
        {"name": "decode_attention", "route": "cuda", "source": src + "decode_attention.cu",
         "replaces": "quantizers_tpu/ops/kernels.py:768", "launches": counts["decode_attention"],
         "max_abs_err": attn["max_abs_err"], "tol": attn["tol"],
         "worst_at": attn["worst_at"], "ms": attn["ms"],
         "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
         "bound_by": attn["bound_by"], "library_ms": attn["library_ms"]},
    ]
    detail["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(json.dumps(detail, indent=1))
    log(f"[done] {detail['total_s']:.1f} s; serve {json.dumps(detail['serve'])}")
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
