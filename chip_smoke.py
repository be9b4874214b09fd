#!/usr/bin/env python3
"""Drive the PyTorch port's serving, calibration and training paths on one
CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA kernels of ``quantizers_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and evaluation paths give it, with timings
   beside the bound (the fp8 matmul and MLA decode kernels at path E's,
   K10, the W8A8 linear with its per-token quantizer inside, at Qwen3-4B's
   projections, unfused and as path I serves them, with its edge rows, and
   its GEMM alone on int8 codes, bit for bit; GPTQ's column elimination K11 through whole
   solves at path J's shapes, bit for bit);
4. serve, slice 1: a Qwen3-4B-shaped W4A16 model at full width and
   SLICE1_LAYERS (18) of its 36 layers (random weights from a seeded
   generator), ``serving_layout(head_bits=8)``,
   an 8 x 128 prefill and 256 greedy decode steps, with the kernels'
   launch counts checked; then the tied bf16 head layout;
5. serve, slice 2, path A (the main path): Qwen3-30B-A3B at full width and
   all A_LAYERS (48) of its layers with NVFP4 experts and bf16 attention,
   laid out by
   ``serving_layout(head_bits=8)`` (w8pc experts on the card), an 8 x 128
   prefill, a greedy decode with exact per-step launch counts, a
   teacher-forced timed decode with the distinct experts per layer and the
   fraction of the bytes bound, and a profiled window; then 12 requests
   through ``ContinuousBatcher`` on the same params;
6. paths B and C at 8 layers: the packed and int8 expert layouts (slot
   kernel at decode, NVFP4 matmul in a row prefill) and dense NVFP4
   Qwen3-4B in both NVFP4 layouts, each with its launch counts checked;
7. card against CPU: slice 1 and path A at CVC_LAYERS (1) layer, full
   width, through the same converted weights on both devices, prefill plus
   15 teacher-forced decode steps (path A: router choices compared too);
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
    attention with a dense 8192-wide MLP at full width and E_LAYERS (14) of
    its 27 layers
    (random bf16 weights from a seeded generator, quantized to FP8_BLOCK by
    the port), ``serving_layout(head_bits=8)`` (fp8 resident), an 8 x 128
    prefill and 128 greedy steps with exact per-step launch counts (the fp8
    matmul and the MLA decode kernel), the fraction of the bytes bound and
    a profiled window;
13. 12 requests through ``ContinuousBatcher`` on path E's params;
14. card against CPU, path E at CVC_LAYERS (1) layer, full width: logits
    and greedy tokens with the bf16 latent cache and with the fp8 one, and one
    no-cache perplexity window (the flash kernel at head dim 256);
16. path F (slice 6 and the RTN oneshot engine): a full-width Qwen3-4B
    bf16 HF checkpoint at F_LAYERS (12) of its 36 layers (random weights
    from a seeded generator)
    quantized to NVFP4 by ``cli/do_oneshot.main --config`` on the card
    (``configs/recipes/recipe_dense_nvfp4.yaml``, the fixture calibration
    set ``configs/calibration_sets/test-calibrate_quick.yaml``), with each
    stage's seconds, the peak device memory, 7 records a layer and the flash
    kernel's launches in the calibration forwards; then ``cli/serve.main``
    on the checkpoint it wrote (the NVFP4 matmul, decode attention, the
    int8 head);
17. path G: ``configs/recipes/recipe_moe_rtn_nvfp4.yaml`` on Qwen3-30B-A3B
    at full width and 4 layers, 3 x 128 expert records a layer, the router
    and attention left bf16, then ``cli/serve.main`` on it (the w8pc slot
    FFN);
18. card against CPU: ``oneshot`` on both devices over the same
    calibration batches, with ``configs/recipes/recipe_fp8_kv8.yaml`` and
    ``recipe_dense_nvfp4.yaml`` on the first 2 layers of path F's model and
    ``recipe_moe_rtn_nvfp4.yaml`` on the first layer of path G's (codes,
    scales, NVFP4's global scales, ``k_scale`` / ``v_scale``, the quantized
    model's logits), and the ``mse`` observer's scales;
19. path H (slice 7e): the first 2 layers of path F's bf16 checkpoint
    through ``do_oneshot`` with ``recipe_awq_w4a16.yaml`` (AWQ, W4A16 g32),
    with exact K4 and K1 launches in calibration, then ``cli/serve.main``
    (K1, K2, K3);
20. path I (slice 7b): the same checkpoint with ``recipe_w8a8_int8.yaml``
    (dynamic per-token int8 activations), K10 on every propagate matmul,
    then ``cli/serve.main`` and a drive with exact per-step K10 launches,
    one a W8A8 linear (phase 3 holds K10 bit-exact against its plain
    version); the drive's decode ms a step, device busy and launches a
    step are printed on a line of their own;
21. card against CPU: AWQ and SmoothQuant + W8A8 on the first 2 layers of
    path F's model, ``recipe_minimax_experts_only_awq.yaml`` on the first
    layer of path G's (each mapping's pick and ``x_mean``, the codes, the
    logits through K1 or K10 on the card);
22. path J (slice 7d): path F's bf16 checkpoint through ``do_oneshot`` with
    ``recipe_gptq_w4a16_g128.yaml`` (GPTQ W4A16 g128 asymmetric, actorder
    group) and with a symmetric g32 GPTQ recipe this script writes, K11
    (GPTQ's column elimination; phase 3 holds it bit for bit against its
    plain version) exactly 208 times a layer, no host factor, then
    ``cli/serve.main`` on both (the g32 one through K1, K2 and K3);
23. card against CPU: both GPTQ recipes on the first 2 layers of path F's
    model (codes, the GPTQ objective against RTN's, ``g_idx``, the logits
    through K1; the card re-solving the CPU's own problems, within 1e-3 of
    the CPU's objectives, and its own with each Hessian entry moved by one
    f32 ulp), and the g32 one on path G's first layer on the card alone
    (K11's exact launches, every expert's objective at most RTN's);
24. path K (slice 7f): the first 2 layers of path F's bf16 checkpoint
    through ``do_oneshot`` with ``recipe_ar_w4a16g32.yaml`` (AutoRound, 200
    steps, W4A16 g32 on the MLP), 3 records a layer, exact K4 and K1
    launches in calibration, then ``cli/serve.main`` (K1, K2, K3);
25. path L (slice 7f): path F's bf16 checkpoint through
    ``cli/model_free.main`` with FP8_BLOCK and the reference's
    GLM-4.7-Flash-FP8 ignore policy (7 tensors a layer), then ``cli/serve.main``
    and a drive with exact launches (K9, K2, K3);
26. card against CPU for slice 7f: AutoRound on layer 0's gate_proj cut to
    256 output channels, on the rows the CPU's capture keeps, held by its
    loss and its codes against a one-device witness (each device re-solving
    its own problem with X one f32 ulp apart); ``model_free`` FP8_BLOCK and
    W4A16_G32 on the first 2 layers of path F's model, every tensor equal
    bit for bit;
27. the training slice at full width: ``fit_lm`` at Qwen3-4B's widths and
    FIT_LAYERS (8) of its 36 layers (the f32 masters, gradients and AdamW
    state of all 36 do not fit one card), seeded weights, on the
    perplexity protocol's chain corpus: one ``lm_loss`` backward with every
    leaf's gradient finite and nonzero, 30 steps with no kernel launched
    (K4 included) and a falling loss, ms a step against the step's bound,
    the peak memory and the memory held before the fit; then
    ``cli/eval_ppl.main`` on the fitted checkpoint, K4 exactly FIT_LAYERS
    launches a batch;
28. the perplexity protocol's W4A16 part through the port's CLIs on the
    card: ``make_tiny_model --fit-corpus`` with the protocol's settings,
    ``do_oneshot`` with RTN, AWQ and GPTQ at W4A16 g32 over its in-domain
    calibration set, ``eval_ppl``: every delta positive, AWQ and GPTQ at
    most RTN;
29. card against CPU for the fit: one set of tiny weights, the
    ``lm_loss`` gradients of one batch and 100 ``fit_lm`` steps' logged
    losses;
30. (inside phases 9-11's directory) ``cli/serve.main --mesh tp=2`` on path
    D's 36-layer checkpoint as two ranks on the card (this script with
    ``--serve-rank``, gloo, both on cuda:0), phase 10's prompts and
    settings: rank 0 prints phase 10's rids, each rank launches K1 on all
    four projections (the row-parallel down_proj at local K 4864), K2 and
    K3 only, two all-reduces a layer a forward; the tokens against phase
    10's (equal up to a near-tie at the first divergence);
31. a pair of rank workers (``--mesh-rank``) against the single-process
    card run on the same seeded weights: (a) Qwen3-4B at full width, 2
    layers, tp 2, an (8, 128) teacher-forced prefill and 16 greedy steps;
    (b) Qwen3-30B-A3B, 2 layers, tp 2, w8pc experts split over tp (K7 at E
    64, K2 at KV 2 rep 8), the router's picks; (c) path E's FP8_BLOCK MLA
    layer at tp 2 (K9 at the shards, K8 at H 8); (d) ``ring_attention`` at
    cp 2, B 1, 32/8 heads, T 8192, against the flash kernel and the plain
    einsum;
32. NCCL at world size 1 in this process: ``initialize``, an all-reduce,
    phase 31 (a)'s forward through the tp 1 mesh path, equal to the plain
    path;
15. after phase 32: one JSON line of per-kernel numbers (with each
    kernel's launches under the mesh), then the card's nvidia-smi line,
    then the final ``{"ok": true, ...}`` line.

Longer per-shape numbers go to ``chiprun_out/chip_smoke_detail.json``.

    python3 chip_smoke.py --calibration-scale

runs instead the calibration of paths F and G at the size of the
repository's real calibration set (``calibration_scale``): its sample count
and ``max_seq_length`` read from
``configs/calibration_sets/calibrate_software_engineer.yaml``, every row
seeded random ids at that length; stage seconds, the peak device memory and
the flash kernel's launches go to
``chiprun_out/chip_smoke_calibration_scale.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import os
import re
import shutil
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
#: the depths of the full-width device paths. Path A, the main path (phase
#: 5), runs all 48 of Qwen3-30B-A3B's layers; the others are cut so that the
#: whole script stays near 800 s on a fast host, since one script's time has
#: moved by 1.42x between hosts (892.5 and 1,270.4 s on NVIDIA H100 80GB HBM3
#: at 700 W) and must stay under 1,200 s on the slow one: slice 1 (phases 4
#: and 8) at 18 of Qwen3-4B's 36 layers, path E (phases 12-13) at 14 of its
#: 27, and the bf16 checkpoint of paths F, J and L (phases 16, 22, 25) at 12
#: of 36. Launch counts scale with the depth; the widths are the models' own
SLICE1_LAYERS, A_LAYERS, E_LAYERS, F_LAYERS = 18, 48, 14, 12

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
#: move a few bf16 roundings of the activations over a layer or two. Largest
#: |err| within 2e-2 of the largest |logit| (2.5 bf16 ulps there), and each
#: position's error norm within 2e-2 of its logits' norm
LOGIT_RTOL = 2e-2
LOGIT_NORM_RTOL = 2e-2
#: the depth of phases 7 and 14 (card against CPU for slice 1, path A and
#: path E): 1 layer. With 2 the whole script took 1,273.5 s on a slower
#: H100 host, past its 1,200 s limit, the CPU sides of these two phases
#: 167.2 s of it
CVC_LAYERS = 1
#: the card may pick another greedy token than the CPU only where the CPU's
#: top two logits lie within this many bf16 ulps of the top one
TIE_ULPS = 2


T_START = time.perf_counter()


def log(*a) -> None:
    """A progress line on stderr, after the seconds since the script began."""
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, file=sys.stderr, flush=True)


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


def w4_layer(gen, m: int, timed: bool = True, shapes: dict = W4_LAYER) -> dict:
    """K1 at the four W4_LAYER shapes (or ``shapes``) with ``m`` rows of x,
    each checked against its plain version and, with ``timed``, timed
    (time_matmul); logs the sum of the device times."""
    from quantizers_tpu_torch.ops import kernels as K

    plain4 = lambda x, lin: K.w4_matmul_plain(x, lin.weight, lin.scale, GROUP)  # noqa: E731
    rows = {}
    for label, (k, n) in shapes.items():
        rows[label] = check_matmul("w4_matmul", K.w4_matmul, plain4, gen, k, n, m, GROUP, timed)
        log(f"[kernels] w4 {label} m={m}: {rows[label]}")
    if timed:
        what = "layer" if shapes is W4_LAYER else "+".join(shapes)
        log(f"[kernels] w4 {what} m={m}: dev_ms {sum(r['dev_ms'] for r in rows.values())}, "
            f"library_dev_ms {sum(r['library_dev_ms'] for r in rows.values())}")
    return rows


#: K2's shapes at batch 8: (KV heads, query heads per KV head, cache slots,
#: the L every row is timed at). main() runs the two serving shapes, slice
#: 1's Qwen3-4B and path A's Qwen3-30B-A3B mid-decode; "long" (slice 1's
#: heads over a full 2048-slot cache) is for timing a redesign by hand
DECODE_SHAPES = {"slice1": (8, 4, MAX_LEN, 255), "path_A": (4, 8, MAX_LEN, 255),
                 "long": (8, 4, 2048, 2047),
                 # a rank's heads at tp 2 (phases 30 and 31 (a), and 31 (b))
                 "slice1_tp2": (4, 4, MAX_LEN, 255), "path_A_tp2": (2, 8, MAX_LEN, 255)}


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

    spec = ModelSpec(**dict(GEOMETRY, num_layers=SLICE1_LAYERS))
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

def logits_agree(label: str, got: torch.Tensor, ref: torch.Tensor, rtol: float = LOGIT_RTOL,
                 norm_rtol: float = LOGIT_NORM_RTOL, tie_rtol: float = None) -> dict:
    """The card's logits against the CPU's: largest |err| within ``rtol``
    of the largest |logit|, each position's error norm within ``norm_rtol``,
    the same greedy token except where the CPU's top two logits are a
    near-tie: within TIE_ULPS bf16 ulps of the top one (its ulp is
    2^(floor(log2 |top|) - 7)), or with ``tie_rtol`` within that fraction of
    the largest |logit|."""
    check(bool(torch.isfinite(got).all()), f"{label}: card logits not finite")
    err = (got - ref).abs().max().item()
    tol = rtol * ref.abs().max().item()
    norm_err = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    top2 = ref.topk(2, dim=-1).values
    if tie_rtol is None:
        window = TIE_ULPS * torch.exp2(torch.floor(torch.log2(top2[..., 0].abs())) - 7)
    else:
        window = tie_rtol * ref.abs().max()
    tie = (top2[..., 0] - top2[..., 1]) <= window
    agree = got.argmax(-1) == ref.argmax(-1)
    row = {"max_abs_err": err, "tol": tol, "max_abs_logit": ref.abs().max().item(),
           "max_rel_norm_err": norm_err, "rel_norm_tol": norm_rtol,
           "positions": agree.numel(), "argmax_agreement": agree.float().mean().item(),
           "near_ties": int(tie.sum())}
    log(f"[{label}] {row}")
    check(err <= tol, f"{label}: max |err| {err:.4g} > tol {tol:.4g}")
    check(norm_err <= norm_rtol, f"{label}: relative error norm {norm_err:.4g} > {norm_rtol}")
    check(bool((agree | tie).all()), f"{label}: greedy token differs at "
          f"{int((~agree & ~tie).sum())} positions that are no near-tie")
    return row


def card_vs_cpu(detail, devices=("cuda", "cpu")):
    from quantizers_tpu_torch.convert import params_from_numpy
    from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
    from quantizers_tpu_torch.serve import serving_layout

    spec = ModelSpec(**dict(GEOMETRY, num_layers=CVC_LAYERS))
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
    detail["card_vs_cpu"] = {"layers": spec.num_layers, "prefill": [B, T],
                             "decode_steps": n_dec - 1, **logits_agree("card-vs-cpu", got, ref)}


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


def check_slot(gen, payload: str, timed: bool, routing: str = "router", E: int = 128) -> dict:
    """K6 (packed w4, packed E2M1, int8-doubled E2M1) or K7 (``w8pc``) at
    the Qwen3-30B-A3B decode shape over ``E`` experts (64: a rank's share
    at tp or ep 2), its slots routed as ``routing`` says
    (``SLOT_ROUTINGS``; the router: 8 tokens x top-8 = 64 slots). Timed:
    the device times of the kernel and of the yardstick, and at the router
    routing the launch-to-launch and plain times too."""
    from quantizers_tpu_torch.models.moe import _slot_dequant
    from quantizers_tpu_torch.ops import kernels as K

    D, Fe = 2048, 768
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
    label = f"{payload} {routing}" + ("" if E == 128 else f" E={E}")
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
    """Path A: Qwen3-30B-A3B, A_LAYERS layers, NVFP4 experts served as w8pc."""
    from quantizers_tpu_torch.models import KVCache, ModelSpec
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    spec = ModelSpec(**dict(MOE_GEOMETRY, num_layers=A_LAYERS))
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
    """Path A at CVC_LAYERS layers, full width, through the same converted
    weights and the same (w8pc) layout on both devices: prefill 2 x 16 (the loop
    over every expert), then 15 teacher-forced decode steps (the slot path).
    The CPU runs first. Each of the card's router decisions is compared
    with the CPU's: a token whose top-k differs must be a near-tie on the
    CPU. The card then takes the CPU's choice, so that the logits compare
    the same function at every position."""
    from quantizers_tpu_torch.convert import params_from_numpy
    from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
    from quantizers_tpu_torch.serve import serving_layout

    spec = ModelSpec(**dict(MOE_GEOMETRY, num_layers=CVC_LAYERS))
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


def serve_prompts(text: Path) -> list:
    """Phase 10's 8 prompts: runs of 3 to 31 words of the synthetic text."""
    words = text.read_text().split()
    return [" ".join(words[i * 7: i * 7 + 3 + 4 * i]) for i in range(8)]


def serve_argv(ckpt: Path, text: Path) -> list:
    """Phase 10's ``cli/serve`` arguments (phase 30 adds ``--mesh``)."""
    argv = [str(ckpt), "--max-new-tokens", "32", "--max-batch", "8", "--max-len", "512",
            "--head-bits", "8"]
    for prompt in serve_prompts(text):
        argv += ["--prompt", prompt]
    return argv


def serve_cli_phase(ckpt, text, detail):
    """``cli/serve.main`` on path D's checkpoint: 8 prompts through the
    continuous batcher with the int8 head. Row prefills and decode steps run
    K1 (w4) and K2; the head K3; prefills with a cache take the einsum
    attention, as in the JAX package, so K4 never launches."""
    from quantizers_tpu_torch.cli import serve
    from quantizers_tpu_torch.ops import kernels as K

    argv = serve_argv(ckpt, text)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with BatcherResults() as res:
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
                              "generate_s": gen_s, "total_s": dt, "launches": counts,
                              "token_ids": {str(k): v for k, v in res.results.items()}}
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


def check_mla_decode(gen, fill, timed: bool, H: int = MLA_GEOMETRY["num_heads"]) -> dict:
    """K8 at the path-E shape (B 8, H 16 (or ``H``: 8 is a rank's heads at
    tp 2), r 512, rope 64 padded to 128, S 512), every row at fill length
    ``fill`` (or row b at ``fill[b]``),
    stale rows past it NaN: each (row, head) held to 2e-2 of its own
    largest |value|, the written rows and the untouched ones exactly."""
    from quantizers_tpu_torch.ops import kernels as K

    B, S = BATCH, MAX_LEN
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
    label += "" if H == MLA_GEOMETRY["num_heads"] else f" H={H}"
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
    """Path E: FP8_BLOCK MLA at E_LAYERS layers, batch 8, 128 + 128 tokens."""
    from quantizers_tpu_torch.models import KVCache, ModelSpec
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    spec = ModelSpec(**dict(MLA_GEOMETRY, num_layers=E_LAYERS))
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
    """Path E at CVC_LAYERS layers, full width: the same FP8_BLOCK weights
    (made and quantized on the CPU) laid out on each device. Prefill 2 x 16 plus 15
    teacher-forced steps with the bf16 latent cache (K9 and K8 on the card)
    and again with the fp8 cache (the plain attention path on both); then
    one no-cache perplexity call over a (1, 512) window (K9 at m 512 and K4
    at head dim 256 on the card)."""
    from quantizers_tpu_torch.data import ByteTokenizer
    from quantizers_tpu_torch.models import KVCache, ModelSpec, forward
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.serve import perplexity, serving_layout
    from quantizers_tpu_torch.serve.engine import token_logprobs

    spec = ModelSpec(**dict(MLA_GEOMETRY, num_layers=CVC_LAYERS))
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
# slice 6 and the RTN oneshot engine: paths F and G, from a bf16 checkpoint
# to a served compressed one, and the engine card against CPU (phases 16-18)
# ---------------------------------------------------------------------------

#: the calibration set of paths F and G and phase 18: the repository's mix of
#: its own fixture datasets (tests/fixtures), read through HF datasets
QUICK_SET = ROOT / "configs" / "calibration_sets" / "test-calibrate_quick.yaml"
#: path G's depth: Qwen3-30B-A3B at full width, 4 of its 48 layers (the cut
#: bounds the bf16 checkpoint's write and load time)
G_LAYERS = 4
#: the seed of path F's bf16 weights (phase 18 takes its first 2 layers)
F_SEED = 16
#: phase 18, card against CPU: codes (E4M3 or E2M1) and NVFP4's group
#: scales equal but for at most this share one grid step apart (a
#: division's result on a rounding tie), other scales and NVFP4's global
#: scales within SCALE_RTOL (both devices divide exactly), the KV-cache
#: scales within KV_SCALE_RTOL (their absmax is a bf16 activation, which the
#: two devices may round an ulp apart, 2^-7 at most)
CODE_TIE_SHARE, SCALE_RTOL, KV_SCALE_RTOL = 1e-4, 1e-6, 1e-2
#: the mse observer on both devices: a cell may pick another clip ratio only
#: where the CPU's errors of the two picks lie within this fraction (f32 sums
#: in other orders)
MSE_TIE_RTOL = 1e-5


def write_run_config(path: Path, model_dir: Path, recipe) -> Path:
    """A run config naming ``model_dir``, the fixture calibration set and a
    recipe: a repository recipe's name, or the path of a recipe file."""
    recipe_path = recipe if isinstance(recipe, Path) else ROOT / "configs" / "recipes" / f"{recipe}.yaml"
    path.write_text(f"model:\n  name: {model_dir}\nquantization:\n"
                    f"  recipe: {recipe_path}\n"
                    f"calibration_set: {QUICK_SET}\n")
    return path


def write_bf16_model(spec, seed: int, cuts: list, device: str = "cuda") -> dict:
    """Plain HF bf16 checkpoints of ``init_params(spec, seed)`` (random
    weights made on the card), written by the port's ``save_hf_model``: for
    each (directory, n) of ``cuts``, the model's first n layers (the first
    cut's numbers are returned)."""
    from quantizers_tpu_torch.models import init_params
    from quantizers_tpu_torch.models.loader import save_hf_model

    t0 = time.perf_counter()
    params = init_params(spec, seed=seed, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (out_dir, n) in enumerate(cuts):
        save_hf_model(dataclasses.replace(spec, num_layers=n),
                      dict(params, layers=params["layers"][:n]), out_dir)
        if i == 0:
            t_write = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    out_dir, n = cuts[0]
    return {"layers": n, "init_s": t_init, "write_s": t_write,
            "bytes": sum(f.stat().st_size for f in out_dir.iterdir())}


def oneshot_cli(label: str, run_cfg: Path, out_dir: Path, cache_dir: Path, card: str) -> dict:
    """``cli/do_oneshot.main --config`` on the card, as a user runs it, with
    every launch count set to 0 just before it and the peak device memory
    reset: its stage seconds (from its log), records, launches and peak.
    ``card`` is the nvidia-smi line, logged beside the numbers."""
    from quantizers_tpu_torch.cli import do_oneshot
    from quantizers_tpu_torch.ops import kernels as K

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(ROOT):  # the set's dataset paths are the repository's
        rc, _, rec = run_cli(do_oneshot.main, ["--config", str(run_cfg), "--output",
                                               str(out_dir), "--cache-dir", str(cache_dir)],
                             "quantizers_tpu_torch.do_oneshot")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = K.launch_counts(), torch.cuda.max_memory_allocated()
    check(rc == 0, f"{label}: do_oneshot returned {rc}")
    n_samples, n_batches, tok_s = rec.args("tokenized")
    capture_s, solve_s, propagate_s = rec.args("oneshot stages")
    res = {"calibration_set_s": rec.args("calibration set")[0],
           "load_s": rec.args("model loaded")[0], "tokenize_s": tok_s,
           "samples": n_samples, "batches": n_batches,
           "oneshot_s": rec.args("oneshot done")[0], "capture_s": capture_s,
           "solve_s": solve_s, "propagate_s": propagate_s,
           "save_s": rec.args("saved compressed model")[1],
           "cli_total_s": rec.args("total wall clock")[0], "wall_s": wall,
           "records": rec.args("oneshot done")[1], "peak_memory_gb": peak / 1e9,
           "launches": counts,
           "output_bytes": sum(f.stat().st_size for f in out_dir.iterdir())}
    log(f"[{label}] do_oneshot ({card}): {res}")
    return res


def serve_output(label: str, ckpt: Path, text: str, served: tuple, card: str) -> dict:
    """``cli/serve.main`` on a checkpoint that do_oneshot wrote: 8 prompts,
    16 new tokens each, the int8 head. ``served`` lists groups of kernels:
    at least one kernel of each group must launch, and none outside them."""
    from quantizers_tpu_torch.cli import serve
    from quantizers_tpu_torch.ops import kernels as K

    words = text.split()
    argv = [str(ckpt), "--max-new-tokens", "16", "--max-batch", "8", "--max-len", "512",
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
    check(rc == 0 and rids == [str(i) for i in range(8)],
          f"{label} serve: want one line per prompt, got rids {rids}")
    allowed = {k for group in served for k in group}
    check(all(any(counts[k] > 0 for k in group) for group in served)
          and counts == expect(**{k: counts[k] for k in allowed}),
          f"{label} serve: one kernel of each of {served} must launch, and nothing else: "
          f"{counts}")
    n_tok, _, gen_s = rec.args("generated")[:3]
    res = {"prompts": 8, "tokens": n_tok, "load_s": rec.args("loaded")[1],
           "generate_s": gen_s, "tok_s": n_tok / gen_s, "total_s": dt, "launches": counts}
    log(f"[{label} serve] ({card}) {res}")
    return res


def oneshot_dense_phase(detail, tmp: Path) -> tuple:
    """Path F: the first F_LAYERS layers of a Qwen3-4B bf16 model through
    do_oneshot with RTN NVFP4 on every linear, then served. Returns that
    checkpoint (paths J and L take it) and the 2-layer bf16 checkpoint of
    the same weights (paths H, I and K, phases 18, 21, 23 and 26)."""
    from quantizers_tpu_torch.models import ModelSpec

    card = detail["device"]
    spec = ModelSpec(**dict(GEOMETRY, num_layers=F_LAYERS))
    bf16, two = tmp / "qwen3_4b_bf16", tmp / "qwen3_4b_bf16_2layers"
    info = write_bf16_model(spec, F_SEED, [(bf16, F_LAYERS), (two, 2)])
    log(f"[path F] bf16 checkpoint ({card}): {info}")
    out = tmp / "qwen3_4b_nvfp4"
    run = oneshot_cli("path F", write_run_config(tmp / "run_F.yaml", bf16, "recipe_dense_nvfp4"),
                      out, tmp / "calibration_cache", card)
    check(run["records"] == spec.num_layers * 7,
          f"path F: {run['records']} records, want {spec.num_layers * 7}")
    check(run["launches"]["flash_attention"] > 0,
          f"path F: the flash kernel never ran in calibration: {run['launches']}")
    qcfg = json.loads((out / "config.json").read_text())["quantization_config"]
    w = qcfg["config_groups"]["group_0"]["weights"]
    check((w["num_bits"], w["type"], w["strategy"]) == (4, "float", "tensor_group"),
          f"path F: the checkpoint's scheme is {w}")
    torch.cuda.empty_cache()
    served = serve_output("path F", out, synthetic_text(),
                          (("decode_attention",), ("w8_matmul",),
                           ("nvfp4_matmul", "nvfp4_i8_matmul")), card)
    detail["path_F"] = {"device": card, "checkpoint": info, "oneshot": run,
                        "serve": served}
    shutil.rmtree(out)
    return bf16, two


def oneshot_moe_phase(detail, tmp: Path) -> Path:
    """Path G: the reference's headline recipe (experts-only NVFP4) on
    Qwen3-30B-A3B at full width and G_LAYERS layers, then served (w8pc
    experts, the fused slot FFN at decode). Returns the 1-layer bf16
    checkpoint of the same weights (phase 18's)."""
    from quantizers_tpu_torch.formats.checkpoint import CompressedModelReader
    from quantizers_tpu_torch.models import ModelSpec

    card = detail["device"]
    spec = ModelSpec(**dict(MOE_GEOMETRY, num_layers=G_LAYERS))
    bf16, out = tmp / "qwen3_30b_a3b_bf16", tmp / "qwen3_30b_a3b_nvfp4"
    one = tmp / "qwen3_30b_a3b_bf16_1layer"
    info = write_bf16_model(spec, F_SEED + 1, [(bf16, G_LAYERS), (one, 1)])
    log(f"[path G] bf16 checkpoint, {G_LAYERS} layers ({card}): {info}")
    run = oneshot_cli("path G", write_run_config(tmp / "run_G.yaml", bf16,
                                                 "recipe_moe_rtn_nvfp4"),
                      out, tmp / "calibration_cache", card)
    E = spec.num_experts
    check(run["records"] == G_LAYERS * 3 * E,
          f"path G: {run['records']} records, want {G_LAYERS * 3 * E}")
    with CompressedModelReader(out) as r:
        quant = r.quantized_modules()
        per_layer = [sum(p.startswith(f"model.layers.{i}.mlp.experts.") for p in quant)
                     for i in range(G_LAYERS)]
        kept = {n: r.load_plain(f"model.layers.{i}.{n}.weight").dtype
                for i in range(G_LAYERS) for n in ("mlp.gate", "self_attn.q_proj",
                                                   "self_attn.o_proj")}
    check(per_layer == [3 * E] * G_LAYERS and len(quant) == G_LAYERS * 3 * E,
          f"path G: expert records per layer {per_layer}, {len(quant)} in all")
    check(set(kept.values()) == {torch.bfloat16},
          f"path G: the router and attention must stay bf16: {set(kept.values())}")
    shutil.rmtree(bf16)
    torch.cuda.empty_cache()
    served = serve_output("path G", out, synthetic_text(),
                          (("decode_attention",), ("w8_matmul",), ("moe_slot_gu_ffn",)), card)
    detail["path_G"] = {"device": card, "layers": G_LAYERS, "checkpoint": info,
                        "oneshot": run, "expert_records_per_layer": per_layer, "serve": served}
    shutil.rmtree(out)
    return one


def _code_steps(ia: torch.Tensor, ib: torch.Tensor, sign: int) -> torch.Tensor:
    """How many grid steps apart two tensors of sign-magnitude codes are
    (``sign``: the sign bit)."""
    ia, ib = ia.int(), ib.int()
    same_sign = (ia & sign) == (ib & sign)
    return torch.where(same_sign, (ia - ib).abs(), (ia & (sign - 1)) + (ib & (sign - 1)))


def _fp8_code_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many E4M3 steps apart two tensors of E4M3 grid values are."""
    return _code_steps(a.to(torch.float8_e4m3fn).view(torch.uint8),
                       b.to(torch.float8_e4m3fn).view(torch.uint8), 0x80)


def _fp4_code_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many E2M1 steps apart two tensors of E2M1 grid values are."""
    from quantizers_tpu_torch.formats.compressed_tensors import fp4_encode

    return _code_steps(fp4_encode(a), fp4_encode(b), 0x8)


def mse_on_both(w: dict, devices) -> dict:
    """The mse observer's scales for one weight on each device: a cell may
    pick another clip ratio only where the CPU's errors of the two picks
    are a near-tie."""
    from quantizers_tpu_torch.core import numerics as tn
    from quantizers_tpu_torch.core.scheme import QuantizationArgs

    args = QuantizationArgs.from_dict(dict(num_bits=4, type="int", symmetric=True,
                                           strategy="group", group_size=32, observer="mse"))
    scales = {d: tn.quantize(w[d], args).scale.float().cpu() for d in devices}
    got, ref = (scales[d] for d in devices)
    differ = got != ref
    wc = w[devices[1]].float().cpu()

    def cell_err(scale):
        d = tn.dequantize(tn.quantize(wc, args, scale=scale), args) - wc
        return tn._reduce_err_to_scale(d * d, args)

    e_got, e_ref = cell_err(got), cell_err(ref)
    worst = ((e_got - e_ref) / e_ref.clamp(min=1e-30))[differ].max().item() if differ.any() else 0.0
    res = {"cells": differ.numel(), "cells_differing": int(differ.sum()),
           "worst_err_excess": worst, "tie_rtol": MSE_TIE_RTOL}
    check(worst <= MSE_TIE_RTOL, f"card vs CPU mse: a cell's pick is worse by {worst:.3g}")
    return res


def engine_side(ckpt: Path, recipe_name: str, recipe, batches, ids, dev, replay=None,
                record=None, keep_params: bool = False) -> tuple:
    """``oneshot`` of one repository recipe (or the ``recipe`` dict given)
    over one bf16 checkpoint on ``dev``: its records (on the host), extra
    tensors, the quantized model's logits on ``ids``, the router decisions
    of that forward (taking ``replay``'s, another run's, where given), the
    flash launches of calibration, the launches of the logits forward, the
    first q_proj weight as loaded, the spec, the seconds, and the log of the
    ``record`` recorder around ``oneshot`` ("awq": ``awq_searches``,
    "gptq": ``gptq_sites``). Returns it with the quantized params where
    ``keep_params``."""
    from quantizers_tpu_torch.models import forward, load_hf_model
    from quantizers_tpu_torch.oneshot import oneshot
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.recipes import parse_recipe

    recorder = ({"awq": awq_searches, "gptq": gptq_sites}[record]() if record
                else contextlib.nullcontext([]))
    t0 = time.perf_counter()
    spec, params = load_hf_model(ckpt, device=dev)
    w = params["layers"][0]["q_proj"].dequantize(torch.float32).t().contiguous()
    K.reset_launch_counts()
    with recorder as log_:
        r = oneshot(spec, params, parse_recipe(
            recipe if recipe is not None
            else str(ROOT / "configs" / "recipes" / f"{recipe_name}.yaml")), batches, device=dev)
    calibration = K.launch_counts()
    K.reset_launch_counts()
    with torch.no_grad(), RouteRecorder(replay) as rec:
        logits = forward(r.params, spec, torch.as_tensor(ids, device=dev).long()
                         )[0].float().cpu()
    side = {"records": {k: cp.qt for k, cp in r.records.items()}, "extra": r.extra_tensors,
            "logits": logits, "routes": rec.calls, "flash": calibration["flash_attention"],
            "calibration": calibration, "forward": K.launch_counts(), "w": w, "spec": spec,
            "log": log_, "s": time.perf_counter() - t0}
    log(f"[card-vs-cpu oneshot] {recipe_name} on {dev}: {side['s']:.1f} s")
    return side, (r.params if keep_params else None)


def engine_on_both(ckpt: Path, recipe_name: str, batches, ids, devices, recipe=None,
                   cross: bool = False, plain_k10: bool = False, record=None) -> dict:
    """``engine_side`` on each device, the CPU (``devices[1]``) first, the
    card taking the CPU's router decisions (as in ``card_vs_cpu_moe``).
    With ``cross``, the card also runs the CPU's quantized model
    (``cross_logits``, ``cross_routes``, ``cross_launches``): the card's
    kernels against the CPU's plain path on the same weights; with
    ``plain_k10`` as well once more with K10's plain version in its place on
    the card (``cross_plain_k10_logits``)."""
    from quantizers_tpu_torch.models import forward
    from quantizers_tpu_torch.models.transformer import tree_to
    from quantizers_tpu_torch.ops import kernels as K

    dev, cpu = devices
    ref, cpu_params = engine_side(ckpt, recipe_name, recipe, batches, ids, cpu, record=record,
                                  keep_params=cross)
    got, _ = engine_side(ckpt, recipe_name, recipe, batches, ids, dev, replay=ref["routes"],
                         record=record)
    out = {cpu: ref, dev: got}
    if cross:
        spec = ref["spec"]
        K.reset_launch_counts()
        with torch.no_grad(), RouteRecorder(ref["routes"]) as rec:
            logits = forward(tree_to(cpu_params, dev), spec,
                             torch.as_tensor(ids, device=dev).long())[0].float().cpu()
        got.update(cross_logits=logits, cross_routes=rec.calls,
                   cross_launches=K.launch_counts())
        if plain_k10:
            with torch.no_grad(), RouteRecorder(ref["routes"]), K10Plain():
                got["cross_plain_k10_logits"] = forward(
                    tree_to(cpu_params, dev), spec,
                    torch.as_tensor(ids, device=dev).long())[0].float().cpu()
    del cpu_params
    return out


class K10Plain:
    """K10's plain version in the wrapper's place while active, on the
    tensors' own device, as the wrapper computes it on the CPU."""

    def __enter__(self):
        from quantizers_tpu_torch.ops import kernels as K

        self.mod, self.orig = K, K.w8a8_token_matmul

        def plain(x, lin):
            k, n = lin.in_features, lin.out_features
            y = K.w8a8_token_matmul_plain(x.reshape(-1, k), lin)
            return y.to(x.dtype).reshape(*x.shape[:-1], n)
        K.w8a8_token_matmul = plain
        return self

    def __exit__(self, *exc):
        self.mod.w8a8_token_matmul = self.orig
        return False


def routes_agree(label: str, got: list, ref: list) -> dict:
    """Each of the card's router decisions against the CPU's: a token whose
    top-k differs must be a near-tie on the CPU (ROUTE_GAP_RTOL)."""
    check(len(got) == len(ref), f"{label}: router calls {len(got)} / {len(ref)}")
    flips = near = decisions = 0
    for (ti, _, _), (ri, pk, pk1) in zip(got, ref):
        tie = (pk - pk1) <= ROUTE_GAP_RTOL * pk
        differ = (ti.sort(-1).values != ri.sort(-1).values).any(-1)
        decisions += ri.shape[0]
        flips += int(differ.sum())
        near += int(tie.sum())
        check(bool((~differ | tie).all()),
              f"{label}: a router choice differs where the CPU's gap is no near-tie")
    return {"router_decisions": decisions, "router_flips": flips, "router_near_ties": near,
            "router_gap_rtol": ROUTE_GAP_RTOL}


def records_agree(label: str, got: dict, ref: dict, n_records: int) -> dict:
    """The card's records against the CPU's: codes (and the group scales of
    NVFP4, which lie on the E4M3 grid) equal but for a share of at most
    CODE_TIE_SHARE one step apart; every other scale and NVFP4's global
    scales within SCALE_RTOL."""
    check(sorted(got) == sorted(ref) and len(got) == n_records,
          f"{label}: records {len(got)} / {len(ref)}, want {n_records}")
    tally = {"codes": [0, 0, 0], "grid_scales": [0, 0, 0]}  # cells, differing, max steps
    scale_err = 0.0

    def count(key, steps):
        t = tally[key]
        t[0] += steps.numel()
        t[1] += int((steps > 0).sum())
        t[2] = max(t[2], int(steps.max()))

    for k, qt in got.items():
        rq = ref[k]
        nvfp4 = rq.global_scale is not None
        count("codes", (_fp4_code_steps if nvfp4 else _fp8_code_steps)(qt.values, rq.values))
        if nvfp4:
            count("grid_scales", _fp8_code_steps(qt.scale.float(), rq.scale.float()))
            pairs = [(qt.global_scale, rq.global_scale)]
        else:
            pairs = [(qt.scale, rq.scale)]
        for a, b in pairs:
            a, b = a.float(), b.float()
            scale_err = max(scale_err, ((a - b).abs() / b.abs()).max().item())
    row = {"records": len(got), "code_share_limit": CODE_TIE_SHARE, "max_scale_rel_err": scale_err,
           "scale_rtol": SCALE_RTOL}
    for key, (cells, differing, steps) in tally.items():
        if cells:
            row[key] = {"cells": cells, "differing": differing, "max_steps": steps}
            check(differing <= CODE_TIE_SHARE * cells and steps <= 1,
                  f"{label}: {differing} of {cells} {key} differ, up to {steps} steps")
    check(scale_err <= SCALE_RTOL, f"{label}: scale error {scale_err:.3g}")
    return row


def fixture_rows(tmp: Path) -> list:
    """The fixture set's tokenized rows (11), from the calibration cache that
    path F's ``do_oneshot`` built."""
    from quantizers_tpu_torch.data import ByteTokenizer, CalibrationSet, CalibrationSetConfig

    cfg = CalibrationSetConfig.from_file(str(QUICK_SET))
    cache = str(tmp / "calibration_cache")
    with contextlib.chdir(ROOT):
        calib = (CalibrationSet.from_cache(cfg, cache) if CalibrationSet.is_cached(cfg, cache)
                 else CalibrationSet.from_config(cfg, cache))
        return [r["input_ids"] for r in calib.get_tokenized(ByteTokenizer())]


def comparison_batches(tmp: Path) -> tuple:
    """The card-against-CPU oneshot checks' calibration (phases 18, 21 and
    23): the fixture set's first 8 rows as two (4, 256) batches, the logits'
    ids (the last batch's first row), and its first row alone (the
    experts-only AWQ searches all 128 experts at full width: one row keeps
    its CPU side's loss products small)."""
    from quantizers_tpu_torch.oneshot import make_batches

    rows = fixture_rows(tmp)
    batches = make_batches(rows[:8], max_seq_length=256, batch_size=4)[:2]
    return batches, batches[-1][0][:1], make_batches(rows[:1], max_seq_length=256, batch_size=1)


def card_vs_cpu_oneshot(detail, tmp: Path, dense: Path, moe: Path,
                        devices=("cuda", "cpu")) -> None:
    """The engine on both devices over the same calibration batches:
    recipe_fp8_kv8 (FP8 channel weights, the FP8 KV cache: its scales need
    the capture pass) and recipe_dense_nvfp4 on the 2-layer dense
    checkpoint, recipe_moe_rtn_nvfp4 (experts only) on the 1-layer MoE
    one; then the mse observer's picks on both devices."""
    batches, ids, _ = comparison_batches(tmp)
    row = {"device": detail["device"], "batches": [list(b[0].shape) for b in batches]}
    detail["card_vs_cpu_oneshot"] = row
    # (recipe, checkpoint, its layers, records a layer, the batches: the
    # MoE slice's CPU run sends every token through all 128 experts, so it
    # takes one batch)
    cases = (("recipe_fp8_kv8", dense, 2, 7, batches),
             ("recipe_dense_nvfp4", dense, 2, 7, batches),
             ("recipe_moe_rtn_nvfp4", moe, 1, 3 * MOE_GEOMETRY["num_experts"], batches[:1]))
    w = None
    for name, ckpt, layers, per_layer, bs in cases:
        label = f"card vs CPU oneshot {name}"
        res = engine_on_both(ckpt, name, bs, ids, devices)
        got, ref = (res[d] for d in devices)
        r = {"layers": layers, "seconds": {d: res[d]["s"] for d in devices},
             "flash_launches_card": got["flash"],
             **records_agree(label, got["records"], ref["records"], layers * per_layer)}
        check(got["flash"] > 0, f"{label}: the flash kernel never ran in calibration")
        if name == "recipe_fp8_kv8":
            ec, er = got["extra"], ref["extra"]
            check(sorted(ec) == sorted(er) and len(er) == 4,
                  f"{label}: KV scales {sorted(ec)} / {sorted(er)}")
            kv_err = max(abs(ec[k].item() - er[k].item()) / er[k].item() for k in er)
            r.update(kv_scales={k: [ec[k].item(), er[k].item()] for k in sorted(er)},
                     max_kv_scale_rel_err=kv_err, kv_scale_rtol=KV_SCALE_RTOL)
            check(kv_err <= KV_SCALE_RTOL, f"{label}: KV scale error {kv_err:.3g}")
            w = {d: res[d]["w"] for d in devices}
        r.update(routes_agree(label, got["routes"], ref["routes"]))
        r["logits"] = logits_agree(label, got["logits"], ref["logits"])
        row[name] = r
        log(f"[{label}] {r}")
        del res, got, ref
    row["mse_observer"] = mse_on_both(w, devices)
    log(f"[card-vs-cpu oneshot] mse observer {row['mse_observer']}")


#: the repository's real calibration set, whose hub datasets are not in the
#: repository: ``calibration_scale`` takes its sample count and length cap
REAL_SET = ROOT / "configs" / "calibration_sets" / "calibrate_software_engineer.yaml"
#: the seed of ``calibration_scale``'s token ids
SCALE_SEED = 18


def calibration_scale(detail) -> None:
    """Paths F and G's calibration at the real set's size: as many rows as
    the set's ``num_samples`` add up to, each ``max_seq_length`` seeded
    random ids long (rows longer than the cap are cut to it, so this is
    the most time and memory the set can take), in ``do_oneshot``'s
    batches of 4, through the functions ``cli/do_oneshot.main`` calls
    (load, ``oneshot`` in device mode, ``save_result``). Per path: each
    stage's seconds, the peak device memory, the records, the flash
    kernel's launches; and for the 48-layer Qwen3-30B-A3B the bytes the
    two offload modes would hold (shape arithmetic)."""
    from quantizers_tpu_torch.cli.do_oneshot import save_result
    from quantizers_tpu_torch.data import CalibrationSetConfig
    from quantizers_tpu_torch.data.simple_tokenizer import load_tokenizer
    from quantizers_tpu_torch.models import load_hf_model
    from quantizers_tpu_torch.oneshot import make_batches, oneshot
    from quantizers_tpu_torch.oneshot.engine import streaming_peak_bytes
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.recipes import parse_recipe

    card = detail["device"]
    cfg = CalibrationSetConfig.from_file(str(REAL_SET))
    n, T = sum(d.num_samples for d in cfg.datasets), cfg.max_seq_length
    gen = torch.Generator().manual_seed(SCALE_SEED)
    paths = (("F", ModelSpec(**GEOMETRY), "recipe_dense_nvfp4", F_SEED, 7),
             ("G", ModelSpec(**dict(MOE_GEOMETRY, num_layers=G_LAYERS)),
              "recipe_moe_rtn_nvfp4", F_SEED + 1, 3 * MOE_GEOMETRY["num_experts"]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        for label, spec, recipe_name, seed, per_layer in paths:
            bf16, out = Path(tmp) / f"{label}_bf16", Path(tmp) / f"{label}_out"
            info = write_bf16_model(spec, seed, [(bf16, spec.num_layers)])
            ids = torch.randint(0, spec.vocab_size, (n, T), generator=gen, dtype=torch.int32)
            batches = make_batches(list(ids.numpy()), max_seq_length=T, batch_size=4)
            recipe = parse_recipe(str(ROOT / "configs" / "recipes" / f"{recipe_name}.yaml"))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            spec_l, params = load_hf_model(bf16, device="cuda")
            tokenizer = load_tokenizer(str(bf16))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = oneshot(spec_l, params, recipe, batches, device="cuda")
            torch.cuda.synchronize()
            oneshot_s = time.perf_counter() - t0
            del params
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            save_result(spec_l, res, out, tokenizer, bf16, torch.device("cuda"))
            save_s = time.perf_counter() - t0
            counts = K.launch_counts()
            row = {"device": card, "samples": n, "seq_len": T, "batches": len(batches),
                   "tokens": n * T, "layers": spec.num_layers, "checkpoint": info,
                   "load_s": load_s, "oneshot_s": oneshot_s,
                   **{k: res.stats[k] for k in ("capture_s", "solve_s", "propagate_s")},
                   "save_s": save_s, "peak_memory_gb": peak / 1e9,
                   "hiddens_gb": n * T * spec.hidden_size * 2 / 1e9,
                   "records": len(res.records), "launches": counts,
                   "output_bytes": sum(f.stat().st_size for f in out.iterdir())}
            log(f"[calibration scale, path {label}] ({card}) {row}")
            check(row["records"] == spec.num_layers * per_layer,
                  f"calibration scale {label}: {row['records']} records")
            check(counts["flash_attention"] == spec.num_layers * len(batches),
                  f"calibration scale {label}: flash launches {counts['flash_attention']}, "
                  f"want one a layer and batch")
            detail[f"path_{label}"] = row
            del res
            shutil.rmtree(bf16)
            shutil.rmtree(out)
    # the 48-layer model: device mode holds its bf16 params and every
    # batch's hiddens; host mode one layer and one batch (the records, 4
    # bytes a weight, go to the host in both)
    full = ModelSpec(**MOE_GEOMETRY)
    plan = streaming_peak_bytes(full, 4, T)
    detail["plan_qwen3_30b_a3b_48_layers"] = {
        "params_bf16_gb": (plan["embed_bytes"] * (1 if full.tie_word_embeddings else 2)
                           + plan["layer_bytes"] * full.num_layers) / 1e9,
        "hiddens_gb": n * T * full.hidden_size * 2 / 1e9,
        "host_mode_peak_gb": plan["peak_bytes"] / 1e9,
        "expert_records_host_gb": full.num_layers * 3 * full.num_experts
        * full.hidden_size * full.moe_intermediate_size * 4 / 1e9}
    log(f"[calibration scale] 48-layer plan {detail['plan_qwen3_30b_a3b_48_layers']}")


# ---------------------------------------------------------------------------
# slices 7b and 7e: K10, the W8A8 int8 GEMM (phase 3), paths H and I from
# path F's bf16 checkpoint (phases 19-20), and card against CPU (phase 21)
# ---------------------------------------------------------------------------

#: H100 SXM dense int8 tensor rate (NVIDIA data sheet), operations/s
INT8_OPS = 1979e12
#: the depth of paths H and I: the first layers of path F's model (the
#: checkpoint phases 18, 21 and 23 take too), cut from 36 so that the whole
#: script stays within 900 s once path J and phase 23 run (969.1 s with
#: both at full depth on an H100)
HI_LAYERS = 2
#: Qwen3-4B's seven projections (K, N): K10's shapes in path I's calibration
QWEN3_PROJ = {"q_proj": (2560, 4096), "k_proj": (2560, 1024), "v_proj": (2560, 1024),
              "o_proj": (4096, 2560), "gate_proj": (2560, 9728), "up_proj": (2560, 9728),
              "down_proj": (9728, 2560)}
#: path I's served layer, q|k|v and gate|up fused: K10's four calls a layer
QWEN3_SERVED = {"qkv_proj": (2560, 6144), "o_proj": (4096, 2560),
                "gate_up_proj": (2560, 19456), "down_proj": (9728, 2560)}
#: K10's rows: decode (8), the row prefill (128), the calibration propagate
#: (512), prefill (1024); timed at decode and prefill
W8A8_ROWS, W8A8_TIMED = (8, 128, 512, 1024), (8, 1024)
#: (m, K, N) beyond the projections: one row, odd rows, K and N tails (K %
#: 64 and N % 128 non-zero; K 200 and N 300 also not multiples of 16)
W8A8_OTHER = ((1, 2560, 4096), (3, 9728, 2560), (3, 2592, 2608), (5, 200, 300),
              (17, 1000, 136))
#: torch._int_mm, K10's library yardstick, takes more than 16 rows
INT_MM_MIN_ROWS = 32


def w8a8_linear(gen, k: int, n: int, scale_dtype=torch.bfloat16):
    from quantizers_tpu_torch.ops.linear import QuantLinear

    dev = gen.device
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
    scale = (torch.rand((1, n), device=dev, generator=gen) * 0.004 + 0.001).to(scale_dtype)
    return QuantLinear(kind="w8", weight=w, scale=scale,
                       meta=(("k", k), ("n", n), ("group_size", None), ("act", "token_i8")))


def bound_int8(nbytes: float, ops: float) -> dict:
    """The least time the card could take for an int8 product: the larger of
    the bytes over the memory rate and the operations over the int8 tensor
    rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS
    return {"bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_w8a8(gen, k: int, n: int, m: int, scale_dtype=torch.bfloat16,
               out_dtype=torch.bfloat16) -> dict:
    """K10's GEMM alone (the int8-codes entry, ``w8a8_matmul``) against its
    plain version at one shape, bit for bit (both sum the int8 products
    exactly and scale as the JAX package does), twice."""
    from quantizers_tpu_torch.core.numerics import dynamic_quantize_token_int8
    from quantizers_tpu_torch.ops import kernels as K

    lin = w8a8_linear(gen, k, n, scale_dtype)
    x = (torch.randn((m, k), device=gen.device, generator=gen) * 2).bfloat16()
    xq, sx = dynamic_quantize_token_int8(x.float())
    before = K.w8a8_matmul.launches
    got = K.w8a8_matmul(xq, sx, lin, out_dtype)
    ref = K.w8a8_matmul_plain(xq, sx.reshape(-1), lin.weight, lin.scale).to(out_dtype)
    torch.cuda.synchronize()
    label = f"w8a8_matmul {m}x{k}x{n}"
    err = (got.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(bool(torch.equal(got, ref)), f"{label}: max |err| {err:.4g} against the plain version")
    check(bool(torch.equal(K.w8a8_matmul(xq, sx, lin, out_dtype), got)),
          f"{label}: differs from run to run")
    check(K.w8a8_matmul.launches == before + 2, f"{label}: launches not counted")
    K.w8a8_matmul.launches = before  # checks are not main-path launches
    return {"m": m, "k": k, "n": n, "scale_dtype": str(scale_dtype), "out_dtype": str(out_dtype),
            "max_abs_err": err, "tol": 0.0,
            "plan": tuple(K.w8a8_plan(m, k, n, torch.cuda.get_device_properties(0)
                                      .multi_processor_count))}


#: 0.5 - 2^-25: its f32 |q| + 0.5 rounds up to 1.0 (roundf gives 0)
W8A8_TIE = 0.5 - 2.0 ** -25
#: (m, K, N) of the rows that reach the quantizer's traps: decode (one
#: launch) at path I's q|k|v and down, the batcher's 64 rows, the row
#: prefill (the quantizer pass), and a K and N tail
W8A8_EDGE = ((8, 2560, 6144), (8, 9728, 2560), (64, 4096, 2560), (128, 2560, 1024),
             (16, 200, 300))


def w8a8_edge_rows(x):
    """x (f32) with rows that reach the quantizer's traps: all zero (the
    1e-12 floor), the tie (absmax 127.5 makes the scale 1.0, so q = x),
    +inf, -inf, NaN, and all at +-127.5 (the clamp)."""
    k = x.shape[1]
    x[1] = 0.0
    x[2] = W8A8_TIE
    x[2, 0], x[2, 1], x[2, 2] = 127.5, -W8A8_TIE, 2.5
    x[3, 5] = float("inf")
    x[4, 7] = float("-inf")
    x[5, 3] = float("nan")
    x[6] = torch.where(torch.arange(k, device=x.device) % 2 == 1, 127.5, -127.5)
    return x


def same_nan(a, b) -> bool:
    """Equal bit for bit but that NaN equals NaN."""
    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num()))


def check_w8a8_token(gen, k: int, n: int, m: int, timed: bool, scale_dtype=torch.bfloat16,
                     x_dtype=torch.bfloat16, edge: bool = False) -> dict:
    """K10, the W8A8 linear with its per-token quantizer inside
    (``w8a8_token_matmul``), against its plain version at one shape, bit
    for bit (with ``edge``, x in f32 with w8a8_edge_rows: NaN equal to
    NaN, those rows all NaN), twice. With ``timed``: its time and device
    time, the plain version's, the bound (x read and the output written in
    x's dtype), torch._int_mm's device time on the codes (m padded to
    INT_MM_MIN_ROWS below it), and the unfused composition's (the PyTorch
    quantizer, then K10's GEMM alone on its codes)."""
    from quantizers_tpu_torch.core.numerics import dynamic_quantize_token_int8
    from quantizers_tpu_torch.ops import kernels as K

    lin = w8a8_linear(gen, k, n, scale_dtype)
    x = (torch.randn((m, k), device=gen.device, generator=gen) * 2).to(
        torch.float32 if edge else x_dtype)
    if edge:
        x = w8a8_edge_rows(x)
    before, before_gemm = K.w8a8_token_matmul.launches, K.w8a8_matmul.launches
    got = K.w8a8_token_matmul(x, lin)
    ref = K.w8a8_token_matmul_plain(x, lin).to(x.dtype)
    torch.cuda.synchronize()
    label = f"w8a8_token_matmul {m}x{k}x{n} {x.dtype}{' edge rows' if edge else ''}"
    err = (got.float() - ref.float()).nan_to_num().abs().max().item()
    check(same_nan(got, ref), f"{label}: max |err| {err:.4g} against the plain version")
    if edge:
        check(bool(got[3:6].isnan().all()) and not bool(got[[0, 1, 2, 6]].isnan().any())
              and bool((got[1] == 0).all()), f"{label}: the edge rows' NaN pattern")
    else:
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(same_nan(K.w8a8_token_matmul(x, lin), got), f"{label}: differs from run to run")
    check(K.w8a8_token_matmul.launches == before + 2, f"{label}: launches not counted")
    K.w8a8_token_matmul.launches = before  # checks are not main-path launches
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"m": m, "k": k, "n": n, "scale_dtype": str(scale_dtype), "x_dtype": str(x.dtype),
           "edge": edge, "max_abs_err": err, "tol": 0.0, "plan": tuple(K.w8a8_plan(m, k, n, sms))}
    if not timed:
        return row
    nbytes = (m * k + m * n) * x.element_size() + k * n + n * lin.scale.element_size()
    copies = [lin] + [dataclasses.replace(lin, weight=lin.weight.clone(), scale=lin.scale.clone())
                      for _ in range(copies_for(k * n) - 1)]
    wsrc = rotating(copies)
    row["ms"] = cuda_ms(lambda: K.w8a8_token_matmul(x, wsrc()))
    row["dev_ms"] = device_ms(lambda: K.w8a8_token_matmul(x, wsrc()))
    K.w8a8_token_matmul.launches = before
    row["plain_ms"] = cuda_ms(lambda: K.w8a8_token_matmul_plain(x, lin), iters=3, warmup=1)

    def unfused():
        q, sq = dynamic_quantize_token_int8(x.float())
        return K.w8a8_matmul(q, sq, wsrc(), x.dtype)
    row["unfused_ms"] = cuda_ms(unfused)
    row["unfused_dev_ms"] = device_ms(unfused)
    K.w8a8_matmul.launches = before_gemm
    xq, _ = dynamic_quantize_token_int8(x.float())
    mp = max(m, INT_MM_MIN_ROWS)
    xp = torch.zeros((mp, k), dtype=torch.int8, device=x.device)
    xp[:m] = xq
    row["library_rows"] = mp
    row["library_ms"] = cuda_ms(lambda: torch._int_mm(xp, wsrc().weight))
    row["library_dev_ms"] = device_ms(lambda: torch._int_mm(xp, wsrc().weight))
    row.update(bound_int8(nbytes, 2 * m * k * n))
    return row


def w8a8_kernels(gen, detail) -> dict:
    """Phase 3, K10: the W8A8 linear with its quantizer inside at Qwen3-4B's
    seven projections and path I's fused ones at W8A8_ROWS rows (timed at
    W8A8_TIMED), the W8A8_OTHER shapes, f32 scales, f32 and f16 x, the
    edge rows (W8A8_EDGE); K10's GEMM alone on int8 codes at path I's
    served shapes, the W8A8_OTHER shapes and an f32 output; x and the codes
    at an unaligned base (the wrappers copy them; the C entry refuses an
    unaligned pointer)."""
    from quantizers_tpu_torch.core.numerics import dynamic_quantize_token_int8
    from quantizers_tpu_torch.ops import _build
    from quantizers_tpu_torch.ops import kernels as K

    rows = {f"{name}@m{m}": check_w8a8_token(gen, k, n, m, m in W8A8_TIMED)
            for m in W8A8_ROWS for name, (k, n) in {**QWEN3_PROJ, **QWEN3_SERVED}.items()}
    for m, k, n in W8A8_OTHER:
        rows[f"{m}x{k}x{n}"] = check_w8a8_token(gen, k, n, m, False)
    rows["f32_scales@m8"] = check_w8a8_token(gen, 2560, 4096, 8, False, scale_dtype=torch.float32)
    rows["f32_x@m8"] = check_w8a8_token(gen, 2560, 4096, 8, False, x_dtype=torch.float32)
    rows["f16_x@m40"] = check_w8a8_token(gen, 4096, 2560, 40, False, x_dtype=torch.float16)
    rows["f32_x@m512"] = check_w8a8_token(gen, 2560, 1024, 512, False, x_dtype=torch.float32)
    for m, k, n in W8A8_EDGE:
        rows[f"edge {m}x{k}x{n}"] = check_w8a8_token(gen, k, n, m, False, edge=True)
    gemm = {f"{name}@m{m}": check_w8a8(gen, k, n, m)
            for m in W8A8_TIMED for name, (k, n) in QWEN3_SERVED.items()}
    for m, k, n in W8A8_OTHER:
        gemm[f"{m}x{k}x{n}"] = check_w8a8(gen, k, n, m)
    gemm["f32_out@m512"] = check_w8a8(gen, 2560, 1024, 512, out_dtype=torch.float32)
    lin = w8a8_linear(gen, 2560, 4096)
    x = (torch.randn((8, 2560), device=gen.device, generator=gen) * 2).bfloat16()
    xq, sx = dynamic_quantize_token_int8(x.float())
    xo, xqo = offset_view(x), offset_view(xq)
    before, before_gemm = K.w8a8_token_matmul.launches, K.w8a8_matmul.launches
    same = bool(torch.equal(K.w8a8_token_matmul(xo, lin), K.w8a8_token_matmul(x, lin)))
    same_gemm = bool(torch.equal(K.w8a8_matmul(xqo, sx, lin), K.w8a8_matmul(xq, sx, lin)))
    check(xo.data_ptr() % 16 != 0 and same, "w8a8_token_matmul: a call on an offset view differs")
    check(xqo.data_ptr() % 16 != 0 and same_gemm, "w8a8_matmul: a call on an offset view differs")
    out = torch.empty((8, 4096), dtype=torch.bfloat16, device=gen.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load()
    err = lib.qtt_w8a8_matmul(None, lin.weight.data_ptr(), None, lin.scale.data_ptr(),
                              out.data_ptr(), xo.data_ptr(), 8, 2560, 4096, 0, 0, 4, stream)
    err_gemm = lib.qtt_w8a8_matmul(xqo.data_ptr(), lin.weight.data_ptr(), sx.data_ptr(),
                                   lin.scale.data_ptr(), out.data_ptr(), None, 8, 2560, 4096, 0, 0,
                                   1, stream)
    check(err != 0 and err_gemm != 0, "w8a8: the C entry took an unaligned pointer")
    K.w8a8_token_matmul.launches, K.w8a8_matmul.launches = before, before_gemm
    rows["offset_view"] = {"offset_bytes": xo.data_ptr() % 16, "equal": same,
                           "equal_gemm": same_gemm,
                           "c_entry_refusal": lib.qtt_error_string(err).decode()}
    for label, r in {**rows, **{f"gemm {k}": v for k, v in gemm.items()}}.items():
        log(f"[kernels] w8a8 {label}: {r}")
    detail["kernels"]["w8a8_token_matmul"] = rows
    detail["kernels"]["w8a8_matmul"] = gemm
    return {**rows, **{f"gemm {k}": v for k, v in gemm.items()}}


class BatchShapes:
    """The shapes of the batches ``do_oneshot`` makes while active (it
    imports ``make_batches`` from ``quantizers_tpu_torch.oneshot`` when it
    runs)."""

    def __enter__(self):
        import quantizers_tpu_torch.oneshot as O

        self.mod, self.orig, self.shapes = O, O.make_batches, []

        def recording(*a, **kw):
            batches = self.orig(*a, **kw)
            self.shapes.extend(tuple(ids.shape) for ids, _ in batches)
            return batches
        O.make_batches = recording
        return self

    def __exit__(self, *exc):
        self.mod.make_batches = self.orig
        return False


class W8A8Shapes:
    """The (m, K, N, scale dtype, activation dtype) of every call that
    ``dispatch`` routes to K10 while active (gathered over every entry)."""

    def __init__(self):
        self.shapes = set()

    def __enter__(self):
        from quantizers_tpu_torch.ops import dispatch as D

        self.mod, self.orig = D, D.w8a8_token_matmul

        def recording(x, lin):
            self.shapes.add((x.numel() // x.shape[-1], lin.in_features, lin.out_features,
                             lin.scale.dtype, x.dtype))
            return self.orig(x, lin)
        D.w8a8_token_matmul = recording
        return self

    def __exit__(self, *exc):
        self.mod.w8a8_token_matmul = self.orig
        return False


def calibration_launches(spec, shapes, forwards: int, matmul: str, every_m: bool,
                         linears: int = 7) -> dict:
    """The exact launches of a dense model's calibration: the flash kernel
    once a no-cache forward whose shape it takes (``forwards`` a layer and
    batch: 2 with a capture pass, the propagate alone 1), and ``matmul``
    (the quantized linears' kernel) on the propagate forward's ``linears``
    quantized projections a layer (7: all of them), at every row count
    (``every_m``: W8A8) or up to KERNEL_MAX_ROWS."""
    from quantizers_tpu_torch.ops import flash
    from quantizers_tpu_torch.ops.dispatch import KERNEL_MAX_ROWS

    def meta(B, H, T):
        return torch.empty((B, H, T, spec.head_dim), device="meta")

    flash_batches = sum(flash.flash_reason(meta(B, spec.num_heads, T),
                                           meta(B, spec.num_heads, T),
                                           meta(B, spec.num_heads, T)) is None
                        for B, T in shapes)
    matmul_batches = sum(every_m or B * T <= KERNEL_MAX_ROWS for B, T in shapes)
    return expect(**{"flash_attention": forwards * spec.num_layers * flash_batches,
                     matmul: linears * spec.num_layers * matmul_batches})


def oneshot_awq_phase(detail, tmp: Path, bf16: Path) -> None:
    """Path H: the first HI_LAYERS layers of path F's Qwen3-4B bf16
    checkpoint (``bf16``) through ``do_oneshot`` with recipe_awq_w4a16
    (AWQ, W4A16 g32) on the card: the stage seconds, the peak memory, 7
    records a layer, the exact K4 (capture and propagate) and K1
    (propagate) launches; then served (K1, K2, the int8 head on K3)."""
    from quantizers_tpu_torch.models import ModelSpec

    card = detail["device"]
    spec = ModelSpec(**dict(GEOMETRY, num_layers=HI_LAYERS))
    out = tmp / "qwen3_4b_awq_w4a16"
    with BatchShapes() as shapes:
        run = oneshot_cli("path H", write_run_config(tmp / "run_H.yaml", bf16, "recipe_awq_w4a16"),
                          out, tmp / "calibration_cache", card)
    want = calibration_launches(spec, shapes.shapes, 2, "w4_matmul", every_m=False)
    check(run["records"] == spec.num_layers * 7,
          f"path H: {run['records']} records, want {spec.num_layers * 7}")
    check(run["launches"] == want and want["w4_matmul"] > 0,
          f"path H: calibration launches {run['launches']} != {want}")
    qcfg = json.loads((out / "config.json").read_text())["quantization_config"]
    w = qcfg["config_groups"]["group_0"]["weights"]
    check((w["num_bits"], w["type"], w["strategy"], w["group_size"]) == (4, "int", "group", 32),
          f"path H: the checkpoint's scheme is {w}")
    torch.cuda.empty_cache()
    served = serve_output("path H", out, synthetic_text(),
                          (("decode_attention",), ("w8_matmul",), ("w4_matmul",)), card)
    detail["path_H"] = {"device": card, "batches": shapes.shapes, "oneshot": run,
                        "serve": served}
    shutil.rmtree(out)


def served_linears(params, matmul: str) -> int:
    """The linears of the first layer of a served params tree that
    ``matmul`` computes: W8A8 ones for K10, fp8 ones for K9."""
    from quantizers_tpu_torch.ops.dispatch import is_w8a8
    from quantizers_tpu_torch.ops.linear import QuantLinear

    takes = {"w8a8_token_matmul": is_w8a8, "fp8_matmul": lambda lin: lin.kind == "fp8"}[matmul]

    def walk(t):
        if isinstance(t, QuantLinear):
            return int(takes(t))
        return sum(walk(v) for v in t.values()) if isinstance(t, dict) else 0
    return walk(params["layers"][0])


def drive_served(label: str, ckpt: Path, steps: int, matmul: str = "w8a8_token_matmul",
                 device: str = "cuda") -> dict:
    """A W8A8 or FP8_BLOCK checkpoint as ``serve`` lays it out (int8 head):
    an 8 x 128 prefill, a 1 x 128 row prefill and ``steps`` greedy decode
    steps, each with exact launch counts: ``matmul`` on every linear of its
    kind (q|k|v and gate|up fused: 4 a layer), K10 at every row count and
    K9 up to KERNEL_MAX_ROWS rows, K3 for the head up to KERNEL_MAX_ROWS
    rows, K2 a layer at decode."""
    from quantizers_tpu_torch.models import KVCache
    from quantizers_tpu_torch.models.loader import load_compressed_model
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.ops.dispatch import KERNEL_MAX_ROWS
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    spec, params = load_compressed_model(ckpt, device=device)
    params = serving_layout(spec, params, head_bits=8, device=device)
    L, per = spec.num_layers, served_linears(params, matmul)
    check(per == 4, f"{label}: {per} linears a served layer on {matmul}, want 4 "
          "(q|k|v, o, gate|up, down)")
    ids = ((torch.arange(BATCH * PREFILL, device=device).reshape(BATCH, PREFILL) * 89 + 3)
           % spec.vocab_size)
    res = {"layers": L, "linears_per_layer": per, "matmul": matmul}
    for name, rows in (("row_prefill", 1), ("prefill", BATCH)):
        caches = KVCache.init(spec, rows, MAX_LEN, device=device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        last, caches = prefill(params, spec, ids[:rows], caches)
        torch.cuda.synchronize()
        res[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        kernel_rows = matmul == "w8a8_token_matmul" or rows * PREFILL <= KERNEL_MAX_ROWS
        want = expect(**{matmul: per * L * kernel_rows,
                         "w8_matmul": int(rows * PREFILL <= KERNEL_MAX_ROWS)})
        got = K.launch_counts()
        check(got == want, f"{label}: {name} launches {got} != {want}")
        res[f"{name}_launches"] = {k: v for k, v in got.items() if v}
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = _decode_scan(params, spec, caches, last.argmax(-1), None, steps=steps,
                           temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    got = K.launch_counts()
    want = expect(**{matmul: per * L * steps, "decode_attention": L * steps,
                     "w8_matmul": steps})
    check(got == want, f"{label}: decode launches {got} != {want}")
    check(bool(((toks >= 0) & (toks < spec.vocab_size)).all()), f"{label}: ids out of range")
    res.update(steps=steps, ms_per_step=dt * 1e3,
               launches_per_step={k: v // steps for k, v in got.items() if v},
               decode_launches=got)
    prof = device_profile(lambda: _decode_scan(params, spec, caches, toks[:, -1], None,
                                               steps=steps, temperature=0.0, top_k=0), steps)
    res.update({k: prof[k] for k in ("device_busy_ms_per_step", "idle_share", "top")})
    del params
    torch.cuda.empty_cache()
    return res


def oneshot_w8a8_phase(detail, tmp: Path, bf16: Path) -> dict:
    """Path I: path H's checkpoint through ``do_oneshot`` with
    recipe_w8a8_int8 (RTN int8 per channel, dynamic per-token int8
    activations): K10 on every propagate matmul and K4 in the exact counts;
    then ``cli/serve.main`` (K10, K2, K3) and the exact per-step drive;
    last, K10 against its plain version, bit for bit, at every shape and
    type the path gave it."""
    from quantizers_tpu_torch.models import ModelSpec

    card = detail["device"]
    spec = ModelSpec(**dict(GEOMETRY, num_layers=HI_LAYERS))
    out = tmp / "qwen3_4b_w8a8"
    with W8A8Shapes() as k10, BatchShapes() as shapes:
        run = oneshot_cli("path I", write_run_config(tmp / "run_I.yaml", bf16, "recipe_w8a8_int8"),
                          out, tmp / "calibration_cache", card)
    want = calibration_launches(spec, shapes.shapes, 1, "w8a8_token_matmul", every_m=True)
    check(run["records"] == spec.num_layers * 7,
          f"path I: {run['records']} records, want {spec.num_layers * 7}")
    check(run["launches"] == want, f"path I: calibration launches {run['launches']} != {want}")
    qcfg = json.loads((out / "config.json").read_text())["quantization_config"]
    act = qcfg["config_groups"]["group_0"]["input_activations"]
    check((act["num_bits"], act["strategy"], act["dynamic"]) == (8, "token", True),
          f"path I: the checkpoint's activations are {act}")
    torch.cuda.empty_cache()
    with k10:
        served = serve_output("path I", out, synthetic_text(),
                              (("decode_attention",), ("w8_matmul",), ("w8a8_token_matmul",)),
                              card)
        drive = drive_served("path I", out, SIDE_STEPS)
    log(f"[path I drive] ({card}) {drive}")
    shutil.rmtree(out)
    gen = torch.Generator(device="cuda").manual_seed(F_SEED)
    held = {f"{m}x{k}x{n} {sdt} {adt}":
            check_w8a8_token(gen, k, n, m, False, sdt, adt)["max_abs_err"]
            for m, k, n, sdt, adt in sorted(k10.shapes, key=str)}
    check({(m, k) for m, k, _, _, _ in k10.shapes} >= {(8, 2560), (128, 2560), (1024, 2560)},
          f"path I: K10's shapes {sorted(held)} lack the drive's")
    log(f"[path I] K10 bit for bit at the path's {len(held)} shapes: {sorted(held)}")
    detail["path_I"] = {"device": card, "batches": shapes.shapes, "oneshot": run,
                        "serve": served, "drive": drive, "k10_shapes_held": sorted(held)}
    return drive


#: phase 21, card against CPU. The two devices' calibration activations
#: agree only until the first attention (the card's K4 and cuBLAS round bf16
#: activations other than the CPU's plain path: 3% of layer 0's o_proj inputs
#: an ulp or more apart, most of layer 1's, on an H100), and AWQ's loss
#: moves by up to 1e-3 of itself when a scale moves by an ulp (a group's
#: absmax code sits on its rounding tie), by up to 1.8e-2 on activations an
#: ulp apart. So: where both devices see the same activations
#: (layer 0's first mapping, the normed embeddings), x_mean within
#: XMEAN_RTOL (f32 sums in another order) and SmoothQuant's codes equal;
#: every AWQ pick equal or within AWQ_TIE_RTOL of the CPU's least loss (the
#: picks were all equal on an H100); AWQ's codes within one step in the
#: layers before any pick differs, at most AWQ_CODE_SHARE of them apart: of
#: layer 0's (where only the attention's output differs; 0.022% and 0.017%
#: on an H100), of a later layer's (its inputs mostly an ulp apart; 0.37%);
#: and the CPU's quantized model on the card (K1 or K10) against the CPU's
#: plain path within LOGIT_RTOL (W8A8_LOGIT_RTOL for K10).
XMEAN_RTOL, AWQ_TIE_RTOL, AWQ_CODE_SHARE = 1e-6, 1e-5, (1e-3, 8e-3)
#: the W8A8 model's forward on one set of weights: where the two devices'
#: bf16 activations differ by an ulp, a dynamic int8 activation code moves
#: by a whole step (1/127.5 of its row's absmax), so its logits move by
#: 3.0% of the largest |logit| (error norm 3.1% on an H100) against the
#: W4A16 model's 0.8%. The limits are twice that, and a greedy token may
#: differ where the CPU's top two logits lie within the same fraction. The
#: card's forward with K10's plain version in its place gives the same
#: logits to the bit (checked): the error is the activations', not K10's
W8A8_LOGIT_RTOL = 6e-2


@contextlib.contextmanager
def awq_searches():
    """Every AWQ search of the port while active, in order: x_mean, the
    losses of the candidate scales, the scale."""
    from quantizers_tpu_torch.oneshot import awq

    log_, losses_fn, scale_fn = [], awq._search_losses, awq._search_scale

    def losses(*a, **kw):
        out = losses_fn(*a, **kw)
        log_[-1]["losses"] = out.double().cpu().numpy()
        return out

    def scale(x_rows, x_mean, *a, **kw):
        log_.append({"x_mean": np.asarray(x_mean, np.float32)})
        log_[-1]["scale"] = s = scale_fn(x_rows, x_mean, *a, **kw)
        return s
    awq._search_losses, awq._search_scale = losses, scale
    try:
        yield log_
    finally:
        awq._search_losses, awq._search_scale = losses_fn, scale_fn


def logits_apart(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``got``'s logits lie from ``ref``'s (reported, not checked)."""
    d = got - ref
    return {"max_abs_err": d.abs().max().item(), "max_abs_logit": ref.abs().max().item(),
            "max_rel_norm_err": (d.norm(dim=-1) / ref.norm(dim=-1)).max().item()}


def searches_agree(label: str, got: list, ref: list, layers: int, same_first: bool) -> dict:
    """The card's AWQ searches against the CPU's (``ref``), in order, with
    ``same_first`` where both devices' first mapping sees the same
    activations (its smooth layer is layer 0's input norm); returns the
    first layer with a pick that differs (``first_layer_apart``, None:
    none) and the largest differences."""
    check(len(got) == len(ref) and ref and len(ref) % layers == 0,
          f"{label}: searches {len(got)} / {len(ref)}")
    per_layer = len(ref) // layers
    picks, gaps, xmean, loss_err, first = [], [], [], 0.0, None
    for i, (g, r) in enumerate(zip(got, ref)):
        bg, br = int(np.argmin(g["losses"])), int(np.argmin(r["losses"]))
        picks.append([br, bg])
        gaps.append(float((r["losses"][bg] - r["losses"][br]) / r["losses"][br]))
        xmean.append(float(np.max(np.abs(g["x_mean"] - r["x_mean"]) / np.abs(r["x_mean"]))))
        loss_err = max(loss_err, float(np.max(np.abs(g["losses"] - r["losses"]) / r["losses"])))
        if bg != br and first is None:
            first = i // per_layer
    row = {"mappings": len(ref), "picks_cpu_card": picks,
           "picks_differing": sum(a != b for a, b in picks), "worst_tie_gap": max(gaps),
           "tie_rtol": AWQ_TIE_RTOL, "x_mean_rel_err": xmean, "x_mean_rtol_first": XMEAN_RTOL,
           "max_loss_rel_err": loss_err, "first_layer_apart": first}
    check(max(gaps) <= AWQ_TIE_RTOL, f"{label}: a pick differs by {max(gaps):.3g} of the loss")
    check(not same_first or xmean[0] <= XMEAN_RTOL,
          f"{label}: layer 0's first x_mean differs by {xmean[0]:.3g}")
    return row


def int_codes_agree(label: str, got: dict, ref: dict, n_records: int, exact=(),
                    one_step=lambda key: True, share=lambda layer: 1.0) -> dict:
    """Integer codes of the card's records against the CPU's: equal for the
    keys in ``exact``, within one step where ``one_step(key)``, at most
    ``share(layer)`` of a layer's apart; the counts apart (in all and by
    layer) and the scales' largest relative error."""
    check(sorted(got) == sorted(ref) and len(got) == n_records,
          f"{label}: records {len(got)} / {len(ref)}, want {n_records}")
    cells = differing = steps = 0
    scale_err, by_layer = 0.0, {}
    for k, qt in got.items():
        d = (qt.values.int() - ref[k].values.int()).abs()
        cells, differing = cells + d.numel(), differing + int((d > 0).sum())
        layer = by_layer.setdefault(int(k.split(".")[2]), [0, 0])
        layer[0], layer[1] = layer[0] + int((d > 0).sum()), layer[1] + d.numel()
        steps = max(steps, int(d.max()))
        a, b = qt.scale.float(), ref[k].scale.float()
        scale_err = max(scale_err, ((a - b).abs() / b.abs()).max().item())
        check(k not in exact or (int(d.max()) == 0 and torch.equal(a, b)),
              f"{label}: {k} differs where both devices saw the same activations")
        check(not one_step(k) or int(d.max()) <= 1, f"{label}: {k} codes {int(d.max())} steps apart")
    for i, (a, b) in sorted(by_layer.items()):
        check(a <= share(i) * b, f"{label}: layer {i}: {a} of {b} codes apart, over {share(i)}")
    return {"records": len(got), "cells": cells, "differing": differing,
            "share": differing / cells,
            "share_by_layer": {i: a / b for i, (a, b) in sorted(by_layer.items())},
            "share_max_by_layer": {i: share(i) for i in sorted(by_layer)},
            "max_steps": steps, "max_scale_rel_err": scale_err, "exact": sorted(exact)}


def card_vs_cpu_slice7(detail, tmp: Path, dense: Path, moe: Path,
                       devices=("cuda", "cpu")) -> None:
    """Phase 21: ``oneshot`` on both devices over phase 18's calibration
    batches: recipe_awq_w4a16 and SmoothQuant + recipe_w8a8_int8 on the
    first 2 layers of path F's model, recipe_minimax_experts_only_awq on the
    first layer of path G's: the searches and the codes; then the CPU's
    quantized model on the card (K1, K10) against the CPU's plain path, and
    the two devices' own quantized models' logits (reported)."""
    import yaml

    batches, ids, one_row = comparison_batches(tmp)
    sq_w8a8 = yaml.safe_load((ROOT / "configs" / "recipes" / "recipe_w8a8_int8.yaml").read_text())
    mods = sq_w8a8["quant_stage"]["quant_modifiers"]
    sq_w8a8["quant_stage"]["quant_modifiers"] = {
        "SmoothQuantModifier": {"smoothing_strength": 0.5}, **mods}
    row = {"device": detail["device"], "batches": [list(b[0].shape) for b in batches]}
    detail["card_vs_cpu_slice7"] = row
    # layer 0 q and k: folded once, by the first mapping (v is folded again by
    # the v -> o mapping, whose activations differ)
    qk0 = ("model.layers.0.self_attn.q_proj", "model.layers.0.self_attn.k_proj")
    E = MOE_GEOMETRY["num_experts"]
    # (label, recipe name, recipe override, checkpoint, layers, records a
    # layer, batches, the cross forward's kernel)
    cases = (("awq_w4a16", "recipe_awq_w4a16", None, dense, 2, 7, batches, "w4_matmul"),
             ("smoothquant_w8a8", "recipe_w8a8_int8", sq_w8a8, dense, 2, 7, batches,
              "w8a8_token_matmul"),
             ("minimax_experts_only_awq", "recipe_minimax_experts_only_awq", None, moe, 1, 3 * E,
              one_row, "w4_matmul"))
    for name, recipe_name, recipe, ckpt, layers, per_layer, bs, kernel in cases:
        label = f"card vs CPU {name}"
        res = engine_on_both(ckpt, recipe_name, bs, ids, devices, recipe=recipe, cross=True,
                             plain_k10=kernel == "w8a8_token_matmul", record="awq")
        got, ref = (res[d] for d in devices)
        r = {"layers": layers, "seconds": {d: res[d]["s"] for d in devices},
             "flash_launches_card": got["flash"], "cross_launches_card": got["cross_launches"]}
        if ref["log"]:  # AWQ
            r["awq"] = searches_agree(label, got["log"], ref["log"], layers,
                                      same_first=recipe_name == "recipe_awq_w4a16")
            first = r["awq"]["first_layer_apart"]
            r["codes"] = int_codes_agree(
                label, got["records"], ref["records"], layers * per_layer,
                one_step=lambda k: first is None or int(k.split(".")[2]) < first,
                share=lambda layer: AWQ_CODE_SHARE[min(layer, 1)])
        else:  # SmoothQuant: layer 0's q and k fold saw the same activations
            r["codes"] = int_codes_agree(label, got["records"], ref["records"],
                                         layers * per_layer, exact=qk0,
                                         one_step=lambda k: False)
        check(got["flash"] > 0, f"{label}: the flash kernel never ran in calibration")
        check(got["cross_launches"][kernel] > 0, f"{label}: the card's forward never ran {kernel}")
        r.update(routes_agree(label, got["cross_routes"], ref["routes"]))
        lim = (dict(rtol=W8A8_LOGIT_RTOL, norm_rtol=W8A8_LOGIT_RTOL, tie_rtol=W8A8_LOGIT_RTOL)
               if kernel == "w8a8_token_matmul" else {})
        r["logits"] = logits_agree(label, got["cross_logits"], ref["logits"], **lim)
        if "cross_plain_k10_logits" in got:
            r["logits_k10_plain"] = logits_apart(got["cross_plain_k10_logits"], ref["logits"])
            check(torch.equal(got["cross_plain_k10_logits"], got["cross_logits"]),
                  f"{label}: the card's logits with K10's plain version differ from K10's")
        r["own_models_logits"] = logits_apart(got["logits"], ref["logits"])
        row[name] = r
        log(f"[{label}] {r}")
        del res, got, ref


# ---------------------------------------------------------------------------
# slice 7d: K11, GPTQ's column elimination (phase 3), path J from path F's
# bf16 checkpoint (phase 22), and card against CPU (phase 23)
# ---------------------------------------------------------------------------

#: H100 SXM f32 rate outside the tensor cores (NVIDIA data sheet), FLOP/s
F32_FLOPS = 67e12
#: GPTQ's block of columns (the recipes' block_size), K11's widest
GPTQ_BLOCK = 128
#: K11's shapes on path J: Qwen3-4B's projections as (N, K), one solve each
GPTQ_SHAPES = {name: (n, k) for name, (k, n) in QWEN3_PROJ.items()}
#: K11 launches a Qwen3-4B layer: ceil(K / 128) for each of its projections
GPTQ_BLOCKS_PER_LAYER = sum(-(-k // GPTQ_BLOCK) for k, _ in QWEN3_PROJ.values())
#: K11's row counts timed in phase 3: path J's (Qwen3-4B's projections)
#: and Qwen3-30B-A3B's behind phase 23's 4,944 launches a layer: k and v
#: (512), an expert's gate and up (768), o_proj and an expert's down (2048)
GPTQ_TIMED_N = sorted({n for n, _ in GPTQ_SHAPES.values()} | {512, 768, 2048})
#: (N, K, symmetric, group, actorder) beyond path J's symmetric g32: the
#: repository recipe's asymmetric g128 with actorder group, actorder weight,
#: asymmetric g32, K not a multiple of 128 (padded), a block under 128, a
#: block width that is not a multiple of 4 (padded by the wrapper)
GPTQ_OTHER = ((1024, 2560, False, 128, "group"), (2560, 9728, False, 128, "group"),
              (4096, 2560, False, 32, None), (1024, 4096, True, 128, "weight"),
              (1024, 2600, False, 32, "group"), (256, 96, True, 32, None), (64, 50, False, 32, None))
#: path J's second recipe, written by this script: GPTQ W4A16 symmetric g32
#: with no actorder (path H's scheme: K1 serves it)
GPTQ_G32 = {"quant_stage": {"quant_modifiers": {"GPTQModifier": {
    "dampening_frac": 0.01, "block_size": GPTQ_BLOCK, "ignore": ["lm_head"],
    "config_groups": {"group_0": {"targets": ["Linear"], "weights": {
        "num_bits": 4, "type": "int", "symmetric": True, "strategy": "group",
        "group_size": 32}}}}}}}
#: phase 23, card against CPU. The devices' calibration inputs agree only
#: at layer 0's q, k and v, and even there their Hessians differ by the
#: sums' order (1.3e-6 of the largest entry on an H100; up to 3e-3
#: elsewhere); GPTQ's solution is flat along the near-null directions of
#: its Hessian (at most 2,048 calibration tokens against K 2560-9728,
#: damped by 1% of its mean diagonal), so a Hessian a rounding apart moves
#: codes by several steps while the objective it minimizes,
#: tr((W - W^) H (W - W^)^T), moves little. ``gptq_decomposed`` measures
#: that on one device, the witness: the card solves each of its own
#: problems again GPTQ_WITNESS_DRAWS times, each with every Hessian entry
#: moved by one f32 ulp (about 1.2e-7); and it has the card solve each of
#: the CPU's problems (its W and H) again. Per layer, each site's objective,
#: on the CPU's problem and on each device's own, must lie within a share
#: of the CPU's: the larger of GPTQ_OBJ_RTOL and GPTQ_WITNESS_FACTOR times
#: the witness's largest spread in that layer; on the CPU's problem the
#: permutation must be the CPU's and the codes apart at most
#: GPTQ_WITNESS_FACTOR times the witness's share (over all its draws); each
#: device's own codes (for a recipe with
#: no actorder: with actorder the devices' groups differ wherever their
#: diagonals' orders do) at most GPTQ_CODE_SHARE of layer 0's and of layer
#: 1's apart (8.6% and 14.4% on an H100); and every objective below
#: RTN's on the same H on both devices
GPTQ_OBJ_RTOL = 1e-2
#: the card re-solving the CPU's own problems (its W and H): GPTQ's factor
#: is taken in f64 and rounded to f32 on both devices, so the two factors
#: part only in 0.007-0.02% of their entries, and the card's
#: objectives lie at most 1.2e-4 from the CPU's on an H100 (with f32
#: factors: up to 1.83%, at one site of path F's model); each within
#: GPTQ_SAME_H_RTOL of the CPU's, below both that witness-based limit and
#: what an f32 factor gives
GPTQ_SAME_H_RTOL = 1e-3
GPTQ_WITNESS_DRAWS = 3
GPTQ_WITNESS_FACTOR = 2.0
GPTQ_CODE_SHARE = (0.2, 0.3)


def gptq_args(sym: bool, g: int, actorder):
    from quantizers_tpu_torch.core.scheme import QuantizationArgs

    return QuantizationArgs.from_dict({"num_bits": 4, "type": "int", "symmetric": sym,
                                       "strategy": "group", "group_size": g,
                                       "actorder": actorder})


def gptq_problem(gen, n: int, k: int):
    """A weight (N, K) and a Hessian 2 X^T X of seeded activations, every
    third input channel 10x louder (as the JAX package's GPTQ tests make
    them), on the generator's device."""
    dev = gen.device
    w = torch.randn((n, k), device=dev, generator=gen) * 0.02
    x = torch.randn((min(2 * k, 4096), k), device=dev, generator=gen)
    x[:, ::3] *= 10.0
    return w, 2.0 * (x.t() @ x)


def check_gptq(gen, n: int, k: int, sym: bool = True, g: int = 32, actorder=None) -> dict:
    """K11 against its plain version on the card through a whole solve:
    ``gptq_quantize`` at (N, K), its ``_gptq_solve`` (K11 for every block)
    recorded, then ``gptq_solve_plain`` on the same inputs: the codes equal
    bit for bit (a block's Err differing anywhere would move the later
    blocks' codes), and a second K11 solve the same."""
    from quantizers_tpu_torch.oneshot import gptq as TG
    from quantizers_tpu_torch.ops import kernels as K

    w, H = gptq_problem(gen, n, k)
    solves, orig = [], TG._gptq_solve

    def recording(*a, **kw):
        q = orig(*a, **kw)
        solves.append((a, kw, q))
        return q
    before = K.gptq_block.launches
    TG._gptq_solve = recording
    try:
        _, g_idx = TG.gptq_quantize(w, H, gptq_args(sym, g, actorder), GPTQ_BLOCK)
    finally:
        TG._gptq_solve = orig
    (a, kw, got), = solves
    ref = TG.gptq_solve_plain(*a, **kw)
    again = orig(*a, **kw)
    torch.cuda.synchronize()
    blocks = a[0].shape[1] // kw["block_size"]
    label = f"gptq_block {n}x{k} {'sym' if sym else 'asym'} g{g} {actorder}"
    check(K.gptq_block.launches == before + 2 * blocks, f"{label}: launches not counted")
    K.gptq_block.launches = before  # checks are not main-path launches
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite codes")
    check(bool(torch.equal(got, ref)),
          f"{label}: {int((got != ref).sum())} codes differ from the plain version")
    check(bool(torch.equal(again, got)), f"{label}: differs from run to run")
    return {"n": n, "k": k, "symmetric": sym, "group": g, "actorder": actorder,
            "blocks": blocks, "g_idx": g_idx is not None,
            "max_abs_err": (got - ref).abs().max().item(), "tol": 0.0}


def gptq_block_bound(n: int, bs: int, g: int) -> dict:
    """The least time of one symmetric K11 launch: W read (f32), the codes
    written at the width ``gptq_quantize`` keeps them (int8: the grid
    values lie in [qmin, qmax]) and Err written (f32, the tail product
    reads it), U's block, the column groups and the groups' scales read
    once, against its f32 operations (N (bs (bs - 1) + 8 bs): the updates'
    multiply and subtract, each column's snap and error), over the f32 rate
    outside the tensor cores."""
    groups = -(-bs // g)
    nbytes = 9 * n * bs + 4 * bs * bs + 4 * bs + 4 * n * groups
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n * (bs * (bs - 1) + 8 * bs) / F32_FLOPS
    return {"bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_gptq_block(gen, n: int, g: int = 32) -> dict:
    """One K11 launch at N rows and a 128-column block (path J's symmetric
    g32), its Q and Err bit for bit against the plain version's, then its
    time and device time as a solve launches it (``gptq_block_launcher`` on
    operands converted once), the plain version's and the bound. The
    weights rotate through copies, as a solve meets each block once."""
    from quantizers_tpu_torch.oneshot import gptq as TG
    from quantizers_tpu_torch.ops import kernels as K

    args = gptq_args(True, g, None)
    w, H = gptq_problem(gen, n, GPTQ_BLOCK)
    u = TG._ufactor(H, 0.01)
    scale, _, _ = TG._solve_qparams(w, args)
    cg = (torch.arange(GPTQ_BLOCK, device=w.device) // g).to(torch.int32)
    qmin, qmax = args.qrange
    before = K.gptq_block.launches
    q, err = K.gptq_block(w, u, scale, None, cg, qmin, qmax)
    q_ref, err_ref = K.gptq_block_plain(w, u, scale, None, cg, qmin, qmax)
    torch.cuda.synchronize()
    label = f"gptq_block {n}x{GPTQ_BLOCK} g{g}"
    check(bool(torch.equal(q, q_ref)) and bool(torch.equal(err, err_ref)),
          f"{label}: Q or Err differ from the plain version")
    copies = [w] + [w.clone() for _ in range(copies_for(12 * n * GPTQ_BLOCK) - 1)]
    wsrc = rotating(copies)
    launch, ops = K.gptq_block_launcher(w.device), K.gptq_operands(w.device, scale, None, cg)
    row = {"n": n, "bs": GPTQ_BLOCK, "group": g,
           "max_abs_err": max((q - q_ref).abs().max().item(), (err - err_ref).abs().max().item()),
           "tol": 0.0,
           "ms": cuda_ms(lambda: launch(wsrc(), u, *ops, qmin, qmax)),
           "dev_ms": device_ms(lambda: launch(wsrc(), u, *ops, qmin, qmax)),
           "plain_ms": cuda_ms(lambda: K.gptq_block_plain(w, u, scale, None, cg, qmin, qmax),
                               iters=3, warmup=1),
           "library_ms": None, **gptq_block_bound(n, GPTQ_BLOCK, g)}
    K.gptq_block.launches = before
    return row


def gptq_kernels(gen, detail) -> dict:
    """Phase 3, K11: a whole solve bit for bit against the plain version at
    each of path J's shapes (symmetric g32) and the GPTQ_OTHER cases; one
    launch timed at each row count of GPTQ_TIMED_N; the wrapper on a W block
    at an unaligned base (it copies it) and the C entry's refusal of it."""
    from quantizers_tpu_torch.ops import _build
    from quantizers_tpu_torch.ops import kernels as K

    rows = {f"{name} {n}x{k}": check_gptq(gen, n, k) for name, (n, k) in GPTQ_SHAPES.items()}
    for n, k, sym, g, actorder in GPTQ_OTHER:
        rows[f"{n}x{k} {'sym' if sym else 'asym'} g{g} {actorder}"] = check_gptq(
            gen, n, k, sym, g, actorder)
    for n in GPTQ_TIMED_N:
        rows[f"block@n{n}"] = time_gptq_block(gen, n)
    w = torch.randn((64, GPTQ_BLOCK), device=gen.device, generator=gen)
    u = torch.eye(GPTQ_BLOCK, device=gen.device) + torch.triu(
        torch.rand((GPTQ_BLOCK, GPTQ_BLOCK), device=gen.device, generator=gen), 1) * 0.1
    scale = torch.rand((64, 4), device=gen.device, generator=gen) * 0.5 + 0.1
    cg = (torch.arange(GPTQ_BLOCK, device=gen.device) // 32).to(torch.int32)
    wo = offset_view(w)
    before = K.gptq_block.launches
    a, b = K.gptq_block(wo, u, scale, None, cg, -8.0, 7.0), K.gptq_block(w, u, scale, None, cg,
                                                                         -8.0, 7.0)
    same = bool(torch.equal(a[0], b[0])) and bool(torch.equal(a[1], b[1]))
    check(wo.data_ptr() % 16 != 0 and same, "gptq_block: a call on an offset view differs")
    q, e = torch.empty_like(w), torch.empty_like(w)
    err = _build.load().qtt_gptq_block(
        wo.data_ptr(), GPTQ_BLOCK, u.data_ptr(), GPTQ_BLOCK, scale.data_ptr(), None, 4,
        cg.data_ptr(), q.data_ptr(), e.data_ptr(), 64, GPTQ_BLOCK, -8.0, 7.0,
        torch.cuda.get_device_properties(0).multi_processor_count,
        torch.cuda.current_stream().cuda_stream)
    check(err != 0, "gptq_block: the C entry took an unaligned pointer")
    K.gptq_block.launches = before
    rows["offset_view"] = {"offset_bytes": wo.data_ptr() % 16, "equal": same,
                           "c_entry_refusal": _build.load().qtt_error_string(err).decode()}
    for label, r in rows.items():
        log(f"[kernels] gptq_block {label}: {r}")
    detail["kernels"]["gptq_block"] = rows
    return rows


class K11LayerTrace:
    """One layer's GPTQ solves of a ``do_oneshot`` run, measured in that run:
    the 7 ``_gptq_solve`` calls of layer ``layer`` (q, k, v, o, gate, up,
    down) run under torch.profiler (started after the layer before's last
    solve, so that its calibration forwards come first), each K11 launch
    between two CUDA events, and their inputs and codes kept. ``replay`` then solves them
    again with K11's plain version on the card, each plain block between
    two events, and holds the codes bit for bit against the run's. Its
    ``row``: the layer's K11 launches in the trace, their device time
    (``dev_ms``), their event time (``ms``), the plain blocks' (``plain_ms``)
    and the launches' summed bound."""

    def __init__(self, layer: int, per_layer: int = 7):
        assert layer >= 1, "the trace starts after the layer before's last solve"
        self.first, self.last = layer * per_layer, layer * per_layer + per_layer - 1
        self.layer = layer

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from quantizers_tpu_torch.oneshot import gptq as TG

        self.TG, self.orig, self.calls, self.solves, self.events = TG, TG._gptq_solve, 0, [], []

        def timed(*b):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.block(*b)
            e.record()
            self.events.append((s, e))
            return out

        def solve(*a, **kw):
            i, self.calls = self.calls, self.calls + 1
            if not self.first <= i <= self.last:
                q = self.orig(*a, **kw)
                if i == self.first - 1:  # trace from here: a trace can lose its first
                    torch.cuda.synchronize()  # kernels, and no K11 launch comes before first
                    self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    self.prof.__enter__()
                return q
            if i == self.first:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            self.block, *ops = TG._block_route(*a, kw["block_size"], kw["sym"])
            q = TG._eliminate(timed, *a[:2], *ops, kw["block_size"], kw["qmin"], kw["qmax"],
                              kw["sym"])
            self.solves.append((a, kw, q))
            if i == self.last:
                torch.cuda.synchronize()
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.__exit__(None, None, None)
            return q
        TG._gptq_solve = solve
        return self

    def __exit__(self, *exc):
        self.TG._gptq_solve = self.orig
        return False

    def replay(self) -> dict:
        from torch.autograd import DeviceType

        from quantizers_tpu_torch.ops import kernels as K

        check(len(self.solves) == self.last - self.first + 1,
              f"K11 trace: {len(self.solves)} solves of layer {self.layer} recorded")
        launches, dev_us = 0, 0.0
        for e in self.prof.key_averages():
            if e.device_type == DeviceType.CUDA and "gptq_block_kernel" in e.key:
                launches += e.count
                dev_us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        plain, bound = [], 0.0

        def timed_plain(*b):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = K.gptq_block_plain(*b)
            e.record()
            plain.append((s, e))
            return out
        apart = 0
        for a, kw, q in self.solves:
            ref = self.TG._eliminate(timed_plain, *a, kw["block_size"], kw["qmin"], kw["qmax"],
                                     kw["sym"])
            apart += int((ref != q).sum())
            n, k = a[0].shape
            bound += k // kw["block_size"] * gptq_block_bound(n, kw["block_size"], 32)["bound_ms"]
        torch.cuda.synchronize()
        want = sum(a[0].shape[1] // kw["block_size"] for a, kw, _ in self.solves)
        row = {"layer": self.layer, "launches": launches, "launches_want": want,
               "events": len(self.events), "dev_ms": dev_us / 1e3, "ms": ms,
               "plain_ms": sum(s.elapsed_time(e) for s, e in plain), "bound_ms": bound,
               "solve_wall_ms": self.wall_ms, "codes_apart_from_plain": apart}
        log(f"[path J] K11 layer {self.layer} trace: {row}")
        check(launches == want == len(self.events),
              f"K11 trace: {launches} launches in the trace, {len(self.events)} timed, want {want}")
        check(apart == 0, f"K11 trace: {apart} codes of layer {self.layer} differ from the plain "
              "version's on the same inputs")
        self.solves = []
        return row


def oneshot_gptq_phase(detail, tmp: Path, bf16: Path) -> None:
    """Path J: path F's Qwen3-4B bf16 checkpoint (F_LAYERS deep) through
    ``do_oneshot`` on the card with the repository's GPTQ recipe (W4A16
    g128 asymmetric, actorder group) and with GPTQ_G32: the stage seconds,
    the peak memory, 7 records a layer (with ``weight_g_idx`` for the first), the
    exact K4 and K11 launches (and K1's on the g32 propagate), no host
    factor; then ``cli/serve.main`` on each (the g32 one through K1, K2 and
    K3; the asymmetric one through the reference path, K2 and K3). The g32
    run's layer 1 is traced (``K11LayerTrace``): K11's numbers in the
    kernels line."""
    import yaml

    from quantizers_tpu_torch.formats.checkpoint import CompressedModelReader
    from quantizers_tpu_torch.models import ModelSpec
    from quantizers_tpu_torch.oneshot import gptq as TG

    card = detail["device"]
    spec = ModelSpec(**dict(GEOMETRY, num_layers=F_LAYERS))
    g32 = tmp / "recipe_gptq_w4a16_g32.yaml"
    g32.write_text(yaml.safe_dump(GPTQ_G32))
    row = {"device": card, "k11_launches_per_layer": GPTQ_BLOCKS_PER_LAYER}
    detail["path_J"] = row
    for label, recipe, sym in (("gptq_w4a16_g128", "recipe_gptq_w4a16_g128", False),
                               ("gptq_w4a16_g32", g32, True)):
        out = tmp / f"qwen3_4b_{label}"
        fallbacks = TG.host_factor_fallbacks
        with BatchShapes() as shapes, \
                (K11LayerTrace(1) if sym else contextlib.nullcontext()) as trace:
            run = oneshot_cli(f"path J {label}",
                              write_run_config(tmp / f"run_J_{label}.yaml", bf16, recipe),
                              out, tmp / "calibration_cache", card)
        want = calibration_launches(spec, shapes.shapes, 2, "w4_matmul", every_m=False)
        if not sym:  # K1 takes symmetric w4 only: the propagate dequantizes
            want["w4_matmul"] = 0
        want["gptq_block"] = GPTQ_BLOCKS_PER_LAYER * spec.num_layers
        check(run["records"] == spec.num_layers * 7,
              f"path J {label}: {run['records']} records, want {spec.num_layers * 7}")
        check(run["launches"] == want, f"path J {label}: calibration launches "
              f"{run['launches']} != {want}")
        check(TG.host_factor_fallbacks == fallbacks,
              f"path J {label}: {TG.host_factor_fallbacks - fallbacks} host factors")
        w = json.loads((out / "config.json").read_text())["quantization_config"][
            "config_groups"]["group_0"]["weights"]
        check((w["symmetric"], w["group_size"], w.get("actorder")) ==
              (sym, 32 if sym else 128, None if sym else "group"),
              f"path J {label}: the checkpoint's scheme is {w}")
        with CompressedModelReader(out) as r:
            quant = r.quantized_modules()
            with_g_idx = sum(r.g_idx(p) is not None for p in quant)
        check(len(quant) == spec.num_layers * 7 and with_g_idx == (0 if sym else len(quant)),
              f"path J {label}: {with_g_idx} of {len(quant)} records with weight_g_idx")
        torch.cuda.empty_cache()
        served = serve_output(f"path J {label}", out, synthetic_text(),
                              (("decode_attention",), ("w8_matmul",))
                              + ((("w4_matmul",),) if sym else ()), card)
        row[label] = {"batches": shapes.shapes, "oneshot": run, "weight_g_idx": with_g_idx,
                      "host_factor_fallbacks": TG.host_factor_fallbacks - fallbacks,
                      "serve": served}
        if trace is not None:  # after the counts and the serve run
            check(trace.calls == spec.num_layers * 7, f"path J {label}: {trace.calls} solves")
            row[label]["k11_layer"] = trace.replay()
        shutil.rmtree(out)


@contextlib.contextmanager
def gptq_sites():
    """Every ``gptq_quantize`` call of the port while active, in order, as
    made: W (as bf16 where that holds it exactly), H, the arguments, the
    codes and g_idx (``site_objectives`` turns one into numbers)."""
    from quantizers_tpu_torch.oneshot import gptq as TG

    log_, orig = [], TG.gptq_quantize

    def recording(w, H, args, block_size=128, dampening_frac=0.01, **kw):
        qt, g_idx = orig(w, H, args, block_size, dampening_frac, **kw)
        wb = w.bfloat16()
        log_.append({"device": w.device.type, "w": wb if torch.equal(wb.float(), w) else w,
                     "H": H, "args": args, "block_size": block_size, "damp": dampening_frac,
                     "qt": qt, "g_idx": g_idx})
        return qt, g_idx
    TG.gptq_quantize = recording
    try:
        yield log_
    finally:
        TG.gptq_quantize = orig


def site_objectives(site: dict, qt=None, g_idx=None, rtn: bool = True) -> dict:
    """A ``gptq_sites`` entry's GPTQ objective tr((W - W^) H (W - W^)^T),
    W^ read by g_idx where there is one (the weights GPTQ solved), or that
    of ``qt`` / ``g_idx`` on the entry's W and H; with ``rtn`` the RTN
    objective on the same H and the Hessian diagonal's descending order
    (the actorder permutation, dead channels pinned). In f64 on the card,
    where there is one."""
    from quantizers_tpu_torch.core.numerics import fake_quantize

    if qt is None:
        qt, g_idx = site["qt"], site["g_idx"]
    args = site["args"]
    dev = torch.device("cuda") if torch.cuda.is_available() else site["H"].device
    w, H = site["w"].to(dev, torch.float32), site["H"].to(dev, torch.float64)
    k = w.shape[1]
    cols = (torch.arange(k, device=dev) // (args.group_size or k) if g_idx is None
            else g_idx.to(dev).long())
    q = qt.values.to(dev).float()
    if qt.zero_point is not None:
        q = q - qt.zero_point.to(dev).float()[:, cols]

    def objective(what):
        d = (w - what).double()
        return float(((d @ H) * d).sum())
    out = {"gptq": objective(q * qt.scale.to(dev).float()[:, cols])}
    if rtn:
        diag = torch.diagonal(H)
        diag = torch.where(diag == 0, torch.ones_like(diag), diag)
        out.update(rtn=objective(fake_quantize(w, args)),
                   order=torch.argsort(-diag, stable=True).cpu())
    return out


def codes_apart(a, b) -> tuple:
    """Two solves' integer codes: the cells apart, all cells, the most steps."""
    d = (a.values.to(b.values.device).int() - b.values.int()).abs()
    return int((d > 0).sum()), d.numel(), int(d.max())


def one_ulp_apart(H: torch.Tensor, gen) -> torch.Tensor:
    """H with each entry moved by one f32 ulp up or down, or left (about
    1.2e-7 of it), symmetrically."""
    r = torch.randint(-1, 2, H.shape, device=H.device, generator=gen).float()
    r = torch.triu(r) + torch.triu(r, 1).t()
    return H * (1.0 + r * 2.0 ** -23)


def gptq_decomposed(label: str, got: list, ref: list, dev, per_layer: int = 7) -> dict:
    """Phase 23's sites taken apart, on ``dev`` (the card), per layer: the
    witness (each of its own problems, ``got``, solved again with H moved
    by one f32 ulp an entry, GPTQ_WITNESS_DRAWS draws: what a rounding of H
    alone moves on one device) and ``same_h`` (each of the CPU's problems,
    ``ref``: its W and H, solved again: what the devices' solves alone
    move), each with the codes apart (share, most steps) and the
    objectives' relative spread; the devices' Hessians' largest difference
    (of the CPU's largest entry); and the layer's objective limit
    (``objective_limit``: the larger of GPTQ_OBJ_RTOL and
    GPTQ_WITNESS_FACTOR times the witness's largest spread). Checks the
    ``same_h`` solves against the limits (their objectives within
    GPTQ_SAME_H_RTOL too); its solves are not main-path
    launches, so K11's count is left as it was."""
    from quantizers_tpu_torch.oneshot import gptq as TG
    from quantizers_tpu_torch.ops import kernels as K

    before, gen = K.gptq_block.launches, torch.Generator(device=dev).manual_seed(23)
    layers, gidx_apart = {}, []
    for i, (g, r) in enumerate(zip(got, ref)):
        row = layers.setdefault(i // per_layer, {
            key: {"apart": 0, "cells": 0, "max_steps": 0, "objective_rel": []}
            for key in ("same_h", "witness")} | {"h_rel_apart": []})
        base = {"same_h": site_objectives(r, rtn=False)["gptq"],
                "witness": site_objectives(g, rtn=False)["gptq"]}
        solves = [("same_h", r, r["H"])] + [("witness", g, one_ulp_apart(
            g["H"].to(dev, torch.float32), gen)) for _ in range(GPTQ_WITNESS_DRAWS)]
        for key, site, H in solves:
            qt, gi = TG.gptq_quantize(site["w"].to(dev, torch.float32), H.to(dev, torch.float32),
                                      site["args"], site["block_size"], site["damp"])
            apart, cells, steps = codes_apart(qt, site["qt"])
            mine = site_objectives(site, qt, gi, rtn=False)["gptq"]
            c = row[key]
            c["apart"], c["cells"] = c["apart"] + apart, c["cells"] + cells
            c["max_steps"] = max(c["max_steps"], steps)
            c["objective_rel"].append(abs(mine - base[key]) / base[key])
            if key == "same_h" and ((gi is None) != (r["g_idx"] is None) or (
                    gi is not None and not torch.equal(gi, r["g_idx"]))):
                gidx_apart.append(i)
        hg, hr = g["H"].to(dev, torch.float32), r["H"].to(dev, torch.float32)
        row["h_rel_apart"].append(float((hg - hr).abs().max() / hr.abs().max()))
    K.gptq_block.launches = before
    for row in layers.values():
        for key in ("same_h", "witness"):
            c = row[key]
            c["share"] = c["apart"] / c["cells"]
            c["max_objective_rel"] = max(c["objective_rel"])
        row["objective_limit"] = max(GPTQ_OBJ_RTOL,
                                     GPTQ_WITNESS_FACTOR * row["witness"]["max_objective_rel"])
        row["same_h"]["share_limit"] = GPTQ_WITNESS_FACTOR * row["witness"]["share"]
    out = {"by_layer": layers, "witness_draws": GPTQ_WITNESS_DRAWS,
           "witness_factor": GPTQ_WITNESS_FACTOR, "same_h_g_idx_apart": gidx_apart}
    log(f"[{label}] taken apart {out}")
    check(not gidx_apart, f"{label}: sites {gidx_apart}: the card's g_idx differs on the CPU's H")
    for layer, row in layers.items():
        c = row["same_h"]
        limit = min(row["objective_limit"], GPTQ_SAME_H_RTOL)
        check(c["max_objective_rel"] <= limit,
              f"{label}: layer {layer}: the card's objective on the CPU's W and H differs by "
              f"{c['max_objective_rel']:.3g} of the CPU's, over {limit:.3g}")
        check(c["share"] <= c["share_limit"],
              f"{label}: layer {layer}: on the CPU's W and H {c['share']:.3g} of the codes "
              f"apart, over {c['share_limit']:.3g}")
    return out


def objectives_agree(label: str, got: list, ref: list, limits: dict, per_layer: int = 7) -> dict:
    """The card's GPTQ sites against the CPU's, in order, each on its own
    device's W and H: each objective below RTN's on each device and within
    its layer's ``limits`` of the CPU's; g_idx equal wherever both devices'
    diagonal orders (the actorder permutations) agree (counted where they do
    not). Every site's numbers are logged before any check."""
    check(len(got) == len(ref) and ref, f"{label}: sites {len(got)} / {len(ref)}")
    rel, ratio, order_apart, gidx_apart, bad_gidx = [], [], [], 0, []
    for i, (gs, rs) in enumerate(zip(got, ref)):
        g, r = site_objectives(gs), site_objectives(rs)
        rel.append(abs(g["gptq"] - r["gptq"]) / r["gptq"])
        ratio.append([g["gptq"] / g["rtn"], r["gptq"] / r["rtn"]])
        if rs["g_idx"] is not None:
            same_order, same = torch.equal(g["order"], r["order"]), torch.equal(gs["g_idx"],
                                                                                 rs["g_idx"])
            if not same_order:
                order_apart.append(i)
            gidx_apart += not same
            if not same and same_order:
                bad_gidx.append(i)
    limit = [limits[i // per_layer] for i in range(len(ref))]
    row = {"sites": len(ref), "objective_rel_err": rel, "max_objective_rel_err": max(rel),
           "objective_limit_by_layer": limits, "gptq_over_rtn_card_cpu": ratio,
           "g_idx_apart": gidx_apart, "diag_orders_apart": order_apart}
    log(f"[{label}] objectives {row}")
    check(not bad_gidx, f"{label}: sites {bad_gidx}: g_idx differs with the same order")
    check(max(max(r) for r in ratio) < 1.0, f"{label}: a GPTQ objective is not below RTN's")
    over = [i for i, (e, t) in enumerate(zip(rel, limit)) if e > t]
    check(not over, f"{label}: sites {over}: objectives differ by {[rel[i] for i in over]}")
    return row


def card_vs_cpu_gptq(detail, tmp: Path, dense: Path, moe: Path,
                     devices=("cuda", "cpu")) -> None:
    """Phase 23: ``oneshot`` with GPTQ on both devices over phase 18's
    calibration batches, the repository's GPTQ recipe and GPTQ_G32 on the
    first 2 layers of path F's model: the objectives, the codes apart,
    g_idx, K11's exact launches, the sites taken apart
    (``gptq_decomposed``), and the CPU's g32 model on the card (K1) against
    the CPU's plain path. Then path G's first layer with GPTQ_G32 (the
    router left bf16) on the card alone: K11's exact launches, and every
    expert site's objective at most RTN's."""
    from quantizers_tpu_torch.core.scheme import ActOrder
    from quantizers_tpu_torch.models import load_hf_model
    from quantizers_tpu_torch.oneshot import oneshot
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.recipes import parse_recipe

    batches, ids, _ = comparison_batches(tmp)
    row = {"device": detail["device"], "batches": [list(b[0].shape) for b in batches]}
    detail["card_vs_cpu_gptq"] = row
    for name, recipe_name, recipe in (("gptq_w4a16_g128", "recipe_gptq_w4a16_g128", None),
                                      ("gptq_w4a16_g32", "recipe_gptq_w4a16_g32", GPTQ_G32)):
        label = f"card vs CPU {name}"
        res = engine_on_both(dense, recipe_name, batches, ids, devices, recipe=recipe,
                             cross=recipe is not None, record="gptq")
        got, ref = (res[d] for d in devices)
        apart = gptq_decomposed(label, got["log"], ref["log"], devices[0])
        actorder = ref["log"][0]["args"].actorder != ActOrder.NONE
        r = {"layers": 2, "seconds": {d: res[d]["s"] for d in devices},
             "k11_launches_card": got["calibration"]["gptq_block"],
             "codes": int_codes_agree(
                 label, got["records"], ref["records"], 14, one_step=lambda key: False,
                 share=lambda layer: 1.0 if actorder else GPTQ_CODE_SHARE[min(layer, 1)]),
             **objectives_agree(label, got["log"], ref["log"],
                                {layer: row["objective_limit"]
                                 for layer, row in apart["by_layer"].items()}),
             "taken_apart": apart}
        check(got["calibration"]["gptq_block"] == 2 * GPTQ_BLOCKS_PER_LAYER,
              f"{label}: K11 launched {got['calibration']['gptq_block']} times")
        check(got["flash"] > 0, f"{label}: the flash kernel never ran in calibration")
        if recipe is not None:
            check(got["cross_launches"]["w4_matmul"] > 0, f"{label}: the card's forward never ran K1")
            r["logits"] = logits_agree(label, got["cross_logits"], ref["logits"])
        r["own_models_logits"] = logits_apart(got["logits"], ref["logits"])
        row[name] = r
        log(f"[{label}] {r}")
        del res, got, ref

    # path G's first layer, the experts too, on the card alone
    label = "card GPTQ g32 MoE"
    spec, params = load_hf_model(moe, device=devices[0])
    E = spec.num_experts
    moe_recipe = json.loads(json.dumps(GPTQ_G32))
    moe_recipe["quant_stage"]["quant_modifiers"]["GPTQModifier"]["ignore"] += ["re:.*mlp\\.gate$"]
    D, Fe = spec.hidden_size, spec.moe_intermediate_size

    def blocks(k):
        return -(-k // GPTQ_BLOCK)
    want = (3 * blocks(D) + blocks(spec.q_dim)) + E * (2 * blocks(D) + blocks(Fe))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with gptq_sites() as sites:
        res = oneshot(spec, params, parse_recipe(moe_recipe), batches[:1], device=devices[0])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(len(res.records) == 4 + 3 * E, f"{label}: {len(res.records)} records")
    check(counts["gptq_block"] == want, f"{label}: K11 launched {counts['gptq_block']}, want {want}")
    seconds = time.perf_counter() - t0
    del res, params
    experts = [site_objectives(s) for s in sites[4:]]
    check(len(experts) == 3 * E, f"{label}: {len(experts)} expert solves")
    worst = max(s["gptq"] / s["rtn"] for s in experts)
    check(worst <= 1.0, f"{label}: an expert's GPTQ objective is {worst:.4g} of RTN's")
    row["moe_layer0_g32"] = {"seconds": seconds, "k11_launches": counts["gptq_block"],
                             "k11_launches_want": want, "expert_sites": len(experts),
                             "max_expert_gptq_over_rtn": worst,
                             "attention_gptq_over_rtn": [
                                 (o := site_objectives(s))["gptq"] / o["rtn"] for s in sites[:4]]}
    log(f"[{label}] {row['moe_layer0_g32']}")
    del sites
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 7f: AutoRound (path K) and data-free PTQ (path L)

#: the reference's GLM-4.7-Flash-FP8 ignore policy
#: (configs/quantize_glm-4.7-flash-fp8.yaml:4-6); its MLA patterns match
#: nothing in Qwen3
GLM_FP8_IGNORE = ["lm_head", "re:.*mlp\\.gate$", "re:.*kv_a_proj_with_mqa$",
                  "re:.*kv_a_layernorm$", "re:.*q_a_layernorm$", "re:.*embed_tokens$"]
#: path K's scheme (recipe_ar_w4a16g32.yaml): symmetric w4 g32
AR_W4G32 = {"num_bits": 4, "type": "int", "symmetric": True, "strategy": "group",
            "group_size": 32}
#: phase 26(a): layer 0's gate_proj of path F's model cut to its first
#: AR_SITE_ROWS output channels (N 256, K 2560), on the rows the CPU's
#: capture keeps (1,024), AR_ITERS steps at the recipe's step size AR_LR (a
#: second run at 0.005 gave the same picture on an H100, `PERF.md` §6, and
#: was cut for time)
AR_SITE_ROWS, AR_ITERS, AR_LR = 256, 200, 0.05
#: phase 26(a), card against CPU. signSGD steps by the sign of each
#: gradient entry, and an entry near zero may take the other sign when the
#: f32 sums run in another order; the two trajectories part from there. The
#: witness: each device re-solves its own problem AR_WITNESS_DRAWS times
#: with every entry of X moved by one f32 ulp (or left) (on an H100 the
#: card's own draws moved 2.6-3.1x fewer codes than the devices did, and
#: reordering the rows of X moved none). The card's best loss on the CPU's
#: problem lies within the larger of AR_LOSS_RTOL and AR_WITNESS_FACTOR
#: times the witness's largest spread of its device's loss; its codes apart
#: from the CPU's in at most AR_WITNESS_FACTOR times the witness's largest
#: share
AR_LOSS_RTOL, AR_WITNESS_DRAWS, AR_WITNESS_FACTOR = 1e-3, 3, 2.0


def oneshot_autoround_phase(detail, tmp: Path, bf16: Path) -> None:
    """Path K: the first HI_LAYERS layers of path F's Qwen3-4B bf16
    checkpoint (``bf16``) through ``do_oneshot`` with recipe_ar_w4a16g32
    (AutoRound, 200 steps, the MLP's three linears, W4A16 g32) on the card:
    the stage seconds, the peak memory, 3 records a layer, the exact K4
    (capture and propagate) and K1 (the propagate's MLP) launches; then
    served (K1 for the MLP, K2, the int8 head on K3)."""
    from quantizers_tpu_torch.models import ModelSpec

    t0 = time.perf_counter()
    card = detail["device"]
    spec = ModelSpec(**dict(GEOMETRY, num_layers=HI_LAYERS))
    out = tmp / "qwen3_4b_ar_w4a16g32"
    with BatchShapes() as shapes:
        run = oneshot_cli("path K", write_run_config(tmp / "run_K.yaml", bf16,
                                                     "recipe_ar_w4a16g32"),
                          out, tmp / "calibration_cache", card)
    want = calibration_launches(spec, shapes.shapes, 2, "w4_matmul", every_m=False, linears=3)
    check(run["records"] == spec.num_layers * 3,
          f"path K: {run['records']} records, want {spec.num_layers * 3}")
    check(run["launches"] == want and want["w4_matmul"] > 0,
          f"path K: calibration launches {run['launches']} != {want}")
    group = json.loads((out / "config.json").read_text())["quantization_config"][
        "config_groups"]["group_0"]
    w = group["weights"]
    check((w["num_bits"], w["type"], w["strategy"], w["group_size"]) == (4, "int", "group", 32)
          and group["targets"] == ["re:.*mlp\\.(gate|up|down)_proj$"],
          f"path K: the checkpoint's scheme is {group}")
    torch.cuda.empty_cache()
    served = serve_output("path K", out, synthetic_text(),
                          (("decode_attention",), ("w8_matmul",), ("w4_matmul",)), card)
    detail["path_K"] = {"device": card, "batches": shapes.shapes, "oneshot": run,
                        "serve": served, "seconds": time.perf_counter() - t0}
    shutil.rmtree(out)


def model_free_cli(label: str, src: Path, out: Path, scheme: str, device: str,
                   ignore=None) -> dict:
    """``cli/model_free.main`` as a user runs it (on the card unless
    ``device`` names the CPU): its seconds, tensors quantized, bytes written,
    the peak device memory and the kernels it launched (none)."""
    from quantizers_tpu_torch.cli import model_free
    from quantizers_tpu_torch.ops import kernels as K

    argv = [str(src), str(out), "--scheme", scheme, "--device", device]
    if ignore is not None:
        argv += ["--ignore", *ignore]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rc, stdout, _ = run_cli(model_free.main, argv, "quantizers_tpu_torch.oneshot.model_free")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{label}: model_free returned {rc}")
    counts = K.launch_counts()
    check(counts == expect(), f"{label}: model_free launched {counts}")
    return {"device": device, "scheme": scheme, "seconds": seconds,
            "quantized": int(re.search(r"quantized (\d+) tensors", stdout).group(1)),
            "output_bytes": sum(f.stat().st_size for f in out.iterdir()),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def model_free_phase(detail, tmp: Path, bf16: Path) -> None:
    """Path L: path F's Qwen3-4B bf16 checkpoint (F_LAYERS deep) through the
    port's ``cli/model_free.main`` with FP8_BLOCK and the reference's
    GLM-4.7-Flash-FP8 ignore policy on the card: its seconds, bytes written,
    peak device memory, 7 quantized tensors a layer and the scheme in
    ``config.json``; then ``cli/serve.main`` (fp8 linears on K9, K2, the
    int8 head on K3) and a drive with exact launches (``drive_served``)."""
    from quantizers_tpu_torch.formats.checkpoint import CompressedModelReader
    from quantizers_tpu_torch.models import ModelSpec

    t0 = time.perf_counter()
    card = detail["device"]
    spec = ModelSpec(**dict(GEOMETRY, num_layers=F_LAYERS))
    out = tmp / "qwen3_4b_fp8_block"
    run = model_free_cli("path L", bf16, out, "FP8_BLOCK", "cuda", GLM_FP8_IGNORE)
    log(f"[path L] model_free ({card}): {run}")
    check(run["quantized"] == spec.num_layers * 7,
          f"path L: {run['quantized']} tensors quantized, want {spec.num_layers * 7}")
    qcfg = json.loads((out / "config.json").read_text())["quantization_config"]
    w = qcfg["config_groups"]["group_0"]["weights"]
    check((w["num_bits"], w["type"], w["strategy"], w["block_structure"]) ==
          (8, "float", "block", [128, 128]) and qcfg["ignore"] == GLM_FP8_IGNORE,
          f"path L: the checkpoint's scheme is {w}, ignore {qcfg['ignore']}")
    with CompressedModelReader(out) as r:
        quant = r.quantized_modules()
    check(len(quant) == spec.num_layers * 7, f"path L: {len(quant)} quantized modules on disk")
    torch.cuda.empty_cache()
    served = serve_output("path L", out, synthetic_text(),
                          (("decode_attention",), ("w8_matmul",), ("fp8_matmul",)), card)
    drive = drive_served("path L", out, SIDE_STEPS, "fp8_matmul")
    log(f"[path L drive] ({card}) {drive}")
    detail["path_L"] = {"device": card, "model_free": run, "serve": served, "drive": drive,
                        "seconds": time.perf_counter() - t0}
    shutil.rmtree(out)


def autoround_site(tmp: Path, dense: Path) -> tuple:
    """Phase 26(a)'s problem: layer 0's gate_proj of ``dense`` and the rows
    the CPU's capture keeps for it (MAX_ROWS, 1,024) over the fixture set's
    11 rows at 256 tokens (``oneshot`` on the CPU with AutoRound on that
    site alone, 0 steps), the weight cut to its first AR_SITE_ROWS output
    channels, f32 on the CPU."""
    from quantizers_tpu_torch.models import load_hf_model
    from quantizers_tpu_torch.oneshot import autoround as TA
    from quantizers_tpu_torch.oneshot import make_batches, oneshot
    from quantizers_tpu_torch.recipes import parse_recipe

    batches = make_batches(fixture_rows(tmp), max_seq_length=256, batch_size=4)
    spec, params = load_hf_model(dense, device="cpu")
    recipe = {"quant_stage": {"quant_modifiers": {"AutoRoundModifier": {
        "iters": 0, "config_groups": {"group_0": {
            "targets": ["re:.*layers\\.0\\.mlp\\.gate_proj$"], "weights": AR_W4G32}}}}}}
    seen, orig = [], TA.autoround_quantize

    def recording(w, x, *a, **kw):
        seen.append((w[:AR_SITE_ROWS].contiguous(), x))
        return orig(w, x, *a, **kw)
    TA.autoround_quantize = recording
    try:
        oneshot(spec, params, parse_recipe(recipe), batches, device="cpu")
    finally:
        TA.autoround_quantize = orig
    check(len(seen) == 1 and seen[0][1].shape[0] == TA.MAX_ROWS,
          f"phase 26: {len(seen)} AutoRound sites, want 1 on {TA.MAX_ROWS} rows")
    return seen[0]


def autoround_on_both(W: torch.Tensor, X: torch.Tensor, lr: float, gen,
                      devices=("cuda", "cpu")) -> dict:
    """One AutoRound problem (W, X on the CPU, RTN scales from W) solved on
    both devices and, on each, AR_WITNESS_DRAWS times with X one f32 ulp
    apart: each solve's best loss, its step-0 loss and seconds, the
    witness's spreads and shares, the codes apart; checked against the
    limits."""
    from quantizers_tpu_torch.core.scheme import QuantizationArgs
    from quantizers_tpu_torch.oneshot import autoround as TA

    args = QuantizationArgs.from_dict(AR_W4G32)
    scale, zp, g = TA._qparams(W, args)

    def solve(x, dev):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, best, first = TA._autoround_solve(
            W.to(dev), x.to(dev), scale.to(dev), None if zp is None else zp.to(dev),
            iters=AR_ITERS, group_size=g, qmin=-8.0, qmax=7.0, lr=lr)
        best, first = float(best), float(first)  # waits for the device
        return {"q": q.cpu(), "best": best, "first": first,
                "seconds": time.perf_counter() - t0}

    got, ref = solve(X, devices[0]), solve(X, devices[1])
    label = f"card vs CPU AutoRound lr {lr}"
    for d, r in zip(devices, (got, ref)):
        check(r["best"] <= r["first"], f"{label}: the {d}'s best loss {r['best']} is above its "
              f"step-0 loss {r['first']}")
    spreads, shares = {d: [] for d in devices}, {d: [] for d in devices}
    for d, own in zip(devices, (got, ref)):
        Xd = X.to(d)
        for _ in range(AR_WITNESS_DRAWS):
            r = torch.randint(-1, 2, X.shape, generator=gen).float().to(d)
            w = solve(Xd * (1.0 + r * 2.0 ** -23), d)
            spreads[d].append(abs(w["best"] - own["best"]) / own["best"])
            shares[d].append(float((w["q"] != own["q"]).float().mean()))
    spread = max(max(v) for v in spreads.values())
    share = max(max(v) for v in shares.values())
    rel = abs(got["best"] - ref["best"]) / ref["best"]
    apart = got["q"] != ref["q"]
    res = {"lr": lr, "rows": X.shape[0], "n_k": list(W.shape), "iters": AR_ITERS,
           "best": {d: r["best"] for d, r in zip(devices, (got, ref))},
           "rtn": {d: r["first"] for d, r in zip(devices, (got, ref))},
           "seconds": {d: r["seconds"] for d, r in zip(devices, (got, ref))},
           "best_rel_apart": rel, "witness_spreads": spreads,
           "loss_limit": max(AR_LOSS_RTOL, AR_WITNESS_FACTOR * spread),
           "codes_apart_share": float(apart.float().mean()),
           "codes_apart_max_steps": int((got["q"] - ref["q"]).abs().max()),
           "witness_shares": shares, "codes_limit": AR_WITNESS_FACTOR * share}
    check(rel <= res["loss_limit"], f"{label}: best losses {rel:.3g} apart, limit "
          f"{res['loss_limit']:.3g}: {res}")
    check(res["codes_apart_share"] <= res["codes_limit"],
          f"{label}: {res['codes_apart_share']:.3g} of the codes apart, limit "
          f"{res['codes_limit']:.3g}: {res}")
    log(f"[{label}] {res}")
    return res


def same_checkpoint(label: str, got: Path, ref: Path) -> dict:
    """Two checkpoint directories: the same files, every tensor equal bit
    for bit, every other file equal byte for byte."""
    from quantizers_tpu_torch.formats.safetensors_io import ShardedReader

    files = sorted(f.name for f in ref.iterdir())
    check(sorted(f.name for f in got.iterdir()) == files, f"{label}: other files")
    with ShardedReader(got) as a, ShardedReader(ref) as b:
        check(a.weight_map == b.weight_map, f"{label}: other indexes")
        for name in b.keys():
            x, y = a.get(name), b.get(name)
            check(x.dtype == y.dtype and x.shape == y.shape and
                  torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)),
                  f"{label}: {name} differs")
        tensors = len(b.keys())
    for f in files:
        if not f.endswith(".safetensors"):
            check((got / f).read_bytes() == (ref / f).read_bytes(), f"{label}: {f} differs")
    return {"tensors": tensors, "files": len(files)}


def card_vs_cpu_slice7f(detail, tmp: Path, dense: Path, devices=("cuda", "cpu")) -> None:
    """Phase 26: (a) AutoRound on one cut site of path F's model
    (``autoround_site``), on both devices and the witness
    (``autoround_on_both``); (b) ``model_free`` on the first 2 layers
    of path F's model with FP8_BLOCK and W4A16_G32 on both devices: every
    tensor equal bit for bit, the same index, ``config.json`` and assets."""
    row = {"device": detail["device"]}
    detail["card_vs_cpu_7f"] = row
    t0 = time.perf_counter()
    W, X = autoround_site(tmp, dense)
    row["capture_s"] = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(F_SEED)
    row["autoround"] = autoround_on_both(W, X, AR_LR, gen, devices)
    del W, X
    row["model_free"] = {}
    for scheme in ("FP8_BLOCK", "W4A16_G32"):
        outs = [tmp / f"model_free_{scheme}_{i}" for i in range(len(devices))]
        runs = [model_free_cli(f"card vs CPU model_free {scheme}", dense, out, scheme, d)
                for out, d in zip(outs, devices)]
        same = same_checkpoint(f"card vs CPU model_free {scheme}", *outs)
        row["model_free"][scheme] = {"runs": runs, **same}
        log(f"[card vs CPU model_free {scheme}] {row['model_free'][scheme]}")
        for out in outs:
            shutil.rmtree(out)
    row["seconds"] = time.perf_counter() - t0


def autoround_expert_stack(gen, experts: int = 128, n: int = 768, k: int = 2048,
                           rows: int = 1024) -> dict:
    """One expert stack's AutoRound at path G's width (Qwen3-30B-A3B's 128
    experts' gate_proj, 768 x 2048, each on 1,024 rows, AR_ITERS steps): the
    seconds on the card, and the estimate for a layer's three stacks. Not in
    the default run (ROADMAP queue 1)."""
    from quantizers_tpu_torch.core.scheme import QuantizationArgs
    from quantizers_tpu_torch.oneshot import autoround_quantize

    args = QuantizationArgs.from_dict(AR_W4G32)
    W = torch.randn((experts, n, k), generator=gen, device="cuda") * 0.02
    X = torch.randn((rows, k), generator=gen, device="cuda")
    autoround_quantize(W[0], X, args, AR_ITERS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(experts):
        autoround_quantize(W[e], X, args, AR_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"experts": experts, "n_k": [n, k], "rows": rows, "iters": AR_ITERS,
            "seconds": seconds, "per_solve_ms": seconds / experts * 1e3,
            "layer_estimate_s": 3 * seconds}


def oneshot_phases(detail) -> dict:
    """Phases 16-26: paths F and G (slice 6 and the RTN oneshot engine), H,
    I, J, K and L (AWQ, W8A8, GPTQ, AutoRound and data-free FP8_BLOCK on F's
    bf16 checkpoint), from bf16 checkpoints to served compressed ones, and
    the engine card against CPU;
    ``detail["device"]`` holds the card's nvidia-smi line. The checkpoints,
    the calibration cache and HF's caches live in a temporary directory,
    removed at the end; nothing is fetched. Returns path I's drive."""
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        os.environ[var] = "1"
    laps = detail["oneshot_phase_s"] = {}

    def lap(name: str, t0=[time.perf_counter()]) -> None:
        now = time.perf_counter()
        laps[name], t0[0] = now - t0[0], now

    with tempfile.TemporaryDirectory(prefix="chip_smoke_oneshot_") as tmp:
        os.environ["HF_HOME"] = str(Path(tmp) / "hf_home")
        bf16, two = oneshot_dense_phase(detail, Path(tmp))
        lap("16_F")
        oneshot_awq_phase(detail, Path(tmp), two)
        lap("19_H")
        drive = oneshot_w8a8_phase(detail, Path(tmp), two)
        lap("20_I")
        oneshot_autoround_phase(detail, Path(tmp), two)
        lap("24_K")
        oneshot_gptq_phase(detail, Path(tmp), bf16)
        lap("22_J")
        model_free_phase(detail, Path(tmp), bf16)
        lap("25_L")
        shutil.rmtree(bf16)
        one = oneshot_moe_phase(detail, Path(tmp))
        lap("17_G")
        card_vs_cpu_oneshot(detail, Path(tmp), two, one)
        lap("18_cvc")
        card_vs_cpu_slice7(detail, Path(tmp), two, one)
        lap("21_cvc")
        card_vs_cpu_gptq(detail, Path(tmp), two, one)
        lap("23_cvc")
        card_vs_cpu_slice7f(detail, Path(tmp), two)
        lap("26_cvc")
    log(f"[oneshot] seconds by phase: {laps}")
    return drive


# ---------------------------------------------------------------------------
# the training slice: fit_lm at full width (phase 27), the perplexity
# protocol's user surface (phase 28), card against CPU (phase 29)
# ---------------------------------------------------------------------------

#: phase 27's depth: Qwen3-4B's widths at 8 of its 36 layers. At 36 layers
#: (4.02 B parameters) the f32 masters (16.1 GB), their gradients (16.1),
#: AdamW's m and v (32.2), the bf16 originals (8.0) and the bf16 casts kept
#: for the backward (8.0) come to about 80 GB, which no 80 GB card holds;
#: 8 layers have 1.196 B parameters, about 25 GB
FIT_LAYERS = 8
#: phase 27's fit (fit_lm's own window and batch, 30 steps); ms a step is
#: timed between the losses logged at step FIT_TIMED_FROM and the last
FIT_ARGS = dict(steps=30, batch_size=8, seq_len=64, lr=3e-3, seed=0)
FIT_TIMED_FROM = 5
#: phase 28: the perplexity protocol's tiny model and fit
#: (benchmarks/ppl_protocol.py:178-183)
PROTOCOL_MODEL = ["--hidden", "96", "--layers", "2", "--vocab", "512", "--fit-steps", "2500",
                  "--fit-batch", "32", "--fit-seq", "32", "--fit-lr", "2e-3"]
#: phase 28's own W4A16 g32 recipes, on [Linear] but lm_head as AWQ's is, so
#: that the orderings at equal bits compare like with like
#: (ppl_protocol.py:205-221)
W4G32 = ("            num_bits: 4\n            type: int\n            symmetric: true\n"
         "            strategy: group\n            group_size: 32\n")
PROTOCOL_RECIPES = {
    "w4a16_rtn": "    QuantizationModifier:\n      ignore: [lm_head]\n      config_groups:\n"
                 "        group_0:\n          targets: [Linear]\n          weights:\n" + W4G32,
    "w4a16_gptq": "    GPTQModifier:\n      ignore: [lm_head]\n      dampening_frac: 0.01\n"
                  "      config_groups:\n        group_0:\n          targets: [Linear]\n"
                  "          weights:\n" + W4G32}
#: phase 29, card against CPU on phase 28's tiny shape: each leaf's gradient
#: within 2e-2 of its own largest |value|, and each loss that fit_lm logs
#: over 100 steps within 2e-2 of the CPU's (both devices round the
#: activations to bf16 at the same points, with f32 sums in other orders)
FIT_GRAD_RTOL, FIT_LOSS_RTOL, FIT_CVC_STEPS = 2e-2, 2e-2, 100
FIT_LOGGER = "quantizers_tpu_torch.models.fit"


def chain_text(n_chars: int = 60_000, seed: int = 0) -> str:
    """The perplexity protocol's corpus (``benchmarks/ppl_protocol.py:65-83``):
    an order-1 Markov chain over 32 ASCII symbols, about 4 successors a
    state (about 1.11 nats a character: a perplexity floor of about 3.03)."""
    rng = np.random.default_rng(seed)
    syms = [chr(ord("a") + i) for i in range(26)] + list(".,;: !")
    trans = np.zeros((32, 32))
    for i in range(32):
        trans[i, rng.choice(32, size=4, replace=False)] = rng.dirichlet([1.0] * 4)
    r = np.random.default_rng(seed + 1)
    out = [int(r.integers(32))]
    for _ in range(n_chars - 1):
        out.append(int(r.choice(32, p=trans[out[-1]])))
    return "".join(syms[i] for i in out)


def param_paths(tree, path: str = ""):
    """(path, tensor) of every floating tensor of a params tree, in
    ``fit.trainable``'s order: ``/layers/0/q_proj.weight``, ``/embed``."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from param_paths(v, f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from param_paths(v, f"{path}/{i}")
    elif hasattr(tree, "kind") and hasattr(tree, "weight"):
        for field in ("weight", "scale", "zero_point", "bias"):
            yield from param_paths(getattr(tree, field), f"{path}.{field}")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree


def largest_tensors(n: int = 6) -> list:
    """The ``n`` largest live CUDA tensors the garbage collector can see:
    (GB, shape, dtype)."""
    import gc
    import warnings

    found = {}
    with warnings.catch_warnings():  # deprecated module proxies warn on isinstance
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                try:
                    storage = obj.untyped_storage()
                except RuntimeError:  # a tensor without storage (sparse, nested)
                    continue
                found[storage.data_ptr()] = (storage.nbytes() / 1e9, tuple(obj.shape),
                                             str(obj.dtype))
    return sorted(found.values(), reverse=True)[:n]


def fit_losses(rec) -> dict:
    """{step: (host time, loss)} of the losses fit_lm logged."""
    return {r.args[0]: (r.created, r.args[2]) for r in rec.records
            if r.msg.startswith("fit step")}


def fit_step_bound(spec, n_params: int) -> dict:
    """The least time the card could take for one step of phase 27's fit,
    part by part (each part bound by one rate): the matmuls, forward and
    backward (6 operations a parameter a token, the tied head's included,
    and the attention's 12 B H T^2 d a layer) at the bf16 rate; fused
    AdamW's bytes (p, g, m and v read, p, m and v written: 28 a parameter)
    and the bf16 casts of the f32 masters (4 read, 2 written) at the
    memory's rate."""
    B, T = FIT_ARGS["batch_size"], FIT_ARGS["seq_len"]
    flops = (6 * n_params * B * T
             + 12 * B * spec.num_heads * T * T * spec.head_dim * spec.num_layers)
    parts = {"matmul_ms": flops / BF16_FLOPS * 1e3,
             "adamw_ms": 28 * n_params / HBM_BYTES_PER_S * 1e3,
             "casts_ms": 6 * n_params / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": sum(parts.values()), **parts, "bound_flops": flops,
            "bound_bytes": 34 * n_params}


def fit_phase(detail, tmp: Path, text: str, device: str = "cuda") -> None:
    """Phase 27: ``fit_lm`` at Qwen3-4B's widths, FIT_LAYERS layers, seeded
    weights, on the chain corpus's bytes. First one ``lm_loss`` backward:
    every floating leaf's gradient finite and nonzero (each layer's q, k, v,
    q_norm and k_norm named). Then the fit with every launch count at 0 (no
    kernel runs under autograd, K4 included): ms a step, peak memory, the
    first and last loss, the bound. Then ``save_hf_model`` and
    ``cli/eval_ppl.main`` on the fitted checkpoint over two windows, K4
    exactly FIT_LAYERS launches a batch."""
    from quantizers_tpu_torch.cli import eval_ppl
    from quantizers_tpu_torch.data import ByteTokenizer
    from quantizers_tpu_torch.models import ModelSpec, init_params
    from quantizers_tpu_torch.models import fit as TFIT
    from quantizers_tpu_torch.models.loader import save_hf_model
    from quantizers_tpu_torch.ops import kernels as K

    spec = ModelSpec(**dict(GEOMETRY, num_layers=FIT_LAYERS))
    ids = np.asarray(ByteTokenizer()(text)["input_ids"], np.int32)
    params = init_params(spec, seed=27, device=device)
    n_params = sum(t.numel() for _, t in param_paths(params))

    # one gradient, on a batch of the fit's shape
    B, T = FIT_ARGS["batch_size"], FIT_ARGS["seq_len"]
    starts = np.random.default_rng(27).integers(0, len(ids) - T - 1, B)
    batch = torch.as_tensor(np.stack([ids[s:s + T + 1] for s in starts]), device=device)
    params32, leaves = TFIT.trainable(params)
    K.reset_launch_counts()
    TFIT.lm_loss(spec, params32, batch).backward()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    grads = {path: (0.0, False) if leaf.grad is None else
             (leaf.grad.abs().max().item(), bool(torch.isfinite(leaf.grad).all()))
             for path, leaf in param_paths(params32)}
    del params32, leaves  # the f32 masters and their gradients, 9.6 GB
    torch.cuda.empty_cache()
    check(counts == expect(), f"phase 27: the backward launched kernels: {counts}")
    bad = [path for path, (amax, finite) in grads.items() if not (finite and amax > 0)]
    check(not bad, f"phase 27: leaves without a finite, nonzero gradient: {bad}")
    attn = {f"/layers/{i}/{name}": grads[f"/layers/{i}/{name}"][0]
            for i in range(spec.num_layers)
            for name in ("q_proj.weight", "k_proj.weight", "v_proj.weight", "q_norm", "k_norm")}
    log(f"[phase 27] one lm_loss backward: {len(grads)} leaves, every gradient finite and "
        f"nonzero; the attention leaves' largest |grad|: {attn}")

    # the fit; the device memory that the script holds already (the seeded
    # bf16 params and what earlier phases keep) is read first, so that the
    # fit's own peak is the peak above it
    logging.getLogger(FIT_LOGGER).setLevel(logging.INFO)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    log(f"[phase 27] device memory held before the fit: {held / 1e9:.3f} GB, the seeded "
        f"params {2 * n_params / 1e9:.3f} GB of it; the largest live tensors: {largest_tensors()}")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with Records(FIT_LOGGER) as rec:
        fitted = TFIT.fit_lm(spec, params, ids, log_every=FIT_TIMED_FROM, **FIT_ARGS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = K.launch_counts(), torch.cuda.max_memory_allocated()
    del params
    losses = fit_losses(rec)
    last = FIT_ARGS["steps"] - 1
    ms = (losses[last][0] - losses[FIT_TIMED_FROM][0]) / (last - FIT_TIMED_FROM) * 1e3
    res = {"layers": spec.num_layers, "parameters": n_params, **FIT_ARGS, "wall_s": wall,
           "ms_per_step": ms, "timed_steps": f"{FIT_TIMED_FROM}-{last}",
           "peak_memory_gb": peak / 1e9, "held_before_gb": held / 1e9,
           "fit_peak_gb": (peak - held) / 1e9, "first_loss": losses[0][1],
           "last_loss": losses[last][1], "losses": {i: v for i, (_, v) in sorted(losses.items())},
           "launches": counts, **fit_step_bound(spec, n_params), "card": detail["device"]}
    res["step_over_bound"] = ms / res["bound_ms"]
    detail["fit"] = res
    log(f"[phase 27] fit_lm: {res}")
    check(counts == expect(), f"phase 27: the fit launched kernels (K4 included): {counts}")
    check(math.isfinite(res["last_loss"]) and res["last_loss"] < res["first_loss"],
          f"phase 27: the loss did not fall: {res['losses']}")

    # the fitted checkpoint, evaluated by the CLI on the card
    ckpt, corpus = tmp / "fit_qwen3_4b", tmp / "chain.txt"
    corpus.write_text(text)
    t0 = time.perf_counter()
    save_hf_model(spec, fitted, ckpt)
    save_s = time.perf_counter() - t0
    del fitted
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    rc, out, rec = run_cli(eval_ppl.main, [str(ckpt), str(corpus), "--window", "2048", "--stride",
                                           "2048", "--batch-size", "1", "--max-windows", "2"],
                           "quantizers_tpu_torch.eval_ppl")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    m = re.search(r"^ppl=(\S+) tokens=(\d+) windows=(\d+) eval_s=", out, re.M)
    check(rc == 0 and m is not None, f"phase 27: eval_ppl printed no result line: {out!r}")
    ppl, n_win = float(m.group(1)), int(m.group(3))
    res.update(save_s=save_s, eval_ppl=ppl, eval_windows=n_win, eval_launches=counts,
               eval_s=rec.args("scored")[2])
    log(f"[phase 27] eval_ppl on the fitted checkpoint: ppl {ppl}, {n_win} windows, "
        f"launches {counts}")
    check(math.isfinite(ppl) and ppl > 1.0 and n_win == 2,
          f"phase 27: perplexity {ppl} over {n_win} windows")
    check(counts == expect(flash_attention=2 * spec.num_layers),
          f"phase 27: eval launches {counts}, want K4 {spec.num_layers} a batch")
    shutil.rmtree(ckpt)


def protocol_ppl(ckpt: Path, text: Path) -> float:
    """``cli/eval_ppl.main`` on the card over the whole file, in the
    protocol's 128-token windows (``ppl_protocol.py:114``)."""
    from quantizers_tpu_torch.cli import eval_ppl

    rc, out, _ = run_cli(eval_ppl.main, [str(ckpt), str(text), "--window", "128", "--stride",
                                         "128"], "quantizers_tpu_torch.eval_ppl")
    m = re.search(r"^ppl=(\S+) tokens=", out, re.M)
    check(rc == 0 and m is not None, f"phase 28: eval_ppl on {ckpt.name}: {out!r}")
    return float(m.group(1))


def protocol_phase(detail, tmp: Path, text: str) -> None:
    """Phase 28: the perplexity protocol's W4A16 part on the card, through
    the port's CLIs only: ``make_tiny_model --fit-corpus`` on the chain
    corpus with the protocol's settings, ``do_oneshot`` with RTN, AWQ and
    GPTQ at W4A16 g32 over the in-domain calibration set
    (``ppl_protocol.py:86-108``), ``eval_ppl`` on the corpus's first 24,000
    characters; every delta positive, AWQ and GPTQ at most RTN
    (``tests/test_ppl_protocol.py:31-40``)."""
    from quantizers_tpu_torch.cli import do_oneshot, make_tiny_model
    from quantizers_tpu_torch.ops import kernels as K

    work = tmp / "protocol"
    work.mkdir()
    corpus, eval_file = work / "corpus.txt", work / "eval.txt"
    corpus.write_text(text)
    eval_file.write_text(text[:24000])
    model = work / "tiny_bf16"
    logging.getLogger(FIT_LOGGER).setLevel(logging.INFO)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out, rec = run_cli(make_tiny_model.main, [str(model), *PROTOCOL_MODEL,
                                                  "--fit-corpus", str(corpus)], FIT_LOGGER)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = K.launch_counts()
    losses = fit_losses(rec)
    steps = PROTOCOL_MODEL[PROTOCOL_MODEL.index("--fit-steps") + 1]
    check(rc == 0 and f"wrote tiny fitted ({steps} steps) model" in out,
          f"phase 28: make_tiny_model --fit-corpus: {out!r}")
    check(counts == expect(), f"phase 28: the fit launched kernels: {counts}")

    # the in-domain calibration set: 32 chunks of 256 characters
    ds_dir = work / "chain_calib"
    ds_dir.mkdir()
    rows = [{"text": text[s:s + 256]} for s in range(0, 32 * 256, 256)]
    (ds_dir / "dataset.json").write_text(json.dumps(rows))
    calib = work / "calibrate_chain.yaml"
    calib.write_text(f"calibration_set:\n  max_seq_length: 256\n  shuffle: true\n  seed: 42\n"
                     f"  datasets:\n    - dataset: {ds_dir}\n      split: train\n"
                     f"      columns: [text]\n      formatter: raw_text\n      num_samples: 32\n")
    recipes = {"w4a16_awq": ROOT / "configs" / "recipes" / "recipe_awq_w4a16.yaml"}
    for tag, body in PROTOCOL_RECIPES.items():
        recipes[tag] = work / f"recipe_{tag}.yaml"
        recipes[tag].write_text(f"quant_stage:\n  quant_modifiers:\n{body}")
    ppl = {"bf16": protocol_ppl(model, eval_file)}
    oneshot_s = {}
    for tag in ("w4a16_awq", "w4a16_rtn", "w4a16_gptq"):
        run_cfg = work / f"run_{tag}.yaml"
        run_cfg.write_text(f"model:\n  name: {model}\nquantization:\n  recipe: {recipes[tag]}\n"
                           f"calibration_set: {calib}\n")
        out_dir = work / f"out_{tag}"
        t0 = time.perf_counter()
        rc, _, _ = run_cli(do_oneshot.main, ["--config", str(run_cfg), "--output", str(out_dir),
                                             "--cache-dir", str(work / "cache"),
                                             "--max-seq-length", "128"],
                           "quantizers_tpu_torch.do_oneshot")
        oneshot_s[tag] = time.perf_counter() - t0
        check(rc == 0, f"phase 28: do_oneshot {tag} returned {rc}")
        ppl[tag] = protocol_ppl(out_dir, eval_file)
    delta = {tag: ppl[tag] - ppl["bf16"] for tag in ppl if tag != "bf16"}
    res = {"fit_s": fit_s, "fit_first_loss": losses[0][1],
           "fit_last_loss": losses[max(losses)][1], "fit_launches": counts,
           "oneshot_s": oneshot_s, "ppl": ppl, "delta": delta, "card": detail["device"]}
    detail["protocol"] = res
    log(f"[phase 28] {res}")
    check(all(d > 0 for d in delta.values()), f"phase 28: a delta is not positive: {delta}")
    check(ppl["w4a16_awq"] <= ppl["w4a16_rtn"], f"phase 28: AWQ above RTN: {ppl}")
    check(ppl["w4a16_gptq"] <= ppl["w4a16_rtn"], f"phase 28: GPTQ above RTN: {ppl}")


def card_vs_cpu_fit(detail, text: str, devices=("cuda", "cpu")) -> None:
    """Phase 29: one set of seeded tiny weights (phase 28's shape) on both
    devices: the ``lm_loss`` gradients of one batch, each leaf within
    FIT_GRAD_RTOL of its own largest |value|; then FIT_CVC_STEPS steps of
    ``fit_lm`` (the protocol's batch, window and rate), each logged loss
    within FIT_LOSS_RTOL of the CPU's."""
    from quantizers_tpu_torch.data import ByteTokenizer
    from quantizers_tpu_torch.models import ModelSpec, init_params
    from quantizers_tpu_torch.models import fit as TFIT
    from quantizers_tpu_torch.models.transformer import tree_to

    spec = ModelSpec.tiny(hidden_size=96, num_layers=2, vocab_size=512)
    params = init_params(spec, seed=29, device="cpu")
    ids = np.asarray(ByteTokenizer()(text)["input_ids"], np.int32)
    starts = np.random.default_rng(29).integers(0, len(ids) - 33, 32)
    batch = torch.as_tensor(np.stack([ids[s:s + 33] for s in starts]))
    grads, losses, secs = {}, {}, {}
    logging.getLogger(FIT_LOGGER).setLevel(logging.INFO)
    for dev in devices:
        t0 = time.perf_counter()
        on_dev = tree_to(params, torch.device(dev))
        params32, _ = TFIT.trainable(on_dev)
        TFIT.lm_loss(spec, params32, batch.to(dev)).backward()
        grads[dev] = {path: leaf.grad.cpu() for path, leaf in param_paths(params32)}
        with Records(FIT_LOGGER) as rec:
            TFIT.fit_lm(spec, on_dev, ids, steps=FIT_CVC_STEPS, batch_size=32, seq_len=32,
                        lr=2e-3, seed=0, log_every=10)
        losses[dev] = {i: v for i, (_, v) in fit_losses(rec).items()}
        secs[dev] = time.perf_counter() - t0
    got, ref = (grads[d] for d in devices)
    check(sorted(got) == sorted(ref) and all(bool(torch.isfinite(g).all()) for g in got.values()),
          "card vs CPU fit: gradients missing or not finite")
    grad_ratio = {path: ((got[path] - ref[path]).abs().max()
                         / (FIT_GRAD_RTOL * ref[path].abs().max())).item() for path in ref}
    lg, lc = (losses[d] for d in devices)
    check(sorted(lg) == sorted(lc), f"card vs CPU fit: logged steps differ: {losses}")
    loss_err = max(abs(lg[i] - lc[i]) / abs(lc[i]) for i in lc)
    res = {"leaves": len(ref), "worst_grad_err_over_tol": max(grad_ratio.values()),
           "worst_leaf": max(grad_ratio, key=grad_ratio.get), "grad_rtol": FIT_GRAD_RTOL,
           "losses": losses, "max_loss_rel_err": loss_err, "loss_rtol": FIT_LOSS_RTOL,
           "seconds": secs}
    detail["card_vs_cpu_fit"] = res
    log(f"[card-vs-cpu fit] {res}")
    check(res["worst_grad_err_over_tol"] <= 1,
          f"card vs CPU fit: {res['worst_leaf']}'s gradient {res['worst_grad_err_over_tol']:.3g} "
          "x its limit")
    check(loss_err <= FIT_LOSS_RTOL, f"card vs CPU fit: logged losses {loss_err:.3g} apart")


def training_phases(detail) -> None:
    """Phases 27-29, the training slice, in a temporary directory removed
    at the end (the HF caches inside it; nothing is fetched)."""
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        os.environ[var] = "1"
    text = chain_text()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        os.environ["HF_HOME"] = str(Path(tmp) / "hf_home")
        fit_phase(detail, Path(tmp), text)
        protocol_phase(detail, Path(tmp), text)
        card_vs_cpu_fit(detail, text)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# slice 8, multi-device (phases 30-32): serve --mesh tp=2 through the CLI,
# a pair of rank workers against the single-process card run, NCCL at world
# size 1. The card holds one H100 and NCCL refuses two ranks on one device,
# so the pairs are two processes on cuda:0 over gloo
# ---------------------------------------------------------------------------

#: phase 31: the prefill of part (a), its greedy steps, and the prefill and
#: teacher-forced decode steps of parts (b) and (c)
MESH_PREFILL, MESH_GREEDY, MESH_T, MESH_DECODE = 128, 16, 16, 8
#: phase 31 (d): the ring's shape, B 1, 32/8 heads, head dim 128, causal
RING_SHAPE = (1, 32, 8, 8192, 128)
#: seconds a pair of ranks may take, spawn, load and build included
MESH_DEADLINE_S = 420
#: a greedy token of a sharded run may differ from the single-process one
#: only where the latter's top two logits lie within this fraction of its
#: largest |logit|: the sharded logits are held within that much (each
#: rank's row shard rounds its partial sum to bf16 before the f32 sum)
MESH_TIE_RTOL = LOGIT_RTOL


#: K1 at phases 30 and 31 (a)'s shard shapes (K, N): Qwen3-4B's four calls
#: of a layer at tp 2 (16 query and 4 KV heads, half of gate and of up,
#: down_proj's local K 4864), and down_proj at tp 4 (K 2432)
W4_LAYER_TP = {"qkv@tp2": (2560, 2048 + 2 * 512), "o_proj@tp2": (2048, 2560),
               "gate_up@tp2": (2560, 9728), "down@tp2": (4864, 2560), "down@tp4": (2432, 2560)}
#: K9 at phase 31 (c)'s shard shapes (K, N): path E's four fp8 calls of a
#: layer at tp 2
FP8_SHAPES_TP2 = {"q_proj": (2048, 1536), "o_proj": (1024, 2048), "gate_up": (2048, 8192),
                  "down": (4096, 2048)}


def mesh_kernels(gen, detail) -> dict:
    """The kernels of phases 30-31 at the shapes a rank gives them, each
    against its plain version: K1 at W4_LAYER_TP (m 8, timed, and the
    prefill's m 1024), K2 at a rank's heads at tp 2 (KV 4 rep 4, KV 2
    rep 8), K7 at E 64, K8 at H 8 and K9 at FP8_SHAPES_TP2 (m 8 and 128).
    Every check must launch its kernel (a refused shape raises)."""
    from quantizers_tpu_torch.ops import kernels as K

    before = K.launch_counts()
    rows = {"w4_matmul": {f"{label}@m{m}": r for m in (8, 1024)
                          for label, r in w4_layer(gen, m, timed=m == 8,
                                                   shapes=W4_LAYER_TP).items()},
            "decode_attention": {s: check_decode_attention(gen, False, s)
                                 for s in ("slice1_tp2", "path_A_tp2")},
            "moe_slot_gu_ffn": {f"w8pc@{r}": check_slot(gen, "w8pc", False, r, E=64)
                                for r in ("router", "one_expert", "all_distinct")},
            "mla_decode_attention": {f"L{L}": check_mla_decode(gen, L, False, H=8)
                                     for L in (192, MAX_LEN - 1)},
            "fp8_matmul": {f"{label}@m{m}": check_fp8(gen, k, n, m, timed=False)
                           for m in (8, 128) for label, (k, n) in FP8_SHAPES_TP2.items()}}
    rows["mla_decode_attention"]["mixed"] = check_mla_decode(gen, MLA_MIXED, False, H=8)
    launched = {name: n - before[name] for name, n in K.launch_counts().items()}
    check(all(launched[name] > 0 for name in rows),
          f"mesh shard shapes: a kernel did not launch: {launched}")
    for name, by_shape in rows.items():
        for label, r in by_shape.items():
            log(f"[kernels] {name} shard {label}: {r}")
    detail["kernels"]["mesh_shapes"] = rows
    return rows


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank: int, port: int) -> dict:
    """Rank ``rank`` of a pair on cuda:0 over gloo (the launch recipe of
    ``cli/serve.py`` for two ranks on one card)."""
    env = dict(os.environ)
    env.update({"QTPU_COORDINATOR": f"127.0.0.1:{port}", "QTPU_NUM_PROCESSES": "2",
                "QTPU_PROCESS_ID": str(rank), "LOCAL_RANK": "0", "QTPU_DIST_BACKEND": "gloo",
                "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))})
    return env


def run_pair(args: list, label: str) -> list:
    """This script with ``args`` as ranks 0 and 1 of a pair; each rank's
    stdout and stderr go to files (so that neither blocks on a full pipe
    while the other waits in a collective), the last of its stderr to the
    log. Both are killed past MESH_DEADLINE_S; a rank that fails fails the
    phase. Returns the ranks' stdout."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pair_") as tmp:
        files = [(open(Path(tmp) / f"out{r}", "w+"), open(Path(tmp) / f"err{r}", "w+"))
                 for r in range(2)]
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), *args],
                                  env=rank_env(r, port), cwd=ROOT, stdout=o, stderr=e, text=True)
                 for r, (o, e) in enumerate(files)]
        end = time.monotonic() + MESH_DEADLINE_S
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < end:
                if any(p.poll() not in (None, 0) for p in procs):
                    time.sleep(5)  # the other rank's own error, then stop it
                    break
                time.sleep(0.2)
        finally:
            timed_out = any(p.poll() is None for p in procs)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for r, (o, e) in enumerate(files):
            o.seek(0)
            e.seek(0)
            outs.append(o.read())
            for line in e.read().splitlines()[-40:]:
                log(f"[{label} rank {r}] {line}")
            o.close()
            e.close()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{label}: rank {r} exited {p.returncode}" +
              (f" (stopped: past {MESH_DEADLINE_S} s or after the other's failure)"
               if timed_out else ""))
    return outs


class BatcherResults:
    """The token ids each ``ContinuousBatcher.run`` of this process returns,
    by request id, while active."""

    def __enter__(self):
        from quantizers_tpu_torch.serve import session

        self.cls, self.orig, self.results = session.ContinuousBatcher, \
            session.ContinuousBatcher.run, {}
        orig, results = self.orig, self.results

        def run(batcher, *a, **kw):
            res = orig(batcher, *a, **kw)
            results.update(res)
            return res
        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig
        return False


def serve_rank(out_path: str, argv: list) -> int:
    """One rank of phase 30: ``cli/serve.main`` with ``argv``, its stdout,
    log records, launch counts and token ids written to ``out_path``."""
    from quantizers_tpu_torch.cli import serve
    from quantizers_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    with BatcherResults() as res:
        rc, out, rec = run_cli(serve.main, argv, "quantizers_tpu_torch.serve")
    torch.cuda.synchronize()
    steps, coll = rec.args("collectives")
    n_tok, n_prompts, gen_s, _ = rec.args("generated")
    Path(f"{out_path}.{os.environ['QTPU_PROCESS_ID']}").write_text(json.dumps({
        "rc": rc, "stdout": out, "launches": K.launch_counts(), "steps": steps,
        "collectives": coll, "load_s": rec.args("loaded")[1], "tokens": n_tok,
        "prompts": n_prompts, "generate_s": gen_s, "peak_gb": next(
            (r.args[0] for r in rec.records if r.msg.startswith("peak device memory")), None),
        "results": {str(k): v for k, v in res.results.items()}}))
    return 0


def serve_mesh_phase(ckpt: Path, text: Path, detail) -> dict:
    """Phase 30: ``cli/serve.main --mesh tp=2`` on path D's full-depth
    checkpoint, as two ranks on cuda:0 over gloo, with phase 10's 8 prompts
    and settings. Each rank loads the checkpoint on the host and keeps its
    shard on the card. Checks: rank 0 prints phase 10's rids, rank 1
    nothing; each rank launches K1, K2 and K3 only, K1 four times a layer a
    forward (q|k|v, o_proj, gate|up and the row-parallel down_proj at local
    K 4864), K3 once a forward, K2 once a layer a decode step; the tokens
    equal phase 10's up to a near-tie of the single-process logits at the
    first divergence."""
    from quantizers_tpu_torch.models import ModelSpec

    spec = ModelSpec(**GEOMETRY)
    L = spec.num_layers
    argv = serve_argv(ckpt, text) + ["--mesh", "tp=2"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_mesh_") as tmp:
        run_pair(["--serve-rank", str(Path(tmp) / "rank.json"), *argv], "phase 30")
        ranks = [json.loads((Path(tmp) / f"rank.json.{r}").read_text()) for r in range(2)]
    wall = time.perf_counter() - t0
    rids = [re.findall(r"^(\d+)\t", r["stdout"], re.M) for r in ranks]
    check(all(r["rc"] == 0 for r in ranks), "phase 30: serve --mesh returned non-zero")
    check(rids[0] == [str(i) for i in range(8)] and rids[1] == [],
          f"phase 30: rank 0 must print rids 0-7 and rank 1 nothing, got {rids}")
    ref = detail["path_D_serve"]["token_ids"]
    for r, rk in enumerate(ranks):
        c = rk["launches"]
        fwd = c["w8_matmul"]
        want = expect(w4_matmul=4 * L * fwd, w8_matmul=fwd, decode_attention=L * rk["steps"])
        check(fwd > 0 and c == want, f"phase 30 rank {r}: launches {c} != {want} "
                                     f"(K1 on all four projections, K2, K3)")
        check(rk["results"] == ranks[0]["results"], f"phase 30: rank {r}'s tokens differ")
    got = ranks[0]["results"]
    check(sorted(got) == sorted(ref), f"phase 30: rids {sorted(got)} != phase 10's {sorted(ref)}")
    same = total = 0
    parts = {}  # rid -> the first token where phase 30 parts from phase 10
    for rid in sorted(ref, key=int):
        a, b = got[rid], ref[rid]
        n = min(len(a), len(b))
        same += sum(int(x == y) for x, y in zip(a[:n], b[:n]))
        total += max(len(a), len(b))
        d = next((i for i in range(n) if a[i] != b[i]), None if len(a) == len(b) else n)
        if d is not None:
            parts[rid] = d
    ties = single_process_gaps(ckpt, text, {rid: ref[rid][:d] for rid, d in parts.items()})
    for rid, tie in ties.items():
        check(tie["gap"] <= tie["window"], f"phase 30: rid {rid} parts from phase 10 at token "
                                           f"{parts[rid]}, where the gap is no near-tie: {tie}")
    r0 = ranks[0]
    ar = r0["collectives"].get("all_reduce", {"calls": 0, "seconds": 0.0})
    fwd = max(r0["launches"]["w8_matmul"], 1)
    res = {"ranks": 2, "backend": "gloo", "device": "cuda:0 (both ranks)", "layers": L,
           "prompts": 8, "tokens": r0["tokens"], "steps": r0["steps"], "forwards": fwd,
           "load_s": [rk["load_s"] for rk in ranks], "generate_s": r0["generate_s"],
           "tok_s": r0["tokens"] / r0["generate_s"], "ms_per_step": r0["generate_s"] /
           r0["steps"] * 1e3, "peak_memory_gb": [rk["peak_gb"] for rk in ranks],
           "all_reduces": ar["calls"], "all_reduces_per_forward": ar["calls"] / fwd,
           "all_reduce_s": ar["seconds"], "all_reduce_ms_per_forward": ar["seconds"] / fwd * 1e3,
           "collectives": r0["collectives"], "launches": [rk["launches"] for rk in ranks],
           "token_share_equal": same / total, "first_divergence": parts,
           "gaps_there": ties,
           "phase_10": {k: detail["path_D_serve"][k] for k in ("load_s", "generate_s")},
           "wall_s": wall}
    detail["serve_mesh"] = res
    log(f"[phase 30] {res}")
    check(ar["calls"] == 2 * L * fwd, f"phase 30: {ar['calls']} all-reduces, want two a layer "
                                       f"a forward ({2 * L * fwd})")
    return res


@torch.no_grad()
def single_process_gaps(ckpt: Path, text: Path, prefixes: dict) -> dict:
    """The single-process model's top-two gap where phase 30 first parted
    from phase 10, for each rid of ``prefixes`` (rid -> phase 10's tokens
    before that point): path D's checkpoint laid out as phase 10 serves it,
    on the card, one forward over the prompt and the prefix. A gap within
    MESH_TIE_RTOL of the largest |logit| is a near-tie."""
    from quantizers_tpu_torch.data.simple_tokenizer import load_tokenizer
    from quantizers_tpu_torch.models import forward
    from quantizers_tpu_torch.models.loader import load_checkpoint
    from quantizers_tpu_torch.serve import serving_layout

    if not prefixes:
        return {}
    spec, params, _ = load_checkpoint(ckpt)
    params = serving_layout(spec, params, head_bits=8)
    tok, prompts = load_tokenizer(str(ckpt)), serve_prompts(text)
    out = {}
    for rid, prefix in prefixes.items():
        ids = tok(prompts[int(rid)])["input_ids"] + list(prefix)
        lg = forward(params, spec, torch.tensor([ids], device=params["embed"].device))[0][0, -1]
        lg = lg.float()
        top2 = lg.topk(2).values
        out[rid] = {"gap": float(top2[0] - top2[1]),
                    "window": MESH_TIE_RTOL * float(lg.abs().max()),
                    "max_abs_logit": float(lg.abs().max())}
    del params
    torch.cuda.empty_cache()
    return out


def build_w4_params(spec, gen):
    """Qwen3-4B params as path D's checkpoint holds them: random bf16
    weights (std 0.02, the seeded generator) quantized to W4A16 g32 by the
    port (``core.numerics.quantize``, ``from_quantized``), unit norms, a
    tied bf16 embedding of std 0.02. (``build_params``' uniform codes give
    every weight a mean of -0.004, whose 2-layer prefill logits the card's
    own bf16 products already move by 12% from the CPU's f32 ones: too
    ill-conditioned to hold a sharded run to 2%.)"""
    from quantizers_tpu_torch.core import PRESET_SCHEMES, quantize
    from quantizers_tpu_torch.ops.linear import from_quantized

    args = PRESET_SCHEMES["W4A16_G32"].weights
    dev = gen.device
    D, Ff, hd = spec.hidden_size, spec.intermediate_size, spec.head_dim

    def lin(n, k):
        w = (torch.randn((n, k), device=dev, generator=gen) * 0.02).bfloat16()
        return from_quantized(quantize(w, args), args)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    layers = [{"input_layernorm": ones(D), "post_attention_layernorm": ones(D),
               "q_proj": lin(spec.q_dim, D), "k_proj": lin(spec.kv_dim, D),
               "v_proj": lin(spec.kv_dim, D), "o_proj": lin(D, spec.q_dim),
               "q_norm": ones(hd), "k_norm": ones(hd),
               "mlp": {"gate_proj": lin(Ff, D), "up_proj": lin(Ff, D), "down_proj": lin(D, Ff)}}
              for _ in range(spec.num_layers)]
    embed = (torch.randn((spec.vocab_size, D), device=dev, generator=gen) * 0.02).bfloat16()
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": None}


@torch.no_grad()
def mesh_part_dense(spec, params, ids, dev) -> dict:
    """Phase 31 (a): Qwen3-4B at 2 layers as ``serving_layout(head_bits=8)``
    serves it, a teacher-forced (8, 128) prefill through the caches, then
    MESH_GREEDY greedy steps."""
    from quantizers_tpu_torch.models import KVCache, forward
    from quantizers_tpu_torch.serve import serving_layout

    p = serving_layout(spec, params, head_bits=8, device=dev)
    caches = KVCache.init(spec, ids.shape[0], MAX_LEN, device=dev)
    prefill, caches = forward(p, spec, ids, caches=caches)
    chose, toks = [prefill[:, -1]], []
    for _ in range(MESH_GREEDY):
        toks.append(chose[-1].argmax(-1))
        lg, caches = forward(p, spec, toks[-1][:, None], caches=caches)
        chose.append(lg[:, 0])
    torch.cuda.synchronize()
    return {"prefill": prefill, "tokens": torch.stack(toks, 1), "chose": torch.stack(chose[:-1], 1)}


@torch.no_grad()
def mesh_part_forced(spec, params, ids, dev, replay=None) -> dict:
    """Phase 31 (b) and (c): ``serving_layout(head_bits=8)``, a (8, MESH_T)
    prefill, then MESH_DECODE teacher-forced one-token steps (8 tokens of
    top-8: 64 slots, the slot kernel's path); the last position's logits of
    each, and the router's decisions (replaying ``replay``'s where given)."""
    from quantizers_tpu_torch.models import KVCache, forward
    from quantizers_tpu_torch.serve import serving_layout

    p = serving_layout(spec, params, head_bits=8, device=dev)
    caches = KVCache.init(spec, ids.shape[0], 64, device=dev)
    with RouteRecorder(replay) as rec:
        lg, caches = forward(p, spec, ids[:, :MESH_T], caches=caches)
        logits = [lg[:, -1]]
        for t in range(MESH_T, MESH_T + MESH_DECODE):
            lg, caches = forward(p, spec, ids[:, t:t + 1], caches=caches)
            logits.append(lg[:, -1])
    torch.cuda.synchronize()
    moe = spec.is_moe and "gate_up_proj" in p["layers"][0]["moe"]
    return {"logits": torch.stack(logits, 1), "routes": rec.calls, "w8pc": moe}


def ring_plain(q, k, v, sm: float) -> torch.Tensor:
    """Causal GQA attention as one f32 einsum, the group folded into q."""
    B, H, T, d = q.shape
    KV = k.shape[1]
    qg = q.float().reshape(B, KV, H // KV, T, d)
    s = torch.einsum("bgrtd,bgsd->bgrts", qg, k.float()) * sm
    idx = torch.arange(T, device=q.device)
    s = s.masked_fill(idx[None, :] > idx[:, None], -1e30)
    out = torch.einsum("bgrts,bgsd->bgrtd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, H, T, -1).to(q.dtype)


def mesh_rank(job_dir: str) -> int:
    """One rank of phase 31: parts (a)-(c) at tp 2 and (d) at cp 2 on the
    job's weights and inputs, each with its launch counts set to 0 just
    before its drive and read just after; outputs to ``rank_<r>.pt``."""
    import hashlib

    import torch.distributed as dist

    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.parallel import initialize, make_mesh, ring_attention, shard_params
    from quantizers_tpu_torch.parallel import collectives
    from quantizers_tpu_torch.parallel.distributed import local_device, shutdown

    t0 = time.perf_counter()
    check(initialize() is True, "phase 31: initialize() brought up no process group")
    r, dev = dist.get_rank(), local_device()
    tp, cp = make_mesh({"tp": 2}), make_mesh({"cp": 2})
    job = torch.load(Path(job_dir) / "job.pt", weights_only=False)
    out = {"rank": r, "init_s": time.perf_counter() - t0, "parts": {}}

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    for part in ("a", "b", "c"):
        spec, raw, ids = job[part]["spec"], job[part]["params"], job[part]["ids"].to(dev)
        t1 = time.perf_counter()
        spec_l, shard = shard_params(spec, raw, tp)
        shard_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        collectives.reset_stats()
        K.reset_launch_counts()
        t1 = time.perf_counter()
        if part == "a":
            res = mesh_part_dense(spec_l, shard, ids, dev)
        else:
            res = mesh_part_forced(spec_l, shard, ids, dev, job[part].get("routes"))
        drive_s = time.perf_counter() - t1
        res.update(launches=K.launch_counts(), collectives=collectives.stats(), shard_s=shard_s,
                   drive_s=drive_s, heads=(spec_l.num_heads, spec_l.num_kv_heads),
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   digest=digest(res.get("prefill", res.get("logits"))))
        out["parts"][part] = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                              for k, v in res.items()}
        del shard, res
        torch.cuda.empty_cache()
    q, k, v = (job["d"][n].to(dev) for n in ("q", "k", "v"))
    sm = 1 / math.sqrt(q.shape[-1])
    ring_attention(q[..., :1024, :], k[..., :1024, :], v[..., :1024, :], sm, cp)  # warm
    torch.cuda.synchronize()
    collectives.reset_stats()
    K.reset_launch_counts()
    t1 = time.perf_counter()
    ring = ring_attention(q, k, v, sm, cp)
    torch.cuda.synchronize()
    out["parts"]["d"] = {"out": ring.cpu(), "ring_s": time.perf_counter() - t1,
                         "launches": K.launch_counts(), "collectives": collectives.stats(),
                         "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                         "digest": digest(ring)}
    torch.save(out, Path(job_dir) / f"rank_{r}.pt")
    shutdown()
    return 0


def mesh_job(gen, tmp: Path) -> tuple:
    """Phase 31's weights and inputs, made on the card from the seeded
    generator and saved for the ranks as host tensors; and the single-process
    card run of each part on them."""
    from quantizers_tpu_torch.models import ModelSpec
    from quantizers_tpu_torch.models.transformer import tree_to

    cpu = torch.device("cpu")
    job, ref = {}, {}
    spec = ModelSpec(**dict(GEOMETRY, num_layers=2))
    raw = build_w4_params(spec, gen)
    ids = torch.randint(1, spec.vocab_size, (BATCH, MESH_PREFILL), device=gen.device,
                        generator=gen)
    ref["a"] = mesh_part_dense(spec, raw, ids, gen.device)
    job["a"] = {"spec": spec, "params": tree_to(raw, cpu), "ids": ids.cpu()}
    keep = (spec, raw, ids)
    spec = ModelSpec(**dict(MOE_GEOMETRY, num_layers=2))
    raw = build_moe_params(spec, gen, "packed")
    ids = torch.randint(1, spec.vocab_size, (BATCH, MESH_T + MESH_DECODE), device=gen.device,
                        generator=gen)
    ref["b"] = mesh_part_forced(spec, raw, ids, gen.device)
    check(ref["b"]["w8pc"], "phase 31 (b): the single-process run has no w8pc experts")
    job["b"] = {"spec": spec, "params": tree_to(raw, cpu), "ids": ids.cpu(),
                "routes": ref["b"]["routes"]}
    del raw
    spec = ModelSpec(**dict(MLA_GEOMETRY, num_layers=1))
    raw = build_fp8_mla_params(spec, gen)
    ids = torch.randint(1, spec.vocab_size, (BATCH, MESH_T + MESH_DECODE), device=gen.device,
                        generator=gen)
    ref["c"] = mesh_part_forced(spec, raw, ids, gen.device)
    job["c"] = {"spec": spec, "params": tree_to(raw, cpu), "ids": ids.cpu()}
    del raw
    B, H, KV, T, d = RING_SHAPE
    q = torch.randn((B, H, T, d), device=gen.device, generator=gen).bfloat16()
    k, v = (torch.randn((B, KV, T, d), device=gen.device, generator=gen).bfloat16()
            for _ in range(2))
    job["d"] = {"q": q.cpu(), "k": k.cpu(), "v": v.cpu()}
    ref["d"] = {"q": q, "k": k, "v": v}
    torch.save(job, tmp / "job.pt")
    return ref, keep


def greedy_agree(label: str, got: torch.Tensor, ref: torch.Tensor, chose: torch.Tensor) -> dict:
    """Greedy tokens (B, n) against the single-process run's, whose logits
    ``chose`` (B, n, V) picked them: a row may part only where those logits'
    top two lie within MESH_TIE_RTOL of their largest |logit|."""
    rows = []
    for b in range(ref.shape[0]):
        differ = (got[b] != ref[b]).nonzero()
        if differ.numel():
            t = int(differ[0])
            lg = chose[b, t].float()
            top2 = lg.topk(2).values
            gap, window = float(top2[0] - top2[1]), MESH_TIE_RTOL * float(chose.float().abs().max())
            rows.append({"row": b, "step": t, "gap": gap, "window": window})
            check(gap <= window, f"{label}: row {b} parts from the single-process tokens at "
                                 f"step {t}, where the gap {gap:.4g} is no near-tie ({window:.4g})")
    return {"tokens_equal": float((got == ref).float().mean()), "divergences": rows}


def mesh_pair_phase(gen, detail) -> tuple:
    """Phase 31: the pair of ranks (this script, ``--mesh-rank``) against the
    single-process card run on the same seeded weights: (a) Qwen3-4B at
    full width, 2 layers, tp 2 (K1 at the shard shapes, K2 at KV 4 rep 4,
    K3); (b) Qwen3-30B-A3B, 2 layers, tp 2, w8pc experts split over tp (K7
    at E 64, K2 at KV 2 rep 8), the router's picks replayed after they are
    compared; (c) path E's FP8_BLOCK MLA layer at tp 2 (K9 at the shard
    shapes, K8 at H 8); (d) ``ring_attention`` at cp 2 against the
    single-process flash kernel (K4) and the plain einsum."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        t0 = time.perf_counter()
        ref, keep = mesh_job(gen, Path(tmp))
        job_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_pair(["--mesh-rank", tmp], "phase 31")
        pair_s = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank_{r}.pt", weights_only=False) for r in range(2)]
    got = {p: ranks[0]["parts"][p] for p in "abcd"}
    for p in "abcd":
        check(ranks[0]["parts"][p]["digest"] == ranks[1]["parts"][p]["digest"],
              f"phase 31 ({p}): the two ranks' outputs differ")
    res = {"job_s": job_s, "pair_s": pair_s, "init_s": [r["init_s"] for r in ranks]}
    # (a)
    a, ra = got["a"], ref["a"]
    res["a"] = {"prefill": logits_agree("phase 31 (a) prefill", a["prefill"].float(),
                                        ra["prefill"].float().cpu(), tie_rtol=MESH_TIE_RTOL),
                "greedy": greedy_agree("phase 31 (a)", a["tokens"], ra["tokens"].cpu(),
                                       ra["chose"].cpu())}
    check(a["launches"] == expect(w4_matmul=a["launches"]["w4_matmul"],
                                  decode_attention=2 * MESH_GREEDY, w8_matmul=MESH_GREEDY)
          and a["launches"]["w4_matmul"] == 2 * 4 * MESH_GREEDY,
          f"phase 31 (a): launches {a['launches']}")
    # (b)
    b, rb = got["b"], ref["b"]
    flips = near = 0
    for c, ((ti, _, _), (ri, pk, pk1)) in enumerate(zip(b["routes"], rb["routes"])):
        for n in range(ri.shape[0]):
            tie = bool(pk[n] - pk1[n] <= ROUTE_GAP_RTOL * pk[n])
            near += int(tie)
            if set(ti[n].tolist()) != set(ri[n].tolist()):
                flips += 1
                check(tie, f"phase 31 (b): router pick differs at call {c}, token {n}, no near-tie")
    check(len(b["routes"]) == len(rb["routes"]) == 2 * (1 + MESH_DECODE),
          "phase 31 (b): router calls")
    res["b"] = {"router_decisions": sum(x[0].shape[0] for x in rb["routes"]),
                "router_flips": flips, "router_near_ties": near,
                "logits": logits_agree("phase 31 (b) decode", b["logits"].float(),
                                       rb["logits"].float().cpu(), tie_rtol=MESH_TIE_RTOL)}
    # K3: the heads (the prefill's and each step's) and, in the prefill's loop
    # over a rank's 64 experts, their gate|up and down in each of 2 layers
    check(b["w8pc"] and b["launches"] == expect(
        moe_slot_gu_ffn=2 * MESH_DECODE, decode_attention=2 * MESH_DECODE,
        w8_matmul=1 + MESH_DECODE + 2 * 2 * MOE_GEOMETRY["num_experts"] // 2),
        f"phase 31 (b): launches {b['launches']}")
    # (c)
    c_, rc = got["c"], ref["c"]
    res["c"] = {"logits": logits_agree("phase 31 (c) decode", c_["logits"].float(),
                                       rc["logits"].float().cpu(), tie_rtol=MESH_TIE_RTOL)}
    check(c_["launches"] == expect(fp8_matmul=4 * (1 + MESH_DECODE),
                                   mla_decode_attention=MESH_DECODE, w8_matmul=1 + MESH_DECODE),
          f"phase 31 (c): launches {c_['launches']}")
    # (d)
    from quantizers_tpu_torch.ops import flash

    q, k, v = (ref["d"][n] for n in ("q", "k", "v"))
    sm = 1 / math.sqrt(q.shape[-1])
    flash.flash_attention(q, k, v, sm)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fl = flash.flash_attention(q, k, v, sm)
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t0
    plain = ring_plain(q, k, v, sm)
    ring = got["d"]["out"].to(q.device).float()
    errs = {}
    for name, want in (("flash", fl.float()), ("plain", plain.float())):
        err = float((ring - want).abs().max())
        errs[name] = {"max_abs_err": err, "tol": LOGIT_RTOL * float(want.abs().max())}
        check(err <= errs[name]["tol"], f"phase 31 (d): ring vs {name}: {errs[name]}")
    check(sum(got["d"]["launches"].values()) == 0, "phase 31 (d): the ring launched a kernel")
    res["d"] = {"shape": list(RING_SHAPE), "ring_s": got["d"]["ring_s"], "flash_s": flash_s,
                "hops": got["d"]["collectives"].get("ring_hop", {}), **errs}
    for p in "abc":
        res[p].update({k: got[p][k] for k in ("launches", "collectives", "shard_s", "drive_s",
                                             "heads")},
                      peak_gb=[r["parts"][p]["peak_gb"] for r in ranks])
    res["d"]["peak_gb"] = [r["parts"]["d"]["peak_gb"] for r in ranks]
    detail["mesh_pair"] = res
    log(f"[phase 31] {json.dumps(res, default=str)[:4000]}")
    del ref
    torch.cuda.empty_cache()
    return res, keep


def nccl_phase(detail, keep) -> dict:
    """Phase 32: NCCL in this process at world size 1: ``initialize``, one
    all-reduce, and phase 31 (a)'s forward through the mesh path at tp 1,
    equal to the plain path bit for bit; then the group is destroyed."""
    import torch.distributed as dist

    from quantizers_tpu_torch.models import forward
    from quantizers_tpu_torch.parallel import initialize, make_mesh, shard_params
    from quantizers_tpu_torch.parallel.distributed import shutdown

    spec, raw, ids = keep
    t0 = time.perf_counter()
    check(initialize(f"127.0.0.1:{free_port()}", 1, 0, local_device_ids=[0], backend="nccl"),
          "phase 32: initialize")
    check(dist.get_backend() == "nccl", f"phase 32: backend {dist.get_backend()}")
    t = torch.arange(1024, dtype=torch.float32, device=ids.device)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    check(torch.equal(t, torch.arange(1024, dtype=torch.float32, device=ids.device)),
          "phase 32: all_reduce at world size 1 changed the tensor")
    mesh = make_mesh({"tp": 1})
    spec_l, p = shard_params(spec, raw, mesh)
    with torch.no_grad():
        got, _ = forward(p, spec_l, ids[:2, :64])
        want, _ = forward(raw, spec, ids[:2, :64])
    check(torch.equal(got, want), "phase 32: the tp 1 mesh path differs from the plain path")
    shutdown()
    check(not dist.is_initialized(), "phase 32: the process group is still up")
    res = {"backend": "nccl", "world": 1, "seconds": time.perf_counter() - t0,
           "forward_equal": True}
    detail["nccl"] = res
    log(f"[phase 32] {res}")
    return res


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

    detail = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": _build.INFO.seconds}
    out_dir = ROOT / "chiprun_out"
    if sys.argv[1:] == ["--calibration-scale"]:
        for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
            os.environ[var] = "1"
        calibration_scale(detail)
        detail["total_s"] = time.perf_counter() - t_start
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_calibration_scale.json").write_text(json.dumps(detail, indent=1))
        log(f"[done] {detail['total_s']:.1f} s")
        return 0
    check(not sys.argv[1:], f"chip_smoke: unknown arguments {sys.argv[1:]}")

    # phase 3: kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    w8a8_rows = w8a8_kernels(gen, detail)
    gptq_rows = gptq_kernels(gen, detail)
    # the kernels of phases 30-31 at a rank's shard shapes
    shard_rows = mesh_kernels(gen, detail)
    phase_s = detail["phase_s"] = {"kernels": time.perf_counter() - t_start}

    def lap(name: str) -> None:
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    # phase 4: serve, slice 1
    spec, raw, counts = serve_phase(gen, detail)
    lap("slice1")

    # phase 5: serve, slice 2, path A (the main path), and its batcher
    spec_moe, params_moe, counts_moe = serve_moe_phase(gen, detail)
    moe_batcher_phase(spec_moe, params_moe, gen, detail)
    del params_moe
    torch.cuda.empty_cache()
    lap("path_A")

    # phase 6: paths B and C
    side = side_paths_phase(gen, detail)
    torch.cuda.empty_cache()
    lap("paths_B_C")

    # phase 7: card against CPU
    card_vs_cpu(detail)
    card_vs_cpu_moe(detail)
    lap("card_vs_cpu")

    # phase 8: batcher, slice 1
    batcher_phase(spec, raw, gen, detail)
    del raw
    torch.cuda.empty_cache()
    lap("batcher")

    # phases 9-11: path D (slice 3's main path), its serve run, card against
    # CPU; the checkpoints live in a temporary directory, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        _, ckpt, text, counts_d = eval_phase(gen, detail, Path(tmp))
        serve_cli_phase(ckpt, text, detail)
        torch.cuda.empty_cache()
        lap("path_D")
        # phase 30: serve --mesh tp=2 on the same checkpoint, two ranks on the card
        serve_mesh_phase(ckpt, text, detail)
        lap("serve_mesh")
        card_vs_cpu_ppl(gen, detail, Path(tmp), text)
    lap("path_D_card_vs_cpu")

    # phases 12-14: path E (slice 5's main path), its batcher, card against CPU
    spec_e, params_e, counts_e = serve_mla_phase(gen, detail)
    mla_batcher_phase(spec_e, params_e, gen, detail)
    del params_e
    torch.cuda.empty_cache()
    card_vs_cpu_mla(detail, synthetic_text())
    lap("path_E")

    # phases 16-26: paths F, H, I, K, J, L and G, and the engine card against CPU
    drive_i = oneshot_phases(detail)
    lap("oneshot")

    # phases 27-29: the training slice (fit_lm at full width, the perplexity
    # protocol through the CLIs, card against CPU)
    training_phases(detail)
    lap("training")

    # phases 31-32: the pair of rank workers against the single-process run,
    # then NCCL at world size 1 in this process
    _, keep = mesh_pair_phase(gen, detail)
    lap("mesh_pair")
    nccl_phase(detail, keep)
    del keep
    torch.cuda.empty_cache()
    lap("nccl")

    # phase 15: the kernels line (w4, the NVFP4 and the fp8 matmuls: the four
    # calls of one decoder layer at m = 8, summed; K11: the 208 launches of
    # one Qwen3-4B layer's GPTQ solve, summed)
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

    def served_sum(rows, m, suffix=""):
        """K10 on path I's served layer (its four calls) at ``m`` rows, summed."""
        timed = [rows[f"{name}@m{m}"] for name in QWEN3_SERVED]
        return {key + suffix: total(timed, key)
                for key in ("ms", "dev_ms", "plain_ms", "bound_ms", "library_ms",
                            "library_dev_ms", "unfused_ms", "unfused_dev_ms")}

    src = "quantizers_tpu_torch/csrc/"
    w8_all = dict(w8_rows, **s2["w8_matmul_f32"])
    k11_layer = detail["path_J"]["gptq_w4a16_g32"]["k11_layer"]
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
        # K10: the W8A8 linear, its quantizer inside, on path I's served
        # layer (q|k|v, o, gate|up, down: its four calls) at m 8 summed (a
        # decoder layer's decode work), and at m 1024; "unfused": the
        # PyTorch quantizer, then K10's GEMM alone
        {"name": "w8a8_token_matmul", "route": "cuda", "source": src + "w8a8_matmul.cuh",
         "replaces": "quantizers_tpu/ops/dispatch.py:33",
         "launches": drive_i["decode_launches"]["w8a8_token_matmul"], "path": "I decode",
         "max_abs_err": max(r["max_abs_err"] for r in w8a8_rows.values() if "max_abs_err" in r),
         "tol": 0.0, **served_sum(w8a8_rows, 8), "bound_by": "bytes",
         **served_sum(w8a8_rows, 1024, "_m1024"), "bound_by_m1024": "operations"},
        # K11: path J's symmetric g32 run; its layer 1's 208 launches as
        # that run traced them, the plain version on the same inputs
        {"name": "gptq_block", "route": "cuda", "source": src + "gptq_block.cu",
         "replaces": "quantizers_tpu/oneshot/gptq.py:61",
         "launches": detail["path_J"]["gptq_w4a16_g32"]["oneshot"]["launches"]["gptq_block"],
         "path": "J calibration solve",
         "max_abs_err": max(r["max_abs_err"] for r in gptq_rows.values() if "max_abs_err" in r),
         "tol": 0.0, **{key: k11_layer[key] for key in ("ms", "dev_ms", "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library_ms": None},
    ]
    # each kernel's launches under the mesh: phase 30's rank 0 and phase 31's
    # parts (the ranks' counts are equal)
    mesh_runs = {"phase 30 rank 0": detail["serve_mesh"]["launches"][0],
                 **{f"phase 31 ({p})": detail["mesh_pair"][p]["launches"] for p in "abc"}}
    for k in kernels_line:
        k["mesh_launches"] = {run: c[k["name"]] for run, c in mesh_runs.items()
                              if c.get(k["name"])}
        if k["name"] in shard_rows:  # checked at the shard shapes in phase 3
            k["mesh_shapes"] = {f"mesh_{key}": v for key, v in worst(shard_rows[k["name"]]).items()}
            k["mesh_shapes"]["checked"] = sorted(shard_rows[k["name"]])
    check(all(k["launches"] > 0 for k in kernels_line), "a kernel never launched on its path")
    check(kernels_line[-2]["max_abs_err"] == 0.0, "w8a8_token_matmul: not bit-exact")
    check(kernels_line[-1]["max_abs_err"] == 0.0, "gptq_block: not bit-exact")
    detail["total_s"] = time.perf_counter() - t_start
    log(f"[phases] seconds: {phase_s}")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(json.dumps(detail, indent=1))
    log(f"[done] {detail['total_s']:.1f} s; serve {json.dumps(detail['serve'])}; "
        f"path A {json.dumps({k: v for k, v in detail['serve_moe'].items() if k != 'profile'})}; "
        f"path E {json.dumps({k: v for k, v in detail['serve_mla'].items() if k != 'profile'})}")
    print(json.dumps({"path_I_decode": {
        key: drive_i[key] for key in ("layers", "ms_per_step", "device_busy_ms_per_step",
                                      "idle_share", "launches_per_step")}}))
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--mesh-rank"], ["--serve-rank"]):
        # a rank of phase 30 or 31, started by this script
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sys.exit(mesh_rank(sys.argv[2]) if sys.argv[1] == "--mesh-rank"
                 else serve_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
