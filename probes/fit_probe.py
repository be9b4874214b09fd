#!/usr/bin/env python3
"""Phase 27's fit taken apart on the card: where its memory and its time go.

    python3 probes/fit_probe.py [--layers 8,12] [--steps 12] [--profile-steps 4]

For each depth, Qwen3-4B's widths (``chip_smoke.GEOMETRY``) with seeded
weights, ``fit_lm``'s own loop (``models/fit.py``: ``trainable``,
``lm_loss``, fused AdamW) at ``chip_smoke.FIT_ARGS``'s batch and window on
the protocol's chain corpus, with the device memory read between its
parts: the bf16 originals, the f32 masters, what the forward keeps for the
backward, the backward's peak and its gradients, AdamW's state and the
step's peak, and the steady step's peak. At the first depth, also
``torch.profiler`` over ``--profile-steps`` steady steps: device time by
kernel family, the device's busy share of the step, and the 25 costliest
kernels. From two depths: the memory a layer adds and the deepest fit that
one card holds. Writes ``chiprun_out/fit_probe.json`` and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: kernel families by name, first match wins
FAMILIES = (("adamw", r"adam|multi_tensor_apply"),
            ("matmul", r"gemm|xmma|cutlass|sm90|ampere_|cublas|nvjet"),
            ("softmax", r"softmax"), ("index/embedding", r"index|embedding|scatter|gather"),
            ("reduce", r"reduce|norm"), ("cast/copy", r"copy|convert|to_copy|cast"),
            ("elementwise", r"elementwise|vectorized|unrolled"))


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.I):
            return fam
    return "other"


def gb(x: float) -> float:
    return x / 1e9


def one_depth(c, layers: int, steps: int, profile_steps: int) -> dict:
    from quantizers_tpu_torch.data import ByteTokenizer
    from quantizers_tpu_torch.models import ModelSpec, init_params
    from quantizers_tpu_torch.models import fit as TFIT

    spec = ModelSpec(**dict(c.GEOMETRY, num_layers=layers))
    ids = np.asarray(ByteTokenizer()(c.chain_text())["input_ids"], np.int64)
    B, T = c.FIT_ARGS["batch_size"], c.FIT_ARGS["seq_len"]
    rng = np.random.default_rng(0)
    batches = torch.as_tensor(np.stack([
        np.stack([ids[s:s + T + 1] for s in rng.integers(0, len(ids) - T - 1, B)])
        for _ in range(steps)]), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mem = {}

    def read(name: str, peak: bool = False) -> None:
        torch.cuda.synchronize()
        mem[name] = gb((torch.cuda.max_memory_allocated() if peak
                        else torch.cuda.memory_allocated()) - base)

    params = init_params(spec, seed=27, device="cuda")
    n_params = sum(t.numel() for _, t in c.param_paths(params))
    read("bf16_originals")
    params32, leaves = TFIT.trainable(params)
    read("plus_f32_masters")
    opt, sched = TFIT.make_optimizer(leaves, c.FIT_ARGS["lr"], steps)
    torch.cuda.reset_peak_memory_stats()
    loss = TFIT.lm_loss(spec, params32, batches[0])
    read("after_forward")
    read("forward_peak", peak=True)
    torch.cuda.reset_peak_memory_stats()
    loss.backward()
    read("backward_peak", peak=True)
    del loss
    read("after_backward")
    torch.cuda.reset_peak_memory_stats()
    opt.step()
    sched.step()
    read("step_peak", peak=True)
    opt.zero_grad(set_to_none=True)
    read("after_step")

    def step(i: int):
        loss = TFIT.lm_loss(spec, params32, batches[i])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        return loss

    torch.cuda.reset_peak_memory_stats()
    for i in range(1, 4):
        step(i)
    read("steady_peak", peak=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = steps - 4 - profile_steps
    for i in range(4, 4 + timed):
        step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    out = {"layers": layers, "parameters": n_params, "ms_per_step": ms, "memory_gb": mem,
           "reckoned_gb": {"bf16_originals": gb(2 * n_params), "f32_masters": gb(4 * n_params),
                           "grads": gb(4 * n_params), "adam_m_v": gb(8 * n_params),
                           "bf16_casts": gb(2 * n_params)},
           "logits_f32_gb": gb(B * T * spec.vocab_size * 4)}
    if profile_steps:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps - profile_steps, steps):
                step(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / profile_steps * 1e3
        from torch.autograd import DeviceType

        kernels = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            # kernels and copies only: the optimizer's user ranges
            # ("Optimizer.step#AdamW.step") also carry the device time of
            # the kernels inside them
            if (e.device_type == DeviceType.CUDA and us > 0
                    and not e.key.startswith(("Optimizer.", "ProfilerStep"))):
                kernels.append((us / 1e3 / profile_steps, e.key, e.count / profile_steps))
        fams: dict = {}
        for ms_step, key, _ in kernels:
            fams[family(key)] = fams.get(family(key), 0.0) + ms_step
        busy = sum(fams.values())
        top = sorted(kernels, reverse=True)[:25]
        out["profile"] = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
                          "idle_share": 1 - busy / wall,
                          "idle_share_of_unprofiled_step": 1 - busy / ms,
                          "by_family_ms_per_step": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
                          "top_kernels": [{"name": key[:120], "calls_per_step": calls,
                                           "ms_per_step": ms_step}
                                          for ms_step, key, calls in top]}
    del params, params32, leaves, opt, sched, batches
    torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", default="8,12")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--profile-steps", type=int, default=4)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("fit_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    depths = [int(x) for x in args.layers.split(",")]
    runs = [one_depth(c, n, args.steps, args.profile_steps if i == 0 else 0)
            for i, n in enumerate(depths)]
    out = {"card": card, "runs": runs}
    if len(runs) >= 2:
        a, b = runs[0], runs[-1]
        per_layer = ((b["memory_gb"]["steady_peak"] - a["memory_gb"]["steady_peak"])
                     / (b["layers"] - a["layers"]))
        total = torch.cuda.get_device_properties(0).total_memory / 1e9
        out["per_layer_gb"] = per_layer
        out["card_gb"] = total
        out["deepest_fit_layers"] = int(a["layers"] + (total - a["memory_gb"]["steady_peak"])
                                        // per_layer)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fit_probe.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
