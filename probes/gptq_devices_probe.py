#!/usr/bin/env python3
"""Phase 23's GPTQ problems taken apart on the card and the CPU: do the
devices' solves of one problem (one W, one H) part further than one f32
ulp of H moves a solve on either device?

    python3 probes/gptq_devices_probe.py [--draws N] [--init-layers N] [--seed S]

Writes the 2-layer cut of path F's Qwen3-4B bf16 model (``chip_smoke``'s
F_SEED, initialized at ``--init-layers`` layers: 12 is what
``chip_smoke.oneshot_dense_phase`` writes), runs the CPU's ``oneshot``
with ``chip_smoke.GPTQ_G32`` over phase 23's calibration batches and
records each of its 14 GPTQ problems. Then, for each problem, every
objective relative to the CPU's own solve (tr((W - W^) H (W - W^)^T), in
f64, on the CPU's W and H):

- ``card``: the card's solve (phase 23's ``same_h``);
- ``card_with_cpu_u`` / ``cpu_with_card_u``: each device's elimination
  with the other's factor U of H^-1 (is it the factor or the elimination
  that parts them?);
- ``card_f64_u`` / ``cpu_f64_u``: both with the f64 factor rounded to f32;
- ``cpu_witness`` / ``card_witness``: each device's solves with every
  entry of H moved by one f32 ulp (``chip_smoke.one_ulp_apart``), ``--draws``
  draws each (the card's relative to its own solve);
- the factors' distances (relative Frobenius norm) from the f64 factor,
  from each other (and the entries apart), and one ulp of H's move of the
  CPU's factor; the card's factor ms, and an f32 factor's beside it.

Writes ``chiprun_out/gptq_devices_probe.json`` and prints a summary a
layer. Needs a CUDA card; the CPU solves take most of its time (about
10-20 minutes at 8 draws on 8 cores).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--draws", type=int, default=8)
    p.add_argument("--init-layers", type=int, default=12)
    p.add_argument("--seed", type=int, default=None, help="the model's seed (F_SEED)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("gptq_devices_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from quantizers_tpu_torch.models import ModelSpec
    from quantizers_tpu_torch.oneshot import gptq as TG
    from quantizers_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    seed = c.F_SEED if args.seed is None else args.seed
    t_start = time.perf_counter()
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        os.environ[var] = "1"
    with tempfile.TemporaryDirectory(prefix="gptq_devices_probe_") as tmp:
        tmp = Path(tmp)
        os.environ["HF_HOME"] = str(tmp / "hf_home")
        two = tmp / "two"
        spec = ModelSpec(**dict(c.GEOMETRY, num_layers=args.init_layers))
        c.write_bf16_model(spec, seed, [(two, 2)])
        batches, ids, _ = c.comparison_batches(tmp)
        ref, _ = c.engine_side(two, "recipe_gptq_w4a16_g32", c.GPTQ_G32, batches, ids, "cpu",
                               record="gptq")
    sites = ref["log"]
    c.log(f"[probe] {len(sites)} CPU problems recorded in {time.perf_counter() - t_start:.1f} s")

    gens = {d: torch.Generator(device=d).manual_seed(23) for d in ("cpu", "cuda")}

    def prepared(H):
        """H as gptq_quantize factors it (dead channels pinned; no actorder)."""
        H = H.float().clone()
        dead = torch.diagonal(H) == 0
        H.diagonal().add_(dead.float())
        return H

    def solve(site, dev, H=None, U=None):
        H = site["H"] if H is None else H
        cache = None if U is None else {(0, site["args"].actorder, float(site["damp"])): U.to(dev)}
        qt, gi = TG.gptq_quantize(site["w"].to(dev, torch.float32), H.to(dev, torch.float32),
                                  site["args"], site["block_size"], site["damp"],
                                  ufactor_cache=cache, cache_key=0 if cache else None)
        return c.site_objectives(site, qt, gi, rtn=False)["gptq"], qt

    def factor_ms(H, damp):
        """The card's ``_ufactor`` and the same factor in f32, ms (3 calls each)."""
        def f32(H):
            B = H.flip(0, 1).clone()
            B.diagonal().add_(torch.mean(torch.diagonal(H)) * damp)
            Lb, _ = torch.linalg.cholesky_ex(B)
            return torch.linalg.solve_triangular(Lb, torch.eye(H.shape[0], device=H.device),
                                                 upper=False).flip(0, 1)
        out = {}
        for name, fn in (("f64", lambda: TG._ufactor(H, damp)), ("f32", lambda: f32(H))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / 3 * 1e3
        return out

    def rel_fro(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).norm() / b.norm())

    rows, factors = [], {}
    for i, site in enumerate(sites):
        t0 = time.perf_counter()
        H = site["H"].float().cpu()
        key = (i // 7, int(H.shape[0]), float(H.abs().sum()))
        damp = float(site["damp"])
        if key not in factors:
            Hp = prepared(H)
            u_cpu = TG._ufactor(Hp, damp)
            u_card = TG._ufactor(Hp.cuda(), damp).cpu()
            u_64 = torch.from_numpy(TG._ufactor_host(Hp.numpy(), damp))
            u_ulp = TG._ufactor(prepared(c.one_ulp_apart(H, gens["cpu"])), damp)
            factors[key] = {"u": {"cpu": u_cpu, "card": u_card, "f64": u_64},
                            "dist": {"cpu_to_f64": rel_fro(u_cpu, u_64),
                                     "card_to_f64": rel_fro(u_card, u_64),
                                     "card_to_cpu": rel_fro(u_card, u_cpu),
                                     "card_cpu_entries_apart": int((u_card != u_cpu).sum()),
                                     "one_ulp_of_h_cpu": rel_fro(u_ulp, u_cpu)},
                            "card_factor_ms": factor_ms(Hp.cuda(), damp)}
        f = factors[key]
        base, _ = solve(site, "cpu", U=f["u"]["cpu"])
        own = c.site_objectives(site, rtn=False)["gptq"]
        card, card_qt = solve(site, "cuda")
        row = {"site": i, "layer": i // 7, "n_k": list(site["w"].shape),
               "cpu_reproduced": base == own, "factor": f["dist"],
               "card_factor_ms": f["card_factor_ms"]}

        def rel(x, to=own):
            return abs(x - to) / to
        row["card"] = rel(card)
        row["card_codes_apart"] = c.codes_apart(card_qt, site["qt"])[0] / card_qt.values.numel()
        row["card_with_cpu_u"] = rel(solve(site, "cuda", U=f["u"]["cpu"])[0])
        row["cpu_with_card_u"] = rel(solve(site, "cpu", U=f["u"]["card"])[0])
        row["card_f64_u"] = rel(solve(site, "cuda", U=f["u"]["f64"])[0])
        row["cpu_f64_u"] = rel(solve(site, "cpu", U=f["u"]["f64"])[0])
        for dev, name, to in (("cpu", "cpu_witness", own), ("cuda", "card_witness", card)):
            row[name] = [rel(solve(site, dev, H=c.one_ulp_apart(H.to(dev), gens[dev]))[0], to)
                         for _ in range(args.draws)]
        row["s"] = time.perf_counter() - t0
        rows.append(row)
        c.log(f"[probe] site {i} {row}")

    summary = {}
    for layer in sorted({r["layer"] for r in rows}):
        rs = [r for r in rows if r["layer"] == layer]
        s = {k: max(r[k] for r in rs) for k in ("card", "card_with_cpu_u", "cpu_with_card_u",
                                                   "card_f64_u", "cpu_f64_u")}
        for k in ("cpu_witness", "card_witness"):
            s[k] = max(max(r[k]) for r in rs)
            s[k + "_per_site"] = [max(r[k]) for r in rs]
        s["card_per_site"] = [r["card"] for r in rs]
        summary[layer] = s
    card_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip()
    out = {"card": card_line,
           "init_layers": args.init_layers, "seed": seed, "draws": args.draws,
           "summary": summary, "sites": rows, "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gptq_devices_probe.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": card_line, "init_layers": args.init_layers, "seed": seed, "draws": args.draws,
                      "summary": summary, "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
