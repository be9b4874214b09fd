#!/usr/bin/env python3
"""K11 (GPTQ's column elimination) on the card: one launch timed at each row
count, the chain floor of one column, and the kernel's SASS.

    python3 probes/k11_probe.py [--root CHECKOUT] [--tag NAME] [--no-chain]

``--root`` names a checkout of the repository (default: this one) whose
``chip_smoke.time_gptq_block`` and kernels are timed, so that two commits
can be compared in one call (run once per checkout, in turns). Writes
``chiprun_out/k11_probe_<tag>.json`` and ``chiprun_out/k11_sass_<tag>.txt``
(the ``cuobjdump -sass`` of ``gptq_block.o``) and prints the JSON.

The chain probe (``probes/k11_chain.cu``, built here with nvcc) runs one
column's dependent operations 128 times on one thread, with ``__fdiv_rn``
and with the kernel's ``div_fast``: 128 times its time a column is the
chain floor of one launch. It also holds ``div_fast`` against
``__fdiv_rn`` bit for bit on 2^31 seeded operands, and the kernel's
``rcp_rn`` against ``__frcp_rn`` on every float of its range.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROWS = (1, 512, 768, 1024, 2048, 2560, 4096, 9728)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sass_summary(text: str, kernel: str) -> dict:
    """Instruction counts of the named kernel's SASS."""
    out, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            op = m.group(2).split(".")[0]
            out[op] = out.get(op, 0) + 1
    out["total"] = sum(out.values())
    return out


def kernel_rows(root: Path, tag: str, out_dir: Path) -> dict:
    sys.path.insert(0, str(root))
    import chip_smoke as c
    from quantizers_tpu_torch.ops import _build

    assert Path(c.__file__).resolve().parent == root.resolve(), c.__file__
    _build.load()
    build_dir = _build.INFO.path.parent if _build.INFO.path else None
    log = [line for line in _build.INFO.log.split("== ") if line.startswith("gptq_block")]
    res = {"root": str(root), "build_s": _build.INFO.seconds, "ptxas": log[0] if log else None}
    obj = build_dir / "gptq_block.o" if build_dir else None
    if obj is not None and obj.exists() and shutil.which("cuobjdump"):
        text = subprocess.run(["cuobjdump", "-sass", str(obj)], capture_output=True,
                              text=True).stdout
        (out_dir / f"k11_sass_{tag}.txt").write_text(text)
        res["sass"] = sass_summary(text, "gptq_block")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for n in ROWS:
        r = c.time_gptq_block(gen, n)
        rows[n] = {k: r[k] for k in ("ms", "dev_ms", "bound_ms", "bytes_ms", "ops_ms",
                                     "max_abs_err")}
        print(f"[{tag}] N {n}: {rows[n]}", file=sys.stderr, flush=True)
    res["rows"] = rows
    res["per_column_ns_at_n1"] = rows[1]["dev_ms"] * 1e6 / 128
    return res


#: (a line of csrc/gptq_block.cu, the clock slot recorded next to it, whether
#: before it) for the phase clocks of one launch: kernel start, U's copies
#: issued and the first rows staged, U's diagonal staged, U staged, the
#: rows ready, the fast elimination done, the rows written
CLOCK_MARKS = (("  extern __shared__ float4 smem4[];", 0, False),
               ("  bool ubad = false;", 5, True),
               ("  qtt::mbar_wait(&ubar, 0);", 6, True),
               ("  ubad = __syncthreads_or(ubad);", 1, False),
               ("    bad = eliminate<kL, true, kAsym>(wv, row, j) || bad || ubad;", 2, True),
               ("    bad = eliminate<kL, true, kAsym>(wv, row, j) || bad || ubad;", 3, False),
               ("    store_rows<kL>(err_out, a1, row0, N, bs, lane);", 4, False))


def phase_clocks(root: Path) -> dict:
    """Where one launch's time goes: a copy of ``gptq_block.cu`` with
    clock64() read by thread 0 of block 0 after each of CLOCK_MARKS, built
    here and launched at N 1 and 9728 (symmetric, g32), cycles from the
    kernel's start."""
    src = (root / "quantizers_tpu_torch" / "csrc" / "gptq_block.cu").read_text()
    src = src.replace("namespace {", "__device__ unsigned long long k11_clk[8];\nnamespace {", 1)
    for mark, slot, before in CLOCK_MARKS:
        assert mark in src, mark
        clock = f"    if (threadIdx.x == 0 && blockIdx.x == 0) k11_clk[{slot}] = clock64();\n"
        src = src.replace(mark, clock + mark if before else mark + "\n" + clock, 1)
    src += ('\nextern "C" int k11_clocks(void* out) {\n  return (int)cudaMemcpyFromSymbol('
            'out, k11_clk, sizeof(k11_clk));\n}\n')
    tmp = Path(tempfile.mkdtemp(prefix="k11_clk_"))
    (tmp / "k11_clk.cu").write_text(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib_path = tmp / "libk11_clk.so"
    build = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                            "-Xcompiler", "-fPIC", "-shared", "-I",
                            str(root / "quantizers_tpu_torch" / "csrc"), "-o", str(lib_path),
                            str(tmp / "k11_clk.cu")], capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(build.stdout + build.stderr)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qtt_gptq_block.argtypes = (P, L, P, L, P, P, I, P, P, P, I, I, ctypes.c_float,
                                   ctypes.c_float, I, P)
    lib.k11_clocks.argtypes = (P,)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1, 9728):
        w = torch.randn((n, 128), device="cuda", generator=gen) * 0.02
        u = torch.eye(128, device="cuda") * 0.05 + torch.triu(
            torch.randn((128, 128), device="cuda", generator=gen), 1) * 1e-3
        scale = torch.full((n, 4), 0.004, device="cuda")
        cg = (torch.arange(128, device="cuda") // 32).to(torch.int32)
        q, err = torch.empty_like(w), torch.empty_like(w)
        clk = np.zeros(8, np.uint64)
        rows = []
        for _ in range(3):
            assert lib.qtt_gptq_block(w.data_ptr(), 128, u.data_ptr(), 128, scale.data_ptr(), None,
                                      4, cg.data_ptr(), q.data_ptr(), err.data_ptr(), n, 128, -8.0,
                                      7.0, sms, stream) == 0
            torch.cuda.synchronize()
            assert lib.k11_clocks(clk.ctypes.data) == 0
            rows.append([int(c - clk[0]) for c in clk[1:7]])
        out[n] = {"cycles_after": dict(zip(("u_staged", "rows_ready", "fast_eliminated",
                                            "rows_written", "first_rows_staged",
                                            "u_diagonal_staged"), rows[-1]))}
        print(f"[clocks] N {n}: {out[n]}", file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def chain_probe(out_dir: Path) -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = Path(tempfile.mkdtemp(prefix="k11_probe_"))
    lib_path = tmp / "libk11_probe.so"
    build = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
                            "-o", str(lib_path), str(HERE / "k11_chain.cu")],
                           capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(build.stdout + build.stderr)
    if shutil.which("cuobjdump"):
        (out_dir / "k11_sass_chain_probe.txt").write_text(
            subprocess.run(["cuobjdump", "-sass", str(lib_path)], capture_output=True,
                           text=True).stdout)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.probe_chain.argtypes = (ctypes.c_int, P, P, P, ctypes.c_int, P)
    lib.probe_div_check.argtypes = (ctypes.c_ulonglong, ctypes.c_uint, P, P, P)
    lib.probe_rcp_check.argtypes = (P, P)
    rng = np.random.default_rng(0)
    s = rng.uniform(0.002, 0.004, 8).astype(np.float32)
    d = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    u = rng.uniform(-0.2, 0.2, 8).astype(np.float32)
    w = rng.normal(0, 0.02, 8).astype(np.float32)
    ys = torch.tensor(s).cuda().reciprocal()  # only a register input of the timing
    yd = torch.tensor(d).cuda().reciprocal()
    p = torch.cat([torch.tensor(s).cuda(), torch.tensor(d).cuda(), torch.tensor(u).cuda(), ys,
                   yd, torch.tensor(w).cuda()]).contiguous()
    outv = torch.zeros(1, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"ptxas": build.stdout + build.stderr}
    reps = 64
    for variant, name in ((0, "fdiv"), (1, "div_fast")):
        best = None
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            rc = lib.probe_chain(variant, p.data_ptr(), outv.data_ptr(), cyc.data_ptr(), reps,
                                 stream)
            b.record()
            torch.cuda.synchronize()
            assert rc == 0, rc
            ms = a.elapsed_time(b)
            row = {"ns_per_column": ms * 1e6 / (reps * 128),
                   "cycles_per_column": int(cyc.item()) / (reps * 128),
                   "chain_floor_ms": ms / reps}
            if best is None or row["ns_per_column"] < best["ns_per_column"]:
                best = row
        res[name] = best
        print(f"[chain] {name}: {best}", file=sys.stderr, flush=True)
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    first = torch.zeros(4, device="cuda")
    n = 1 << 31
    t0 = time.perf_counter()
    assert lib.probe_div_check(n, 12345, bad.data_ptr(), first.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    res["div_check"] = {"pairs": n, "mismatches": int(bad[0]), "first": first.tolist(),
                        "s": time.perf_counter() - t0}
    print(f"[chain] div check: {res['div_check']}", file=sys.stderr, flush=True)
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert lib.probe_rcp_check(bad.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    res["rcp_check"] = {"floats": 2 * ((48 << 23) + 1), "mismatches": int(bad[0])}
    print(f"[chain] rcp check: {res['rcp_check']}", file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--no-chain", action="store_true")
    ap.add_argument("--clocks", action="store_true",
                    help="also the phase clocks of one launch (phase_clocks)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k11_probe: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = HERE.parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    res = {"device": smi(), "torch": torch.__version__, "cuda": torch.version.cuda}
    res["k11"] = kernel_rows(Path(args.root).resolve(), args.tag, out_dir)
    if args.clocks:
        res["clocks"] = phase_clocks(Path(args.root).resolve())
    if not args.no_chain:
        res["chain"] = chain_probe(out_dir)
    res["device_after"] = smi()
    (out_dir / f"k11_probe_{args.tag}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
