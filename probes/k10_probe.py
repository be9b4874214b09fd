#!/usr/bin/env python3
"""K10 (the W8A8 linear) on the card: path I's served layer, its four calls
(Qwen3-4B's q|k|v, o, gate|up and down), from bf16 activations to the
output with the per-token quantizer included, checked bit for bit against
the plain composition and timed at decode (m 8) and prefill (m 1024).

    python3 probes/k10_probe.py [--root CHECKOUT] [--tag NAME] [--sweep] [--stream] [--ablate]
                                [--clocks] [--decode]

``--root`` names a checkout of the repository (default: this one) whose
``ops.dispatch.w8a8_token_matmul`` is the W8A8 linear timed, as that tree
computes it (quantizer, kernels, workspace and all), so that two commits
can be compared in one call (run once per checkout, in turns). ``--sweep``
(a tree with ``kernels.w8a8_plan``) also times each decode call at every
split. ``--stream`` builds ``probes/k10_stream.cu`` with nvcc and times its
stream-only kernels (the weight read through a cp.async ring, no
arithmetic) at each served shape, tile and split: the memory system's
rate for the decode body's access pattern. ``--ablate`` builds copies of
``csrc/w8a8_matmul.cuh`` with one part of the decode body cut out each
(ABLATIONS) and times each at the served shapes, m 8 (their outputs are
wrong by design); ``--ablate-prefill`` the wgmma prefill body's
PREFILL_VARIANTS at m 1024. ``--clocks`` builds a copy that stamps every block's
%globaltimer at CLOCK_MARKS and reports, per served shape at m 8, when the
blocks start and end and how long each phase takes. ``--decode`` serves
path I at full depth: a random Qwen3-4B (chip_smoke.GEOMETRY, 36 layers)
quantized by ``oneshot`` with ``recipe_w8a8_int8.yaml`` (RTN: no
calibration rows), ``serving_layout(head_bits=8)``, an 8 x 128 prefill and
greedy decode, timed (ms a step over DECODE_STEPS, device busy, launches a
step). Writes
``chiprun_out/k10_probe_<tag>.json`` and prints it.

Times: "dev_ms", the profiler's device time of all the kernels a layer
runs (a layer: the four calls); "ms", CUDA events over 20 layers; the
weights rotate through two copies (202 MB, four times the 50 MB L2).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
#: path I's served layer: (K, N) of q|k|v, o_proj, gate|up, down_proj
SERVED = ((2560, 6144), (4096, 2560), (2560, 19456), (9728, 2560))
ROWS = (8, 1024)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def layer_rows(root: Path, sweep: bool) -> dict:
    sys.path.insert(0, str(root))
    import chip_smoke as c
    from quantizers_tpu_torch.core.numerics import dynamic_quantize_token_int8
    from quantizers_tpu_torch.ops import _build
    from quantizers_tpu_torch.ops import dispatch as D
    from quantizers_tpu_torch.ops import kernels as K

    assert Path(c.__file__).resolve().parent == root.resolve(), c.__file__
    _build.load()
    res = {"root": str(root), "build_s": _build.INFO.seconds}
    gen = torch.Generator(device="cuda").manual_seed(0)
    copies = [[c.w8a8_linear(gen, k, n) for k, n in SERVED] for _ in range(2)]
    src = c.rotating(copies)
    for m in ROWS:
        xs = {k: (torch.randn((m, k), device="cuda", generator=gen) * 2).bfloat16()
              for k in {k for k, _ in SERVED}}
        for lin in copies[0]:
            x = xs[lin.in_features]
            got = D.w8a8_token_matmul(x, lin)
            xq, sx = dynamic_quantize_token_int8(x.float())
            ref = K.w8a8_matmul_plain(xq, sx.reshape(-1), lin.weight, lin.scale).bfloat16()
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (m, lin.in_features, lin.out_features)

        def layer():
            for lin in src():
                D.w8a8_token_matmul(xs[lin.in_features], lin)
        prof = c.device_profile(lambda: [layer() for _ in range(20)], 20)
        row = {"dev_ms": prof["device_busy_ms_per_step"], "ms": c.cuda_ms(layer),
               "kernels": prof["top"],
               "launches": sum(t["calls_per_step"] for t in prof["top"])}
        calls = {}
        for i, (k, n) in enumerate(SERVED):
            calls[f"{k}x{n}"] = c.device_ms(rotating_call(c, D, xs[k], [cp[i] for cp in copies]))
        row["calls_dev_ms"] = calls
        if sweep and hasattr(K, "w8a8_plan") and m <= K.W8A8_DECODE_ROWS:
            row["sweep_dev_ms"] = split_sweep(c, D, K, m, xs, copies)
        res[f"m{m}"] = row
        print(f"[m {m}] {json.dumps(row)}", file=sys.stderr, flush=True)
    return res


def rotating_call(c, D, x, lins):
    nxt = c.rotating(lins)
    return lambda: D.w8a8_token_matmul(x, nxt())


def split_sweep(c, D, K, m, xs, copies) -> dict:
    """Each decode call's device time with its split forced to 1 .. 8 (the
    plan's body and rows kept)."""
    plan, out = K.w8a8_plan, {}
    try:
        for i, (k, n) in enumerate(SERVED):
            base = plan(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
            for split in range(1, 9):
                K.w8a8_plan = lambda *a, s=split, b=base: b._replace(split=s)
                fits = True
                try:
                    t = c.device_ms(rotating_call(c, D, xs[k], [cp[i] for cp in copies]))
                except RuntimeError:
                    fits, t = False, None
                out[f"{k}x{n} split {split}"] = t if fits else "refused"
    finally:
        K.w8a8_plan = plan
    return out


#: k10_stream.cu's variants: (columns, rows a stage, stages, threads)
STREAM_VARIANTS = {0: (128, 64, 8, 128), 1: (128, 128, 6, 256), 2: (256, 64, 8, 256),
                   3: (512, 32, 8, 256), 4: (128, 64, 4, 128), 5: (128, 64, 12, 128)}


def stream_rows(root: Path) -> dict:
    """The stream-only kernels' device time and rate at each served shape,
    variant and split (weights rotated through two copies)."""
    sys.path.insert(0, str(root))
    import chip_smoke as c

    tmp = Path(tempfile.mkdtemp(prefix="k10_stream_"))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib_path = tmp / "libk10_stream.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib_path),
                    str(HERE / "k10_stream.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k10_stream.argtypes = (I, P, I, I, I, P, P)
    out = torch.zeros(4096, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for k, n in SERVED:
        ws = [torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda") for _ in range(4)]
        for v, (cols, rows, _, _) in STREAM_VARIANTS.items():
            for split in (1, 2, 4, 8):
                if (k // rows) < split or n % cols:
                    continue
                nxt = c.rotating(ws)

                def call():
                    err = lib.k10_stream(v, nxt().data_ptr(), k, n, split, out.data_ptr(), stream)
                    assert err == 0, err
                ms = c.device_ms(call)
                res[f"{k}x{n} v{v} split {split}"] = {"dev_ms": ms, "TB_s": k * n / ms / 1e9}
        print(f"[stream] {k}x{n}: {json.dumps({key: r for key, r in res.items() if key.startswith(f'{k}x{n}')})}",
              file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


#: parts of the decode body cut out by --ablate: (name, source text, its
#: replacement)
ABLATIONS = (
    ("no_mma", "      for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[0][j], b[1][j]);",
     "      acc[mt][0][0] ^= a[0] ^ a[3] ^ b[0][0] ^ b[1][3];"),
    ("no_inner", "    load_b32_sw(b_s, ks, pc, gid, t, b);\n#pragma unroll\n    for (int mt = 0; mt < MT; ++mt) {",
     "    b[0][0] = b[1][3] = 0;\n#pragma unroll\n    for (int mt = 0; mt < 0; ++mt) {"),
    ("no_quant", "        u = codes4(v, rq[r]);", "        u = __float_as_uint(v[0]);"),
    ("no_prep", "    if (s + 1 < ns) prep(s + 1);\n", ""),
    ("no_sync", "    __syncthreads();  // stage s's slot and codes free; stage s + 1's codes ready",
     "    __syncwarp();"),
    ("no_absmax", "          mx = abs_bits_max(mx, v);", "          mx = 0x3f800000u;"),
)


#: (text of csrc/w8a8_matmul.cuh, stamp slot, before it) for --clocks: the
#: block's start, x's share landed, the main loop's start and end, its end
#: (both returns)
CLOCK_MARKS = (("  uint8_t* ring = smem_raw + ((1024", 0, True),
               ("  if (!tma) __syncthreads();  // the byte-loaded pieces", 1, True),
               ("  if (ns > 0) prep(0);\n  __syncthreads();", 2, True),
               ("  // the second half's sums onto the first's", 3, True),
               ("          store8(out, sw, N, r, n0 + nb, v, rs[r]);\n        }\n    }\n    return;", 4, False),
               ("  finish_pushed<kDThreads>(red, reduced, BM * kBN, ranks, rank, rs, rows, sw, out, N, 0, n0);", 4, False))


def _stamp(slot: int) -> str:
    return ("  if (threadIdx.x == 0) { unsigned long long t_; asm volatile(\"mov.u64 %0, "
            "%%globaltimer;\" : \"=l\"(t_)); k10_clk[(blockIdx.z * gridDim.y + blockIdx.y) * "
            f"gridDim.x + blockIdx.x][{slot}] = t_; }}\n")


def clock_rows(root: Path) -> dict:
    """Per served shape at m 8, one launch's blocks: the spread of their
    starts and ends from the first start, and each phase's duration (x's
    share landed, the scales made, the main loop a stage, the epilogue), in
    us: median and max."""
    sys.path.insert(0, str(root))
    import chip_smoke as c
    from quantizers_tpu_torch.ops import kernels as K

    csrc = root / "quantizers_tpu_torch" / "csrc"
    units = ("w8a8_matmul.cu", "w8a8_matmul_f16.cu", "w8a8_matmul_f32.cu")
    src = (csrc / "w8a8_matmul.cuh").read_text()
    src = src.replace("namespace {\nusing namespace qtt;",
                      "static __device__ unsigned long long k10_clk[65536][8];\n"
                      "namespace {\nusing namespace qtt;", 1)
    for mark, slot, before in CLOCK_MARKS:
        assert mark in src, mark
        if before:
            src = src.replace(mark, _stamp(slot) + mark, 1)
        else:  # after the mark but before a trailing return
            body = mark[:-len("\n    }\n    return;")] if mark.endswith("return;") else mark
            tail = mark[len(body):]
            src = src.replace(mark, body + "\n" + _stamp(slot) + tail, 1)
    tmp = Path(tempfile.mkdtemp(prefix="k10_clk_"))
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, tmp)
    for u in units:
        shutil.copy(csrc / u, tmp)
    (tmp / "w8a8_matmul.cuh").write_text(src)
    with open(tmp / "w8a8_matmul.cu", "a") as f:
        f.write('\nextern "C" int k10_clocks(void* out, size_t bytes) {\n'
                '  return (int)cudaMemcpyFromSymbol(out, k10_clk, bytes);\n}\n')
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-I", str(tmp), "-o", str(tmp / "lib.so"),
                    *(str(tmp / u) for u in units)], check=True)
    lib = ctypes.CDLL(str(tmp / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.qtt_w8a8_matmul.argtypes = (P, P, P, P, P, P, I, I, I, I, I, I, P)
    lib.k10_clocks.argtypes = (P, ctypes.c_size_t)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for k, n in SERVED:
        lin = c.w8a8_linear(gen, k, n)
        x = (torch.randn((8, k), device="cuda", generator=gen) * 2).bfloat16()
        out = torch.empty((8, n), dtype=torch.bfloat16, device="cuda")
        split = K.w8a8_plan(8, k, n, sms).split
        blocks = -(-n // K.W8A8_BN) * split
        for _ in range(4):  # the last launch's stamps stay
            big = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
            big.zero_()  # the weight out of L2
            del big
            assert lib.qtt_w8a8_matmul(None, lin.weight.data_ptr(), None, lin.scale.data_ptr(),
                                       out.data_ptr(), x.data_ptr(), 8, k, n, 0, 0, split,
                                       stream) == 0
        torch.cuda.synchronize()
        buf = torch.zeros((65536, 8), dtype=torch.int64)
        assert lib.k10_clocks(buf.data_ptr(), buf.numel() * 8) == 0
        st = buf[:blocks].double()
        t0 = st[:, 0].min()
        steps = -(-k // K.W8A8_BK) / split

        def q(v):
            return {"median": float(v.median()), "max": float(v.max())}
        res[f"{k}x{n}"] = {
            "blocks": blocks, "split": split, "stages_a_block": steps,
            "span_us": float((st[:, 4].max() - t0) / 1e3),
            "start_us": q((st[:, 0] - t0) / 1e3), "end_us": q((st[:, 4] - t0) / 1e3),
            "x_landed_us": q((st[:, 1] - st[:, 0]) / 1e3),
            "scales_us": q((st[:, 2] - st[:, 1]) / 1e3),
            "stage_us": q((st[:, 3] - st[:, 2]) / 1e3 / steps),
            "epilogue_us": q((st[:, 4] - st[:, 3]) / 1e3)}
        print(f"[clocks] {k}x{n}: {json.dumps(res[f'{k}x{n}'])}", file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


#: variants of the wgmma prefill body for --ablate-prefill: (name, text, its
#: replacement)
PREFILL_VARIANTS = (
    ("stages3", ("constexpr int kWStages = 2;", "__launch_bounds__(128, 2)\nw8a8_wgmma_kernel("),
     ("constexpr int kWStages = 3;", "__launch_bounds__(128, 1)\nw8a8_wgmma_kernel(")),
    ("stages4", ("constexpr int kWStages = 2;", "__launch_bounds__(128, 2)\nw8a8_wgmma_kernel("),
     ("constexpr int kWStages = 4;", "__launch_bounds__(128, 1)\nw8a8_wgmma_kernel(")),
)


def ablate_rows(root: Path, prefill: bool = False) -> dict:
    """The decode body with each of ABLATIONS, and whole, at the served
    shapes, m 8, the plan's split: device ms a call."""
    sys.path.insert(0, str(root))
    import chip_smoke as c
    from quantizers_tpu_torch.ops import kernels as K

    csrc = root / "quantizers_tpu_torch" / "csrc"
    units = ("w8a8_matmul.cu", "w8a8_matmul_f16.cu", "w8a8_matmul_f32.cu")
    src = (csrc / "w8a8_matmul.cuh").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="k10_ablate_"))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, old, new in (("whole", (), ()),) + (PREFILL_VARIANTS if prefill else tuple(
            (n, (o,), (w,)) for n, o, w in ABLATIONS)):
        text = src
        for o, w in zip(old, new):
            assert o in text, name
            text = text.replace(o, w)
        d = tmp / name
        d.mkdir()
        for f in csrc.glob("*.cuh"):
            shutil.copy(f, d)
        for u in units:
            shutil.copy(csrc / u, d)
        (d / "w8a8_matmul.cuh").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-I", str(d), "-o", str(tmp / f"lib{name}.so"),
             *(str(d / u) for u in units)])
    for name, proc in procs.items():
        assert proc.wait() == 0, name
    P, I = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    copies = [[c.w8a8_linear(gen, k, n) for k, n in SERVED] for _ in range(2)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name in procs:
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        fn = lib.qtt_w8a8_matmul
        fn.argtypes = (P, P, P, P, P, P, I, I, I, I, I, I, P)
        m = 1024 if prefill else 8
        for i, (k, n) in enumerate(SERVED):
            x = (torch.randn((m, k), device="cuda", generator=gen) * 2).bfloat16()
            xq = torch.empty((m, k), dtype=torch.int8, device="cuda")
            sx = torch.empty((m,), dtype=torch.float32, device="cuda")
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            split = K.w8a8_plan(m, k, n, sms).split
            nxt = c.rotating([cp[i] for cp in copies])

            def call():
                lin = nxt()
                err = fn(xq.data_ptr(), lin.weight.data_ptr(), sx.data_ptr(),
                         lin.scale.data_ptr(), out.data_ptr(), x.data_ptr(), m, k, n, 0, 0,
                         split, stream)
                assert err == 0, err
            res[f"{name} {k}x{n}"] = c.device_ms(call)
        print(f"[ablate] {name}: {json.dumps({key: v for key, v in res.items() if key.startswith(name + ' ')})}",
              file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


DECODE_STEPS = 32


def decode_rows(root: Path) -> dict:
    """Path I's decode at full depth as the tree at ``root`` serves it."""
    sys.path.insert(0, str(root))
    import chip_smoke as c
    from quantizers_tpu_torch.models import KVCache, ModelSpec, init_params
    from quantizers_tpu_torch.oneshot import oneshot
    from quantizers_tpu_torch.ops import _build
    from quantizers_tpu_torch.ops import kernels as K
    from quantizers_tpu_torch.recipes import parse_recipe
    from quantizers_tpu_torch.serve import prefill, serving_layout
    from quantizers_tpu_torch.serve.engine import _decode_scan

    _build.load()
    spec = ModelSpec(**c.GEOMETRY)
    params = init_params(spec, seed=0, device="cuda")
    recipe = parse_recipe(str(root / "configs" / "recipes" / "recipe_w8a8_int8.yaml"))
    params = oneshot(spec, params, recipe, [], device="cuda").params
    params = serving_layout(spec, params, head_bits=8, device="cuda")
    ids = ((torch.arange(c.BATCH * c.PREFILL, device="cuda").reshape(c.BATCH, c.PREFILL) * 89
            + 3) % spec.vocab_size)
    caches = KVCache.init(spec, c.BATCH, c.MAX_LEN, device="cuda")
    last, caches = prefill(params, spec, ids, caches)
    first = last.argmax(-1)
    _decode_scan(params, spec, [cc.clone() for cc in caches], first, None, steps=4,
                 temperature=0.0, top_k=0)  # warm-up
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _decode_scan(params, spec, [cc.clone() for cc in caches], first, None, steps=DECODE_STEPS,
                 temperature=0.0, top_k=0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    counts = {k: v // DECODE_STEPS for k, v in K.launch_counts().items() if v}
    prof = c.device_profile(lambda: _decode_scan(params, spec, [cc.clone() for cc in caches],
                                                 first, None, steps=8, temperature=0.0,
                                                 top_k=0), 8)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        _decode_scan(params, spec, [cc.clone() for cc in caches], first, None, steps=8,
                     temperature=0.0, top_k=0)
        torch.cuda.synchronize()
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in trace.events())
    res = {"layers": spec.num_layers, "steps": DECODE_STEPS, "ms_per_step": ms,
           "wrapper_launches_per_step": counts, "device_ops_per_step": kernels / 8,
           **{k: prof[k] for k in ("device_busy_ms_per_step", "idle_share", "top")}}
    print(f"[decode] {json.dumps(res)}", file=sys.stderr, flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE.parent)
    ap.add_argument("--tag", default="new")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--ablate-prefill", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--decode", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k10_probe: needs a CUDA card", file=sys.stderr)
        return 1
    if args.stream:
        res = {"device": smi(), "tag": args.tag, "stream": stream_rows(args.root.resolve())}
    elif args.decode:
        res = {"device": smi(), "tag": args.tag, "decode": decode_rows(args.root.resolve())}
    elif args.clocks:
        res = {"device": smi(), "tag": args.tag, "clocks": clock_rows(args.root.resolve())}
    elif args.ablate or args.ablate_prefill:
        res = {"device": smi(), "tag": args.tag,
               "ablate": ablate_rows(args.root.resolve(), args.ablate_prefill)}
    else:
        res = {"device": smi(), "tag": args.tag, **layer_rows(args.root.resolve(), args.sweep)}
    out = HERE.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"k10_probe_{args.tag}.json").write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps(res, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
