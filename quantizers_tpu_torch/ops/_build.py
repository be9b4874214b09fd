"""Build and load the CUDA kernels of ``quantizers_tpu_torch/csrc``.

Each ``.cu`` file has a plain C interface. At first use every source is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``,
the objects are linked into one shared library, and the library is loaded
with ``ctypes``. The library lives under ``_kernels_build/<hash>/``, keyed by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_kernels_build"
SOURCES = ("w4_matmul.cu", "w8_matmul.cu", "decode_attention.cu", "nvfp4_matmul.cu",
           "moe_slot_ffn.cu", "moe_slot_gu_ffn.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry point -> argument types (pointers and the stream are c_void_p)
SIGNATURES = {
    # x, packed, scale, out, M, K, N, g, stream
    "qtt_w4_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w8, scale, out, M, K, N, g, stream (bf16 scales; _f32s: f32 scales)
    "qtt_w8_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qtt_w8_matmul_f32s": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, new_k, new_v, cache_k, cache_v, lengths, ctx, B, KV, rep, S, hd, sm_scale, stream
    "qtt_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             ctypes.c_float, _P),
    # x, payload (packed u8 or int8-doubled), scale, out, M, K, N, g, stream
    "qtt_nvfp4_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qtt_nvfp4_i8_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # payload kind, x, idx, gate w/s, up w/s, down w/s, a workspace, out, S, D, F, E, g, stream
    "qtt_moe_slot_ffn": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, idx, gate|up w/s, down w/s, a workspace, out, S, D, F, E, stream
    "qtt_moe_slot_gu_ffn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, o, (b, head, row) element strides of each, B, H, KV, T, S, d, dv,
    # sm_scale, causal, stream
    "qtt_flash_attention": (_P, _P, _P, _P, *(_L,) * 12, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _I, _P),
}


@dataclasses.dataclass
class BuildInfo:
    """What :func:`load` did: library path, seconds, whether it compiled,
    and nvcc's output (the ptxas register and spill report)."""

    path: Optional[Path] = None
    seconds: float = 0.0
    built: bool = False
    log: str = ""


_LIB: Optional[ctypes.CDLL] = None
INFO = BuildInfo()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA "
                       "toolkit's nvcc (on PATH or under $CUDA_HOME/bin)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    lib = out_dir / "libqtt_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib), *(str(out_dir / (Path(s).stem + ".o")) for s in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if its hash is new."""
    global _LIB
    if _LIB is not None:
        return _LIB
    t0 = time.perf_counter()
    final = BUILD_ROOT / source_hash()
    lib_path = final / "libqtt_kernels.so"
    if not lib_path.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
        try:
            INFO.log = _compile(tmp)
            if not final.exists():
                os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        INFO.built = True
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.qtt_error_string.argtypes = [ctypes.c_int]
    lib.qtt_error_string.restype = ctypes.c_char_p
    INFO.path, INFO.seconds = lib_path, time.perf_counter() - t0
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().qtt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
