"""Minimal, dependency-free safetensors reader/writer over torch tensors.

Counterpart of ``quantizers_tpu/formats/safetensors_io.py``, from the
public format spec: an 8-byte little-endian header length, a JSON header
``{name: {dtype, shape, data_offsets}}``, then the raw tensor bytes. The
tensors are CPU torch tensors, so bf16 and the FP8 types need no
``ml_dtypes``: a file is read with ``torch.frombuffer`` over a memory map
and written from each tensor's bytes through a ``uint8`` view. Files
written by either package read identically in the other.

:class:`LazySafetensors` materializes one tensor at a time;
:class:`ShardedWriter` writes size-bounded shards and the
``model.safetensors.index.json`` that HF and vLLM expect;
:class:`ShardedReader` keeps at most a few shards open.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import warnings
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

# safetensors dtype tag <-> torch dtype
_DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
}
_TO_TAG = {v: k for k, v in _DTYPES.items()}


def dtype_tag(t: torch.Tensor) -> str:
    try:
        return _TO_TAG[t.dtype]
    except KeyError:
        raise ValueError(f"Unsupported dtype for safetensors: {t.dtype}") from None


def _as_cpu_tensor(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _raw(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a uint8 array sharing its memory."""
    return t.reshape(-1).view(torch.uint8).numpy()


def write_safetensors(
    path: Union[str, Path],
    tensors: Dict[str, torch.Tensor],
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write one .safetensors file. Tensor bytes are laid out in insertion
    order; offsets are 8-byte aligned via header padding (spec-compliant)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}

    offset = 0
    blobs: List[np.ndarray] = []
    for name, t in tensors.items():
        t = _as_cpu_tensor(t)
        raw = _raw(t)
        header[name] = {
            "dtype": dtype_tag(t),
            "shape": list(t.shape),
            "data_offsets": [offset, offset + raw.nbytes],
        }
        blobs.append(raw)
        offset += raw.nbytes

    hjson = json.dumps(header, separators=(",", ":")).encode()
    pad = (-(8 + len(hjson))) % 8
    hjson += b" " * pad

    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for raw in blobs:
            f.write(raw.data)


def _parse_header(buf: memoryview) -> Tuple[Dict[str, Any], int]:
    hlen = int.from_bytes(buf[:8], "little")
    header = json.loads(bytes(buf[8 : 8 + hlen]).decode())
    return header, 8 + hlen


class LazySafetensors:
    """Memory-mapped single-file reader; tensors materialize on access."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        view = memoryview(self._mm)
        header, self._base = _parse_header(view)
        view.release()
        self.metadata: Dict[str, str] = header.pop("__metadata__", {})
        self._entries: Dict[str, Any] = header

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def info(self, name: str) -> Tuple[str, Tuple[int, ...]]:
        e = self._entries[name]
        return e["dtype"], tuple(e["shape"])

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name``, copied out of the map (it owns its memory)."""
        e = self._entries[name]
        start, end = e["data_offsets"]
        dtype = _DTYPES[e["dtype"]]
        if end == start:  # torch.frombuffer refuses a count of 0
            return torch.empty(e["shape"], dtype=dtype)
        with warnings.catch_warnings():
            # the map is read-only, and the view is only read, then copied
            warnings.simplefilter("ignore", UserWarning)
            view = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start,
                                    offset=self._base + start)
        return view.clone().view(dtype).reshape(e["shape"])

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for name in self._entries:
            yield name, self.get(name)

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "LazySafetensors":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Eagerly load every tensor."""
    with LazySafetensors(path) as f:
        return dict(f.items())


# ---------------------------------------------------------------------------
# sharded checkpoints (HF layout: model-XXXXX-of-YYYYY.safetensors + index)
# ---------------------------------------------------------------------------

INDEX_NAME = "model.safetensors.index.json"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardedWriter:
    """Accumulate tensors (moved to the CPU as they come) and write
    size-bounded shards + the index JSON."""

    def __init__(
        self,
        out_dir: Union[str, Path],
        max_shard_bytes: int = 5 * 1024**3,
        base_name: str = "model",
    ):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.max_shard_bytes = max_shard_bytes
        self.base_name = base_name
        self._current: Dict[str, torch.Tensor] = {}
        self._current_bytes = 0
        self._shards: List[Dict[str, torch.Tensor]] = []

    def add(self, name: str, t: torch.Tensor) -> None:
        t = _as_cpu_tensor(t)
        nbytes = _nbytes(t)
        if self._current and self._current_bytes + nbytes > self.max_shard_bytes:
            self._shards.append(self._current)
            self._current, self._current_bytes = {}, 0
        self._current[name] = t
        self._current_bytes += nbytes

    def add_many(self, tensors: Dict[str, torch.Tensor]) -> None:
        for k, v in tensors.items():
            self.add(k, v)

    def finalize(self, metadata: Optional[Dict[str, str]] = None) -> List[str]:
        if self._current:
            self._shards.append(self._current)
            self._current, self._current_bytes = {}, 0

        n = len(self._shards)
        weight_map: Dict[str, str] = {}
        total = 0
        files: List[str] = []
        for i, shard in enumerate(self._shards, start=1):
            # one shard keeps the plain name; the index is written either
            # way (vLLM and HF tolerate it and the recombination tool keys
            # off it)
            fname = (f"{self.base_name}.safetensors" if n == 1
                     else f"{self.base_name}-{i:05d}-of-{n:05d}.safetensors")
            write_safetensors(self.out_dir / fname, shard, metadata)
            files.append(fname)
            for k, v in shard.items():
                weight_map[k] = fname
                total += _nbytes(v)

        index = {"metadata": {"total_size": total}, "weight_map": weight_map}
        with open(self.out_dir / INDEX_NAME, "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)
        self._shards = []
        return files


class ShardedReader:
    """Read an HF-layout checkpoint directory with bounded shard residency:
    at most ``max_open_shards`` mapped files stay open (least recently
    opened out first)."""

    def __init__(self, ckpt_dir: Union[str, Path], max_open_shards: int = 2):
        self.dir = Path(ckpt_dir)
        self.max_open = max_open_shards
        self._open: Dict[str, LazySafetensors] = {}

        index_path = self.dir / INDEX_NAME
        if index_path.exists():
            with open(index_path) as f:
                self.weight_map: Dict[str, str] = json.load(f)["weight_map"]
        else:
            files = sorted(p.name for p in self.dir.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"No safetensors files in {self.dir}")
            self.weight_map = {}
            for fname in files:
                with LazySafetensors(self.dir / fname) as lf:
                    for k in lf.keys():
                        self.weight_map[k] = fname

    def keys(self) -> List[str]:
        return list(self.weight_map)

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def _shard(self, fname: str) -> LazySafetensors:
        if fname in self._open:
            return self._open[fname]
        if len(self._open) >= self.max_open:
            oldest = next(iter(self._open))
            self._open.pop(oldest).close()
        lf = LazySafetensors(self.dir / fname)
        self._open[fname] = lf
        return lf

    def get(self, name: str) -> torch.Tensor:
        return self._shard(self.weight_map[name]).get(name)

    def iter_shards(self) -> Iterator[Tuple[str, LazySafetensors]]:
        """Yield (file_name, open_shard) in natural order."""
        for fname in sorted(set(self.weight_map.values()), key=natural_sort_key):
            yield fname, self._shard(fname)

    def close(self) -> None:
        for lf in self._open.values():
            lf.close()
        self._open = {}

    def __enter__(self) -> "ShardedReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def natural_sort_key(s: str) -> List[Any]:
    """Human-friendly ordering for shard file names."""
    return [int(part) if part.isdigit() else part.casefold() for part in re.split(r"(\d+)", s)]


def load_json(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def dump_json(obj: Any, path: Union[str, Path]) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write(os.linesep)
