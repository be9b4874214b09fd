"""Validate a produced checkpoint's quantization_config against the
compressed-tensors schema (reference ``scripts/quant_config_debug.py``).

Counterpart of ``quantizers_tpu/cli/validate_config.py``; reads JSON only,
so it needs no device."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config", help="config.json path or checkpoint dir")
    args = p.parse_args(argv)

    path = Path(args.config)
    if path.is_dir():
        path = path / "config.json"
    cfg = json.loads(path.read_text())
    qcfg = cfg.get("quantization_config")
    if qcfg is None:
        print("no quantization_config block found", file=sys.stderr)
        return 1

    from ..formats.compressed_tensors import parse_quantization_config

    groups, ignore, kv = parse_quantization_config(qcfg)
    print(f"OK: {len(groups)} config group(s), {len(ignore)} ignore pattern(s), "
          f"kv_cache_scheme={'yes' if kv else 'no'}")
    for name, scheme in groups.items():
        w = scheme.weights
        desc = "dense" if w is None else (
            f"{w.type.value}{w.num_bits} {w.strategy.value}"
            + (f" g{w.group_size}" if w.group_size else ""))
        print(f"  {name}: targets={list(scheme.targets)} weights={desc}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
