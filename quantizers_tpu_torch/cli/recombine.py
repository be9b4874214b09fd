"""Mixed-precision weight-surgery CLI
(reference ``scripts/recombine_weights_MiniMax-M2.1.py`` main).

Counterpart of ``quantizers_tpu/cli/recombine.py``; tensors are copied as
they are stored, on the CPU, so it needs no device."""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Merge a primary (e.g. FP8) and a secondary (e.g. W4 "
                    "pack-quantized) checkpoint into one hybrid model")
    p.add_argument("primary")
    p.add_argument("secondary")
    p.add_argument("output")
    p.add_argument("--swap-pattern",
                   default=r".*\.mlp\.experts\.\d+\.(gate|up|down)_proj$"
                           r"|.*\.(w1|w2|w3)$")
    p.add_argument("--prefer-secondary-pattern",
                   default=r".*post_attention_layernorm\.weight$")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from ..tools.recombine import ModelMerger

    stats = ModelMerger(
        args.primary, args.secondary, args.output,
        swap_pattern=args.swap_pattern,
        prefer_secondary_pattern=args.prefer_secondary_pattern,
        dry_run=args.dry_run,
    ).run()
    print(stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
