"""Data-free PTQ CLI (reference ``scripts/quant_GLM-4.7-Flash-FP8.py``).

Counterpart of ``quantizers_tpu/cli/model_free.py``, with the same
arguments and defaults, and ``--device`` in place of ``--platform``::

    python -m quantizers_tpu_torch.cli.model_free <ckpt> <out> --scheme FP8_BLOCK \\
        [--ignore lm_head 're:.*mlp\\.gate$' ...] [--max-workers 8] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    from ..utils import enable_persistent_cache

    enable_persistent_cache()  # the kernels' library, built once for every later process
    p = argparse.ArgumentParser(description="Data-free PTQ over a local checkpoint")
    p.add_argument("model_dir")
    p.add_argument("save_directory")
    p.add_argument("--scheme", default="FP8_BLOCK")
    p.add_argument("--ignore", nargs="*", default=[
        "lm_head", "re:.*mlp\\.gate$", "re:.*embed_tokens$"])
    p.add_argument("--max-workers", type=int, default=8)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from ..oneshot.model_free import model_free_ptq

    quantized = model_free_ptq(
        args.model_dir, args.save_directory, scheme=args.scheme,
        ignore=args.ignore, max_workers=args.max_workers, device=args.device)
    print(f"quantized {len(quantized)} tensors -> {args.save_directory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
