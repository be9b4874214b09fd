"""Write a tiny random HF-format checkpoint for offline smoke runs.

Counterpart of ``quantizers_tpu/cli/make_tiny_model.py``; the weights come
from a seeded ``torch.Generator``, so they differ from the JAX package's
for the same seed, and the directory loads in either package.

    python -m quantizers_tpu_torch.cli.make_tiny_model <out_dir> [--moe] \
        [--hidden 64] [--layers 2] [--vocab 512] [--seed 0] [--device cpu]

Without ``--device`` it initializes the weights on the CUDA card.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--moe", action="store_true")
    p.add_argument("--mla", action="store_true",
                   help="MLA attention: not ported yet (ROADMAP slice 5)")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device for weight init (default: the CUDA card)")
    p.add_argument("--fit-corpus", default=None,
                   help="fit the model on a text file first: not ported yet "
                        "(the training slice, ROADMAP)")
    args = p.parse_args(argv)
    if args.mla:
        raise NotImplementedError(
            "make_tiny_model --mla: MLA models are not ported yet: ROADMAP queue 1, slice 5")
    if args.fit_corpus:
        raise NotImplementedError(
            "make_tiny_model --fit-corpus: models/fit.py takes gradients through the "
            "forward and needs an optimizer; it comes with the training slice (ROADMAP)")

    from .._device import resolve_device
    from ..models import ModelSpec, init_params
    from ..models.loader import save_hf_model

    dev = resolve_device(args.device)
    spec = ModelSpec.tiny(moe=args.moe, hidden_size=args.hidden, num_layers=args.layers,
                          vocab_size=args.vocab)
    params = init_params(spec, seed=args.seed, device=dev)
    save_hf_model(spec, params, args.out_dir)
    print(f"wrote tiny {'MoE ' if args.moe else ''}model to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
