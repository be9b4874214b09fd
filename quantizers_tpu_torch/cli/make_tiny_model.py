"""Write a tiny random HF-format checkpoint for offline smoke runs.

Counterpart of ``quantizers_tpu/cli/make_tiny_model.py``; the weights come
from a seeded ``torch.Generator``, so they differ from the JAX package's
for the same seed, and the directory loads in either package.

    python -m quantizers_tpu_torch.cli.make_tiny_model <out_dir> [--moe] [--mla] \
        [--hidden 64] [--layers 2] [--vocab 512] [--seed 0] [--device cpu] \
        [--fit-corpus text.txt [--fit-steps 300] [--fit-lr 3e-3] [--fit-seq 64] \
         [--fit-batch 8]]

Without ``--device`` it initializes the weights, and fits them, on the
CUDA card. ``--fit-corpus`` fits the model to the text's bytes first
(:func:`~quantizers_tpu_torch.models.fit.fit_lm`), as the perplexity
protocol needs; the fit launches no kernel.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--moe", action="store_true")
    p.add_argument("--mla", action="store_true",
                   help="MLA attention (with --moe: the DeepSeek-class MLA+MoE shape: "
                        "shared experts, sigmoid router, first layer dense)")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device for weight init and the fit (default: the CUDA card)")
    p.add_argument("--fit-corpus", default=None,
                   help="text file to fit the model on before saving "
                        "(makes perplexity deltas discriminative)")
    p.add_argument("--fit-steps", type=int, default=300)
    p.add_argument("--fit-lr", type=float, default=3e-3)
    p.add_argument("--fit-seq", type=int, default=64)
    p.add_argument("--fit-batch", type=int, default=8)
    args = p.parse_args(argv)

    from .._device import resolve_device
    from ..models import ModelSpec, init_params
    from ..models.loader import save_hf_model

    dev = resolve_device(args.device)
    spec = ModelSpec.tiny(moe=args.moe, mla=args.mla, hidden_size=args.hidden,
                          num_layers=args.layers, vocab_size=args.vocab)
    params = init_params(spec, seed=args.seed, device=dev)
    fitted = ""
    if args.fit_corpus:
        import numpy as np

        from ..data.simple_tokenizer import ByteTokenizer
        from ..models.fit import fit_lm

        text = Path(args.fit_corpus).read_text()
        ids = np.asarray(ByteTokenizer()(text)["input_ids"], np.int32)
        params = fit_lm(spec, params, ids, steps=args.fit_steps,
                        batch_size=args.fit_batch, seq_len=args.fit_seq,
                        lr=args.fit_lr, seed=args.seed)
        fitted = f"fitted ({args.fit_steps} steps) "
    save_hf_model(spec, params, args.out_dir)
    kind = ("MLA+MoE " if (args.moe and args.mla) else
            "MoE " if args.moe else "MLA " if args.mla else "")
    print(f"wrote tiny {fitted}{kind}model to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
