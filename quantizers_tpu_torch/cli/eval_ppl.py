"""Perplexity evaluation CLI: the quality metric (wikitext PPL delta
against the bf16 checkpoint at equal bit-width).

Counterpart of ``quantizers_tpu/cli/eval_ppl.py``, with the same windows,
masks and output line. Evaluates a checkpoint (plain HF or
compressed-tensors) on a local text file with a sliding window; compare two
checkpoints by running twice and differencing.

    python -m quantizers_tpu_torch.cli.eval_ppl <ckpt_dir> <text_file> \
        [--window 2048] [--stride 2048] [--device cpu] [--max-windows N]

Without ``--device`` it runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger("quantizers_tpu_torch.eval_ppl")


def make_batches(ids: np.ndarray, window: int, stride: int, batch_size: int,
                 max_windows=None):
    """The strided protocol's ``(ids, mask)`` batches and window count.

    With stride < window, each window after the first scores only its last
    ``stride`` tokens: the first window - stride positions are context
    (mask 0), so overlap tokens are not counted twice with favourable
    context. A window that reaches the corpus end is the last."""
    windows = []  # (ids, n_context) pairs
    for start in range(0, max(1, len(ids) - 1), stride):
        w = ids[start : start + window]
        if len(w) < 2:
            break
        ctx = 0 if start == 0 else max(0, min(window - stride, len(w) - 1))
        windows.append((w, ctx))
        if start + window >= len(ids):
            break
        if max_windows and len(windows) >= max_windows:
            break

    batches = []
    for i in range(0, len(windows), batch_size):
        chunk = windows[i : i + batch_size]
        T = max(len(w) for w, _ in chunk)
        b = np.zeros((len(chunk), T), np.int32)
        m = np.zeros((len(chunk), T), np.float32)
        for j, (w, ctx) in enumerate(chunk):
            b[j, : len(w)] = w
            m[j, ctx : len(w)] = 1.0
        batches.append((b, m))
    return batches, len(windows)


def main(argv=None) -> int:
    from ..utils import enable_persistent_cache

    enable_persistent_cache()  # the kernels' library, built once for every later process
    p = argparse.ArgumentParser()
    p.add_argument("ckpt_dir")
    p.add_argument("text_file")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--stride", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-windows", type=int, default=None)
    p.add_argument("--head-bits", type=int, default=None,
                   help="quantize the logits head to this many bits before "
                        "scoring (serving-layout option, e.g. 8)")
    p.add_argument("--moe-layout", choices=["w8pc"], default=None,
                   help="apply a MoE expert serving layout before scoring "
                        "(w8pc = fused int8-per-channel requantization; "
                        "quantifies its quality cost)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from .._device import resolve_device
    from ..data.simple_tokenizer import load_tokenizer
    from ..models.loader import load_checkpoint
    from ..serve import perplexity

    dev = resolve_device(args.device)
    ckpt = Path(args.ckpt_dir)
    t0 = time.perf_counter()
    spec, params, _ = load_checkpoint(ckpt, device=dev)
    logger.info("loaded %s in %.3f s", ckpt, time.perf_counter() - t0)

    if args.head_bits:
        from ..models.transformer import quantize_lm_head

        params = quantize_lm_head(spec, params, num_bits=args.head_bits)
        logger.info("quantized logits head to w%d-channel", args.head_bits)

    if args.moe_layout == "w8pc":
        from ..ops.linear import moe_w8pc_layout

        params = moe_w8pc_layout(params)
        logger.info("applied the w8pc fused MoE expert serving layout")

    tokenizer = load_tokenizer(str(ckpt))
    text = Path(args.text_file).read_text()
    ids = np.asarray(tokenizer(text, truncation=False)["input_ids"], dtype=np.int32)
    logger.info("tokenized %d chars -> %d tokens", len(text), len(ids))
    batches, n_windows = make_batches(ids, args.window, args.stride, args.batch_size,
                                      args.max_windows)

    t0 = time.perf_counter()
    ppl = perplexity(spec, params, batches, device=dev)
    dt = time.perf_counter() - t0
    n_tok = sum(int(m.sum()) for _, m in batches)
    logger.info("scored %d tokens in %d batches in %.6f s", n_tok, len(batches), dt)
    print(f"ppl={ppl:.4f} tokens={n_tok} windows={n_windows} "
          f"eval_s={dt:.1f} tok/s={n_tok/dt:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
