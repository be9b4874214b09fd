"""Serving CLI: continuous-batching generation from a checkpoint.

Counterpart of ``quantizers_tpu/cli/serve.py``: loads a compressed-tensors
(or plain HF) checkpoint into the port's layouts and decodes the prompts
through :class:`~quantizers_tpu_torch.serve.session.ContinuousBatcher`.

    python -m quantizers_tpu_torch.cli.serve <ckpt_dir> --prompt "..." \
        [--prompt-file prompts.txt] [--max-new-tokens 64] \
        [--max-batch 8] [--max-len 2048] [--head-bits 8] [--device cpu]

Prompts come from ``--prompt`` (repeatable) and/or ``--prompt-file`` (one
prompt per line); outputs print as ``<rid>\\t<text>`` lines. Without
``--device`` it runs on the CUDA card. ``--mesh`` (sharding over several
devices) waits for ROADMAP slice 8.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

logger = logging.getLogger("quantizers_tpu_torch.serve")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Continuous-batching generation")
    p.add_argument("ckpt_dir")
    p.add_argument("--prompt", action="append", default=[],
                   help="prompt text (repeatable)")
    p.add_argument("--prompt-file", default=None,
                   help="file with one prompt per line")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--head-bits", type=int, default=None,
                   help="quantize the logits head for serving (8 = per-channel int8; "
                        "halves the tied head's bytes per decode step)")
    p.add_argument("--mesh", default=None,
                   help="mesh axes, e.g. dp=1,tp=4: not ported yet (ROADMAP slice 8)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    if args.mesh:
        raise NotImplementedError(
            "serve --mesh: multi-device serving is not ported yet: ROADMAP queue 1, slice 8")

    from .._device import resolve_device
    from ..data.simple_tokenizer import load_tokenizer
    from ..models.loader import load_checkpoint
    from ..serve.session import ContinuousBatcher

    prompts = list(args.prompt)
    if args.prompt_file:
        prompts += [ln for ln in Path(args.prompt_file).read_text().splitlines() if ln.strip()]
    if not prompts:
        p.error("no prompts: pass --prompt and/or --prompt-file")

    dev = resolve_device(args.device)
    ckpt = Path(args.ckpt_dir)
    t0 = time.perf_counter()
    spec, params, cfg = load_checkpoint(ckpt, device=dev)
    logger.info("loaded %s in %.3f s", ckpt, time.perf_counter() - t0)
    tokenizer = load_tokenizer(str(ckpt))

    eos = cfg.get("eos_token_id")
    eos = [eos] if isinstance(eos, int) else [int(e) for e in eos or []]

    batcher = ContinuousBatcher(spec, params, max_batch=args.max_batch, max_len=args.max_len,
                                eos_ids=eos, head_bits=args.head_bits, device=dev)
    del params
    for text in prompts:
        batcher.submit(tokenizer(text)["input_ids"], max_new_tokens=args.max_new_tokens)

    t0 = time.perf_counter()
    results = batcher.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    for rid in sorted(results):
        out = results[rid]
        try:
            text = tokenizer.decode(out)
        except Exception:
            text = " ".join(str(t) for t in out)
        print(f"{rid}\t{text}")
    logger.info("generated %d tokens for %d prompts in %.3f s (%.1f tok/s)",
                n_tok, len(prompts), dt, n_tok / max(dt, 1e-9))
    return 0


if __name__ == "__main__":
    sys.exit(main())
