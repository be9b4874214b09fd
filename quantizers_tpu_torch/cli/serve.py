"""Serving CLI: continuous-batching generation from a checkpoint.

Counterpart of ``quantizers_tpu/cli/serve.py``: loads a compressed-tensors
(or plain HF) checkpoint into the port's layouts and decodes the prompts
through :class:`~quantizers_tpu_torch.serve.session.ContinuousBatcher`.

    python -m quantizers_tpu_torch.cli.serve <ckpt_dir> --prompt "..." \
        [--prompt-file prompts.txt] [--max-new-tokens 64] \
        [--max-batch 8] [--max-len 2048] [--head-bits 8] [--device cpu] \
        [--mesh dp=1,tp=4]

Prompts come from ``--prompt`` (repeatable) and/or ``--prompt-file`` (one
prompt per line); outputs print as ``<rid>\t<text>`` lines, ``rid`` the
prompt's index. Without ``--device`` it runs on the CUDA card.

``--mesh`` runs one process per rank (:mod:`~quantizers_tpu_torch.parallel`):
each loads the checkpoint on the host, keeps only its shard on its device
(``tp`` splits heads and features, ``ep`` experts) and serves; ``dp``
splits the prompts among its groups, and rank 0 prints every line, in
prompt order. On several cards of one node (NCCL)::

    torchrun --nproc-per-node 4 -m quantizers_tpu_torch.cli.serve <ckpt> --mesh tp=4 \
        --prompt-file prompts.txt

As two ranks on one card (NCCL refuses two ranks on a device, so they take
``gloo``; start both, ``i`` in 0 and 1)::

    QTPU_COORDINATOR=127.0.0.1:29500 QTPU_NUM_PROCESSES=2 QTPU_PROCESS_ID=$i \
        LOCAL_RANK=0 QTPU_DIST_BACKEND=gloo \
        python -m quantizers_tpu_torch.cli.serve <ckpt> --mesh tp=2 --prompt-file prompts.txt

In one process ``--mesh tp=1`` serves the whole model through the same
path, and a mesh of more ranks than the run has raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import torch

logger = logging.getLogger("quantizers_tpu_torch.serve")


def main(argv=None) -> int:
    from ..utils import enable_persistent_cache

    enable_persistent_cache()  # the kernels' library, built once for every later process
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
                   help="mesh axes, e.g. dp=1,tp=4: one process per rank (module docstring)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from .._device import resolve_device
    from ..data.simple_tokenizer import load_tokenizer
    from ..models.loader import load_checkpoint
    from ..serve.session import ContinuousBatcher

    prompts = list(args.prompt)
    if args.prompt_file:
        prompts += [ln for ln in Path(args.prompt_file).read_text().splitlines() if ln.strip()]
    if not prompts:
        p.error("no prompts: pass --prompt and/or --prompt-file")

    ckpt = Path(args.ckpt_dir)
    mesh, multi = None, False
    t0 = time.perf_counter()
    if args.mesh:
        from ..parallel import initialize, make_pod_mesh, parse_mesh_arg, shard_params

        multi = initialize(device=args.device)
        mesh = make_pod_mesh(parse_mesh_arg(args.mesh))
        dev = mesh.device or resolve_device(args.device)
        # the whole model on the host; only this rank's shard reaches its device
        spec, params, cfg = load_checkpoint(ckpt, device="cpu")
        spec, params = shard_params(spec, params, mesh, device=dev)
        dp, d = mesh.size("dp"), mesh.coords.get("dp", 0)
        mine = [i for i in range(len(prompts)) if i % dp == d]
        logger.info("rank %d of mesh %s, coordinates %s, on %s", mesh.rank, mesh.shape,
                    mesh.coords, dev)
    else:
        dev = resolve_device(args.device)
        spec, params, cfg = load_checkpoint(ckpt, device=dev)
        mine = list(range(len(prompts)))
    logger.info("loaded %s in %.3f s", ckpt, time.perf_counter() - t0)
    tokenizer = load_tokenizer(str(ckpt))

    eos = cfg.get("eos_token_id")
    eos = [eos] if isinstance(eos, int) else [int(e) for e in eos or []]

    batcher = ContinuousBatcher(spec, params, max_batch=args.max_batch, max_len=args.max_len,
                                eos_ids=eos, head_bits=args.head_bits, device=dev)
    del params
    index_of = {batcher.submit(tokenizer(prompts[i])["input_ids"],
                               max_new_tokens=args.max_new_tokens): i for i in mine}

    if mesh is not None:
        from ..parallel import collectives

        collectives.reset_stats()
    t0 = time.perf_counter()
    results = {index_of[rid]: out for rid, out in batcher.run().items()}
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    if mesh is not None:
        logger.info("collectives over %d batcher steps: %s", batcher.steps, collectives.stats())
        if dev.type == "cuda":
            logger.info("peak device memory %.3f GB", torch.cuda.max_memory_allocated(dev) / 1e9)
        if multi:
            import torch.distributed as dist

            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, results)
            for part in gathered:  # the dp groups' prompts; a tp group's ranks agree
                results.update(part)
    if mesh is None or mesh.rank == 0:
        for i in sorted(results):
            out = results[i]
            try:
                text = tokenizer.decode(out)
            except Exception:
                text = " ".join(str(t) for t in out)
            print(f"{i}\t{text}")
    logger.info("generated %d tokens for %d prompts in %.3f s (%.1f tok/s)",
                n_tok, len(mine), dt, n_tok / max(dt, 1e-9))
    if multi:
        from ..parallel.distributed import shutdown

        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
