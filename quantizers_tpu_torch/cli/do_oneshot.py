"""Main CLI: an end-to-end calibrated quantization run.

Counterpart of ``quantizers_tpu/cli/do_oneshot.py``, the reference's
``scripts/do_oneshot.py`` (args :47-79, stage flow :99-203): YAML run
config -> calibration set (cache-or-build) -> model + tokenizer -> tokenize
-> oneshot -> compressed checkpoint, with the wall-clock time of every
stage in the log.

Usage::

    python -m quantizers_tpu_torch.cli.do_oneshot --config configs/test-quantize_tiny-awq.yaml \\
        [--output outputs/...] [--cache-dir ./cache] [--log-file run.log] [--debug] \\
        [--pipeline sequential|independent|basic] [--batch-size 4] [--device cpu] \\
        [--profile-dir trace/]

It runs on the CUDA card unless ``--device`` names another device. The
model is a local HF checkpoint directory; the calibration datasets are
read through HF ``datasets`` (local directories, such as the repository's
``tests/fixtures``, need no network). Every modifier of the JAX package
runs: ``QuantizationModifier`` (RTN), ``GPTQModifier``, ``AWQModifier``,
``SmoothQuantModifier`` and ``AutoRoundModifier``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import shutil
import sys
import time
from pathlib import Path

logger = logging.getLogger("quantizers_tpu_torch.do_oneshot")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Calibrated oneshot quantization")
    p.add_argument("--config", required=True, help="run-config YAML path")
    p.add_argument("--output", default=None,
                   help="output dir (default outputs/<model>-<recipe>)")
    p.add_argument("--cache-dir", default="./cache",
                   help="calibration-set Parquet cache dir")
    p.add_argument("--log-file", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--pipeline", default=None,
                   choices=["sequential", "independent", "basic"])
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-calibration-samples", type=int, default=None)
    p.add_argument("--max-seq-length", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--no-moe-calibrate-all-experts", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the oneshot stage into this "
                        "directory (oneshot_trace.json, for chrome://tracing or Perfetto)")
    return p.parse_args(argv)


def setup_logging(log_file=None, debug=False) -> None:
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers, force=True)


def default_output_dir(config_path: str, model_name: str, recipe: str) -> str:
    model_leaf = model_name.rstrip("/").split("/")[-1]
    recipe_leaf = Path(recipe).stem.replace("recipe_", "")
    return str(Path("outputs") / f"{model_leaf}-{recipe_leaf}")


def _profiler(profile_dir, dev):
    """A torch.profiler context over the host and, on the card, the device."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def save_result(spec, res, out_dir, tokenizer, model_path: Path, device) -> None:
    """Write a oneshot result as a compressed-tensors checkpoint: the
    records (held on the host; packed on ``device``), every other tensor in
    bf16, the extra tensors (activation and KV-cache scales), the tokenizer
    and the source's tokenizer assets."""
    import torch

    from ..formats.checkpoint import save_compressed_model
    from ..models.loader import iter_model_linears, model_plain_tensors

    plain = model_plain_tensors(spec, res.params)
    for prefix, lin in iter_model_linears(spec, res.params):
        if prefix not in res.records:
            plain[f"{prefix}.weight"] = lin.dequantize(torch.bfloat16).t()
            if lin.bias is not None:
                plain[f"{prefix}.bias"] = lin.bias
    for name, t in res.extra_tensors.items():
        plain[name] = t
    save_compressed_model(
        out_dir, plain, res.records,
        config_groups=res.config_groups, ignore=res.ignore,
        base_config=spec.to_hf_config(), kv_cache_scheme=res.kv_cache_scheme,
        pack_device=device)
    tokenizer.save_pretrained(out_dir)
    for f in Path(model_path).iterdir():
        if f.name.startswith("tokenizer") or f.name in ("special_tokens_map.json",
                                                        "generation_config.json"):
            shutil.copy2(f, Path(out_dir) / f.name)


def main(argv=None) -> int:
    from ..utils import enable_persistent_cache

    enable_persistent_cache()  # the kernels' library, built once for every later process
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    args = parse_args(argv)
    setup_logging(args.log_file, args.debug)

    import torch

    from .._device import resolve_device
    from ..config import load_quantization_config
    from ..data.calibration_sets import CalibrationSet
    from ..data.simple_tokenizer import load_tokenizer
    from ..models.loader import load_hf_model
    from ..oneshot import make_batches, oneshot
    from ..recipes import parse_recipe, resolve_recipe_path

    def synced() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    dev = resolve_device(args.device)
    t_start = time.time()
    run = load_quantization_config(args.config)
    recipe_path = resolve_recipe_path(run.quantization.recipe, args.config)
    recipe = parse_recipe(recipe_path)
    if args.pipeline:
        recipe.pipeline = args.pipeline
    out_dir = args.output or default_output_dir(
        args.config, run.model.name, run.quantization.recipe)
    logger.info("model=%s recipe=%s output=%s device=%s", run.model.name, recipe_path,
                out_dir, dev)

    # ---- calibration set: cache-or-build ---------------------------------
    t0 = time.time()
    calib = None
    if run.calibration_set_config is not None:
        cfg = run.calibration_set_config
        if args.max_seq_length:
            cfg.max_seq_length = args.max_seq_length
        if CalibrationSet.is_cached(cfg, args.cache_dir):
            calib = CalibrationSet.from_cache(cfg, args.cache_dir)
            logger.info("calibration set loaded from cache in %.3fs", time.time() - t0)
        else:
            calib = CalibrationSet.from_config(cfg, args.cache_dir)
            calib.save_to_cache()
            logger.info("calibration set built+cached in %.3fs (%d samples)",
                        time.time() - t0, calib.total_num_samples)

    # ---- model + tokenizer ------------------------------------------------
    t0 = time.time()
    model_path = Path(run.model.name)
    if not model_path.exists():
        logger.error(
            "model %s is not a local directory: download the checkpoint first "
            "(this CLI fetches nothing)", run.model.name)
        return 2
    spec, params = load_hf_model(model_path, device=dev)
    tokenizer = load_tokenizer(str(model_path))
    logger.info("model loaded in %.3fs (%d layers, hidden %d, moe=%s)",
                synced() - t0, spec.num_layers, spec.hidden_size, spec.is_moe)

    # ---- tokenize ----------------------------------------------------------
    t0 = time.time()
    batches = []
    if calib is not None:
        tokenized = calib.get_tokenized(tokenizer)
        rows = [r["input_ids"] for r in tokenized]
        if args.num_calibration_samples:
            rows = rows[: args.num_calibration_samples]
        batches = make_batches(rows, max_seq_length=calib.config.max_seq_length,
                               batch_size=args.batch_size)
        logger.info("tokenized %d samples -> %d batches in %.3fs",
                    len(rows), len(batches), time.time() - t0)

    # ---- oneshot -----------------------------------------------------------
    t0 = time.time()
    with _profiler(args.profile_dir, dev) as prof:
        res = oneshot(spec, params, recipe, batches,
                      moe_calibrate_all_experts=not args.no_moe_calibrate_all_experts,
                      device=dev)
    del params
    if prof is not None:
        Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
        trace = Path(args.profile_dir) / "oneshot_trace.json"
        prof.export_chrome_trace(str(trace))
        logger.info("torch.profiler trace written to %s", trace)
    logger.info("oneshot done in %.3fs (%d quantized modules)",
                synced() - t0, len(res.records))
    logger.info("oneshot stages: capture %.3fs, solve %.3fs, propagate %.3fs",
                res.stats.get("capture_s", 0.0), res.stats.get("solve_s", 0.0),
                res.stats.get("propagate_s", 0.0))

    # ---- save --------------------------------------------------------------
    t0 = time.time()
    save_result(spec, res, out_dir, tokenizer, model_path, dev)
    logger.info("saved compressed model to %s in %.3fs", out_dir, time.time() - t0)
    logger.info("total wall clock: %.3fs", time.time() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
