#!/usr/bin/env python3
"""The perplexity protocol's W4A16 orderings on one fitted checkpoint,
through either package's ``do_oneshot`` and ``eval_ppl``, on the CPU.

    python probes/protocol_orderings.py WORK_DIR {port,jax} [--quantize port,jax]

Fits the protocol's tiny model (``chip_smoke.PROTOCOL_MODEL``: hidden 96,
2 layers, vocab 512, 2,500 steps) to ``chip_smoke.chain_text()`` with the
named package's ``make_tiny_model --fit-corpus`` (kept in WORK_DIR and
reused), then quantizes it with RTN, AWQ and GPTQ at W4A16 g32 over the
protocol's in-domain calibration set with each package named by
``--quantize``, and scores each checkpoint on the corpus's first 24,000
characters in 128-token windows, as ``chip_smoke.protocol_phase`` does on
the card. Prints one JSON line a quantizing package: the perplexities and
the deltas. It tells a fault of the port's quantizers from a property of
the checkpoint: the same checkpoint through both packages. About 3
minutes a package on 8 cores, the fit 1-2 minutes more.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("work")
    p.add_argument("fit", choices=["port", "jax"])
    p.add_argument("--quantize", default="port,jax")
    args = p.parse_args()
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        os.environ[var] = "1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as c

    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    os.environ["HF_HOME"] = str(work / "hf_home")
    text = c.chain_text()
    corpus, eval_file = work / "corpus.txt", work / "eval.txt"
    corpus.write_text(text)
    eval_file.write_text(text[:24000])
    model = work / f"tiny_{args.fit}"
    if not model.exists():
        if args.fit == "port":
            from quantizers_tpu_torch.cli import make_tiny_model
            argv = ["--device", "cpu"]
        else:
            from quantizers_tpu.cli import make_tiny_model
            argv = ["--platform", ""]
        argv = [str(model), *c.PROTOCOL_MODEL, "--fit-corpus", str(corpus), *argv]
        if make_tiny_model.main(argv) != 0:
            return 1
    ds_dir = work / "chain_calib"
    ds_dir.mkdir(exist_ok=True)
    rows = [{"text": text[s:s + 256]} for s in range(0, 32 * 256, 256)]
    (ds_dir / "dataset.json").write_text(json.dumps(rows))
    calib = work / "calibrate_chain.yaml"
    calib.write_text(f"calibration_set:\n  max_seq_length: 256\n  shuffle: true\n  seed: 42\n"
                     f"  datasets:\n    - dataset: {ds_dir}\n      split: train\n"
                     f"      columns: [text]\n      formatter: raw_text\n      num_samples: 32\n")
    recipes = {"w4a16_awq": ROOT / "configs" / "recipes" / "recipe_awq_w4a16.yaml"}
    for tag, body in c.PROTOCOL_RECIPES.items():
        recipes[tag] = work / f"recipe_{tag}.yaml"
        recipes[tag].write_text(f"quant_stage:\n  quant_modifiers:\n{body}")

    def ppl(pkg: str, ckpt: Path) -> float:
        if pkg == "port":
            from quantizers_tpu_torch.cli.eval_ppl import main as eval_ppl
            extra = ["--device", "cpu"]
        else:
            from quantizers_tpu.cli.eval_ppl import main as eval_ppl
            extra = []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = eval_ppl([str(ckpt), str(eval_file), "--window", "128", "--stride", "128",
                           *extra])
        if rc != 0:
            raise RuntimeError(f"eval_ppl {pkg} {ckpt}: {rc}")
        return float(out.getvalue().strip().splitlines()[-1].split()[0].split("=")[1])

    for pkg in args.quantize.split(","):
        if pkg == "port":
            from quantizers_tpu_torch.cli.do_oneshot import main as do_oneshot
            extra = ["--device", "cpu"]
        else:
            from quantizers_tpu.cli.do_oneshot import main as do_oneshot
            extra = []
        res = {"fit": args.fit, "quantize": pkg, "bf16": ppl(pkg, model)}
        for tag in ("w4a16_awq", "w4a16_rtn", "w4a16_gptq"):
            run_cfg = work / f"run_{tag}.yaml"
            run_cfg.write_text(f"model:\n  name: {model}\nquantization:\n  recipe: "
                               f"{recipes[tag]}\ncalibration_set: {calib}\n")
            out = work / f"out_{args.fit}_{pkg}_{tag}"
            if do_oneshot(["--config", str(run_cfg), "--output", str(out), "--cache-dir",
                           str(work / f"cache_{pkg}"), "--max-seq-length", "128", *extra]) != 0:
                return 1
            res[tag] = ppl(pkg, out)
        res["delta"] = {tag: res[tag] - res["bf16"] for tag in recipes}
        res["awq_le_rtn"] = res["w4a16_awq"] <= res["w4a16_rtn"]
        res["gptq_le_rtn"] = res["w4a16_gptq"] <= res["w4a16_rtn"]
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
