"""Worlds of ``gloo`` processes on the CPU for the port's parallel tests.

The tests hand :func:`run_world` a case name and its inputs; it writes the
inputs under a scratch directory, starts one process per rank (this file,
run as a script), and returns each rank's outputs. The ranks meet through
a ``file://`` store in that directory (no TCP port, so that concurrent test
workers never collide), each on one CPU thread, and every collective waits
at most ``TIMEOUT_S`` for a lost rank. A world that has not finished
within its deadline is killed and its test fails.

This module imports neither JAX nor the JAX package, so that the ranks
never load them.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
#: seconds a rank's collective waits for a lost peer
TIMEOUT_S = 30
#: seconds a whole world may take
DEADLINE_S = 60


def world_env(tmp: Path, world: int, rank: int, extra: Optional[Dict[str, str]] = None
              ) -> Dict[str, str]:
    """The environment of rank ``rank``: the port's launch variables with a
    file store under ``tmp``."""
    env = dict(os.environ)
    env.update({"QTPU_COORDINATOR": f"file://{tmp / 'store'}",
                "QTPU_NUM_PROCESSES": str(world), "QTPU_PROCESS_ID": str(rank),
                "QTPU_DIST_TIMEOUT": str(TIMEOUT_S), "OMP_NUM_THREADS": "1",
                "PYTHONPATH": os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])})
    env.pop("LOCAL_RANK", None)
    env.update(extra or {})
    return env


def run_procs(cmds: List[List[str]], envs: List[Dict[str, str]], cwd: Path,
              deadline_s: float = DEADLINE_S) -> List[str]:
    """Run the ranks' commands together; their outputs (stdout and stderr
    merged). Raises with every rank's output where one fails or the world
    outlives its deadline (its processes are killed)."""
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(cmds, envs)]
    end = time.monotonic() + deadline_s
    outs: List[str] = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            try:
                outs[i], _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs[i] = (p.communicate()[0] or "") + "\n[killed at the deadline]"
                raise AssertionError(f"world past its {deadline_s} s deadline:\n"
                                     + "\n".join(f"--- rank {r}\n{o[-3000:]}"
                                                 for r, o in enumerate(outs)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(f"--- rank {r} (rc {procs[r].returncode})\n{outs[r][-3000:]}"
                                       for r in range(len(procs))))
    return outs


def run_world(case: str, world: int, inputs: Dict[str, Any], tmp: Path,
              extra_env: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    """Run ``case`` on ``world`` ranks with ``inputs``; each rank's outputs."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp / "inputs.pt")
    cmds = [[sys.executable, __file__, case, str(tmp)] for _ in range(world)]
    envs = [world_env(tmp, world, r, extra_env) for r in range(world)]
    run_procs(cmds, envs, ROOT)
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _dp_rows(mesh, n: int) -> slice:
    dp, d = mesh.size("dp"), mesh.coords.get("dp", 0)
    return slice(d * n // dp, (d + 1) * n // dp)


def case_forward(inp: Dict[str, Any], mesh) -> Dict[str, Any]:
    """No-cache logits of the rank's dp rows; then, with ``decode_steps``,
    a prefill and teacher-forced one-token steps through the caches."""
    from quantizers_tpu_torch.models import KVCache, forward
    from quantizers_tpu_torch.ops.linear import infer_expert_shards
    from quantizers_tpu_torch.parallel import shard_params

    spec, params = shard_params(inp["spec"], inp["params"], mesh, device="cpu")
    ids = torch.as_tensor(inp["ids"])[_dp_rows(mesh, inp["ids"].shape[0])]
    with torch.no_grad():
        logits, _ = forward(params, spec, ids)
        out = {"logits": logits, "heads": (spec.num_heads, spec.num_kv_heads),
               "expert_shards": infer_expert_shards(params)}
        steps = inp.get("decode_steps", 0)
        if steps:
            T0 = ids.shape[1] - steps
            caches = KVCache.init(spec, ids.shape[0], ids.shape[1] + 8, device="cpu")
            lg, caches = forward(params, spec, ids[:, :T0], caches=caches)
            dec = [lg[:, -1]]
            for t in range(T0, ids.shape[1]):
                lg, caches = forward(params, spec, ids[:, t:t + 1], caches=caches)
                dec.append(lg[:, 0])
            out["decode_logits"] = torch.stack(dec, dim=1)
            out["cache_heads"] = caches[0].k.shape[1]
    return out


def case_generate(inp: Dict[str, Any], mesh) -> Dict[str, Any]:
    from quantizers_tpu_torch.parallel import shard_params
    from quantizers_tpu_torch.serve import generate

    spec, params = shard_params(inp["spec"], inp["params"], mesh, device="cpu")
    return {"tokens": generate(spec, params, inp["prompt"], max_new_tokens=inp["steps"],
                               device="cpu")}


def case_batcher(inp: Dict[str, Any], mesh) -> Dict[str, Any]:
    from quantizers_tpu_torch.ops.linear import infer_expert_shards
    from quantizers_tpu_torch.parallel import shard_params
    from quantizers_tpu_torch.serve.session import ContinuousBatcher

    spec, params = shard_params(inp["spec"], inp["params"], mesh, device="cpu")
    b = ContinuousBatcher(spec, params, max_batch=2, max_len=32, prefill_buckets=(8,),
                          device="cpu")
    rids = [b.submit(p, n) for p, n in inp["requests"]]
    res = b.run()
    return {"tokens": [res[r] for r in rids], "expert_shards": infer_expert_shards(b.params),
            "layers0": sorted(b.params["layers"][1]["moe"])}


def case_ring(inp: Dict[str, Any], mesh) -> Dict[str, Any]:
    from quantizers_tpu_torch.parallel import ring_attention

    out = ring_attention(inp["q"], inp["k"], inp["v"], inp["sm"], mesh, axis="cp",
                         causal=inp["causal"])
    errors = []
    if inp.get("check_errors"):
        bad = torch.zeros((1, 2, 10, 8))
        for axis in ("cp", "nope"):
            try:
                ring_attention(bad, bad, bad, 1.0, mesh, axis=axis)
            except ValueError as e:
                errors.append(str(e))
    return {"out": out, "errors": errors}


def case_pod_loss(inp: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A pod mesh's layout and the sharded mean next-token NLL of a batch
    split over dp (the tp ranks of a dp group agree)."""
    import torch.distributed as dist

    from quantizers_tpu_torch.models import forward
    from quantizers_tpu_torch.parallel import shard_params

    spec, params = shard_params(inp["spec"], inp["params"], mesh, device="cpu")
    ids = torch.as_tensor(inp["ids"])[_dp_rows(mesh, inp["ids"].shape[0])].long()
    with torch.no_grad():
        logits, _ = forward(params, spec, ids)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, ids[:, 1:, None]).sum()
    tot = torch.stack([nll, torch.tensor(float(ids[:, 1:].numel()))])
    dp = mesh.group("dp")
    if dp is not None:
        dist.all_reduce(tot, group=dp.group)
    return {"loss": float(tot[0] / tot[1]), "devices": mesh.devices.tolist(),
            "tp_ranks": mesh.group("tp").ranks, "world": dist.get_world_size()}


def case_cuda_collectives(inp: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One collective of the model on CUDA tensors, checked against the
    values every rank can compute itself."""
    g = mesh.group("tp")
    r, dev = g.index, torch.device(inp["device"])
    base = torch.arange(2 * 2560, device=dev, dtype=torch.float32).reshape(2, 2560) / 1024
    if inp["case"] == "all_reduce":
        got = g.all_reduce_f32((base * (r + 1)).bfloat16())
        want = (base.bfloat16().float() * 1 + (base * 2).bfloat16().float()).bfloat16()
        ok = got.dtype == torch.bfloat16 and got.is_cuda and torch.equal(got, want)
    elif inp["case"] == "all_gather":
        got = g.all_gather_last((base + r).bfloat16())
        want = torch.cat([base.bfloat16(), (base + 1).bfloat16()], dim=-1)
        ok = got.is_cuda and torch.equal(got, want)
    else:
        k = (base + 10 * r).bfloat16()
        recv = g.ring_shift([k, k * 2]).wait()
        prev = (base + 10 * (1 - r)).bfloat16()
        ok = all(t.is_cuda for t in recv) and torch.equal(recv[0], prev) and \
            torch.equal(recv[1], prev * 2)
    torch.cuda.synchronize(dev)
    return {"ok": bool(ok), "backend": g.backend}


CASES = {"cuda_collectives": case_cuda_collectives, "forward": case_forward,
         "generate": case_generate, "batcher": case_batcher, "ring": case_ring,
         "pod_loss": case_pod_loss}


def _rank_main(case: str, tmp: Path) -> None:
    torch.set_num_threads(1)
    from quantizers_tpu_torch.parallel import initialize, make_mesh, make_pod_mesh
    from quantizers_tpu_torch.parallel.distributed import shutdown

    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    assert initialize(device=inp.get("device", "cpu")) is True
    import torch.distributed as dist

    mesh = (make_pod_mesh(inp["mesh"], dcn_axes=("dp",)) if inp.get("pod")
            else make_mesh(inp["mesh"]))
    out = CASES[case](inp, mesh)
    out["rank"], out["coords"] = dist.get_rank(), mesh.coords
    torch.save(out, tmp / f"out_{dist.get_rank()}.pt")
    shutdown()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1], Path(sys.argv[2]))
