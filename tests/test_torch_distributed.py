"""Multi-process bring-up of the port: ``initialize`` and ``make_pod_mesh``.

The counterpart of ``tests/test_distributed.py``: four real OS processes
(``gloo`` on the CPU, ``tests/_torch_dist_workers.py``) brought up by
``parallel.distributed.initialize`` from the ``QTPU_*`` environment, as
two simulated nodes of two ranks (``LOCAL_WORLD_SIZE=2``), a pod mesh whose
``dp`` axis spans the nodes and whose ``tp`` axis stays within one, and a
sharded W4A16 forward's mean next-token NLL, equal on every rank, to the
unsharded port's and to the JAX package's within 2e-3 (relative; bf16
logits, an f32 mean over 60 tokens). In this process: what ``initialize``
does without a multi-process launch, and what it refuses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _quantize_params_rtn
from _torch_dist_workers import run_world
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.parallel import initialize
from quantizers_tpu_torch.parallel.distributed import make_pod_mesh

GEOM = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=8, num_kv_heads=4,
            head_dim=16, intermediate_size=256, qk_norm=True, model_type="qwen3")
LOSS_RTOL = 2e-3


def _nll(logits, ids):
    logp = torch.log_softmax(torch.as_tensor(np.asarray(logits, np.float32))[:, :-1], dim=-1)
    tgt = torch.as_tensor(np.asarray(ids)).long()[:, 1:, None]
    return float(-torch.gather(logp, -1, tgt).mean())


def test_four_processes_as_two_nodes(tmp_path):
    jspec = JSpec(**GEOM)
    jp = _quantize_params_rtn(jspec, jinit(jspec, jax.random.PRNGKey(0)),
                              expert_scheme="W4A16_G32")
    spec, params = ModelSpec(**GEOM), params_from_numpy(jp, device="cpu")
    ids = (np.arange(4 * 16).reshape(4, 16) * 17 + 1) % GEOM["vocab_size"]
    # tp first: a plain row-major mesh would put each tp pair across the nodes
    outs = run_world("pod_loss", 4, {"spec": spec, "params": params, "ids": ids, "pod": True,
                                     "mesh": {"tp": 2, "dp": 2}}, tmp_path,
                     extra_env={"LOCAL_WORLD_SIZE": "2"})
    assert [o["world"] for o in outs] == [4] * 4
    assert outs[0]["devices"] == [[0, 2], [1, 3]]  # dp spans the nodes {0, 1} and {2, 3}
    assert sorted({tuple(o["tp_ranks"]) for o in outs}) == [(0, 1), (2, 3)]
    losses = {o["loss"] for o in outs}
    assert len(losses) == 1  # every rank holds the same global loss
    loss = losses.pop()
    with torch.no_grad():
        ref = _nll(forward(params, spec, torch.as_tensor(ids))[0].float().numpy(), ids)
    want = _nll(jforward(jp, jspec, jnp.asarray(ids, jnp.int32))[0], ids)
    assert np.isfinite(loss)
    assert loss == pytest.approx(ref, rel=LOSS_RTOL)
    assert loss == pytest.approx(want, rel=LOSS_RTOL)


def test_initialize_single_process_and_its_refusals(monkeypatch):
    for var in ("QTPU_COORDINATOR", "QTPU_NUM_PROCESSES", "QTPU_PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False  # one process: nothing to bring up
    mesh = make_pod_mesh({"dp": 1, "tp": 1})
    assert mesh.shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="mesh needs 2 ranks, have 1"):
        make_pod_mesh({"dp": 2})
    monkeypatch.setenv("QTPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        initialize()
    monkeypatch.setenv("QTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("QTPU_PROCESS_ID", "0")
    # no device named: no silent CPU run, no guessed card
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        initialize()
    monkeypatch.setenv("LOCAL_RANK", "0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize()
