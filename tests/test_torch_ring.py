"""Ring (context-parallel) attention of the port against the JAX package.

Each case runs the port's ``ring_attention`` in a world of ``gloo``
processes on the CPU (``tests/_torch_dist_workers.py``), the sequence split
over a ``cp`` axis and the K/V blocks passed around the ring by
``batch_isend_irecv``; the JAX package's ``ring_attention`` runs in this
process on the virtual CPU devices, on the same f32 inputs. Tolerance: f32
outputs within atol 1e-5 of JAX's, and of the plain softmax.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_dist_workers import run_world
from quantizers_tpu.parallel import make_mesh as jmake_mesh
from quantizers_tpu.parallel.ring import ring_attention as jring

ATOL = 1e-5


def _oracle(q, k, v, sm, causal=True):
    H, KV = q.shape[1], k.shape[1]
    kr, vr = np.repeat(k, H // KV, axis=1), np.repeat(v, H // KV, axis=1)
    s = np.einsum("bhtd,bhsd->bhts", q, kr) * sm
    if causal:
        T = q.shape[2]
        s = np.where(np.tril(np.ones((T, T), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bhsd->bhtd", p, vr)


def _inputs(B, H, KV, T, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.4).astype(np.float32)
            for s in ((B, H, T, d), (B, KV, T, d), (B, KV, T, d))]


def _jax(q, k, v, sm, axes, causal):
    mesh = jmake_mesh(axes)
    with mesh:
        out = jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm, mesh, axis="cp",
                    causal=causal)
    return np.asarray(out)


@pytest.mark.parametrize("cp,rep,causal", [(2, 1, True), (2, 4, False), (4, 2, True),
                                           (4, 4, False), (4, 1, True)])
def test_ring_matches_jax(cp, rep, causal, tmp_path):
    B, KV, d = 2, 2, 32
    T = 8 * cp
    q, k, v = _inputs(B, KV * rep, KV, T, d, seed=11 + cp + rep)
    sm = 1.0 / np.sqrt(d)
    outs = run_world("ring", cp, {"mesh": {"cp": cp}, "q": torch.from_numpy(q),
                                  "k": torch.from_numpy(k), "v": torch.from_numpy(v),
                                  "sm": sm, "causal": causal,
                                  "check_errors": cp == 4 and rep == 1}, tmp_path)
    want = _jax(q, k, v, sm, {"cp": cp}, causal)
    ref = _oracle(q, k, v, sm, causal)
    for o in outs:  # every rank gathers the whole output
        got = o["out"].numpy()
        assert got.shape == (B, KV * rep, T, d)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    if cp == 4 and rep == 1:
        # the JAX package's shape errors: T = 10 on cp 4, an axis the mesh lacks
        for o in outs:
            assert len(o["errors"]) == 2
            assert "must divide the sequence length T=10" in o["errors"][0]
            assert "mesh has no axis 'nope'" in o["errors"][1]
        jmesh = jmake_mesh({"cp": 4})
        bad = jnp.zeros((1, 2, 10, 8))
        for axis in ("cp", "nope"):
            with pytest.raises(ValueError):
                jring(bad, bad, bad, 1.0, jmesh, axis=axis)


def test_ring_composes_with_dp(tmp_path):
    """cp ring inside a dp x cp mesh: each dp group runs its own ring over
    the same sequence (JAX's test_composes_with_dp)."""
    B, KV, T, d = 2, 1, 16, 32
    q, k, v = _inputs(B, KV, KV, T, d, seed=12)
    sm = 1.0 / np.sqrt(d)
    axes = {"dp": 2, "cp": 2}
    outs = run_world("ring", 4, {"mesh": axes, "q": torch.from_numpy(q),
                                 "k": torch.from_numpy(k), "v": torch.from_numpy(v),
                                 "sm": sm, "causal": True}, tmp_path)
    want = _jax(q, k, v, sm, axes, True)
    assert sorted((o["coords"]["dp"], o["coords"]["cp"]) for o in outs) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        np.testing.assert_allclose(o["out"].numpy(), want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(o["out"].numpy(), _oracle(q, k, v, sm), rtol=0, atol=ATOL)
