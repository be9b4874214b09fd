"""Port parity for MLA (multi-head latent attention): the MLA decode
kernel's plain version against the JAX package's Pallas kernel in
interpret mode, ``mla_attention`` in its three regimes, the absorbed
weights, the FP8 KV cache, and the tiny MLA+MoE model.

Tolerances. The decode kernel's plain version sums the same bf16 products
in f32 as the Pallas kernel and rounds p to bf16 at the same point: held to
one bf16 ulp of each value (measured: equal), its cache rows exactly. The
attention outputs and logits: 8e-3 absolute on values within about 2 of 0,
two bf16 ulps there; both sides round at the same points, but f32 sums run
in other orders and the flash plain version walks other key blocks.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.models import KVCache as JKVCache
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.models import transformer as jt
from quantizers_tpu.ops import kernels as JK
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.models import KVCache, ModelSpec, forward, init_params
from quantizers_tpu_torch.models import transformer as tt
from quantizers_tpu_torch.ops import flash as TF
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.serve import generate

ATOL = 8e-3


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _ulps_apart(t: torch.Tensor, j) -> float:
    a, b = t.float().numpy(), np.asarray(j, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((np.abs(a - b) / ulp).max())


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("B,H,r,dp,S", [(4, 4, 128, 128, 64), (2, 16, 512, 128, 128)])
def test_mla_decode_plain_matches_pallas_interpret(B, H, r, dp, S):
    rng = np.random.default_rng(B * H)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    qa, qp, nc, npe, cc, cp = (rnd(B, H, r), rnd(B, H, dp), rnd(B, r), rnd(B, dp),
                               rnd(B, 1, S, r), rnd(B, 1, S, dp))
    # empty, middle, the last slot and past the end (clamped to S - 1)
    lengths = np.array([0, 17, S - 1, S + 5][:B], np.int32)
    sm = 1 / math.sqrt(192)
    jctx, jc, jp = JK.mla_decode_attention(_bf(qa), _bf(qp), _bf(nc), _bf(npe), _bf(cc),
                                           _bf(cp), jnp.asarray(lengths), sm, interpret=True)
    tcc, tcp = _tb(cc), _tb(cp)
    ctx = TK.mla_decode_attention(_tb(qa), _tb(qp), _tb(nc), _tb(npe), tcc, tcp,
                                  torch.from_numpy(lengths), sm)
    assert ctx.shape == (B, H, r) and ctx.dtype == torch.bfloat16
    assert _ulps_apart(ctx, jctx) <= 1.0
    # the row written in place, and every other row as it was: exact
    np.testing.assert_array_equal(tcc.float().numpy(), np.asarray(jc, np.float32))
    np.testing.assert_array_equal(tcp.float().numpy(), np.asarray(jp, np.float32))
    assert TK.mla_decode_attention.launches == 0  # the CPU never launches


def test_mla_decode_plain_keeps_stale_rows_out():
    B, H, r, dp, S = 2, 2, 128, 128, 16
    g = torch.Generator().manual_seed(0)
    qa, qp = torch.randn((B, H, r), generator=g).bfloat16(), torch.randn((B, H, dp), generator=g)
    nc, npe = torch.randn((B, r), generator=g).bfloat16(), torch.randn((B, dp), generator=g)
    cc = torch.full((B, 1, S, r), float("nan")).bfloat16()
    cp = torch.full((B, 1, S, dp), float("nan")).bfloat16()
    cc[:, :, :4], cp[:, :, :4] = 0.5, 0.25
    lengths = torch.tensor([4, 0], dtype=torch.int32)
    ctx = TK.mla_decode_attention(qa, qp.bfloat16(), nc, npe.bfloat16(), cc, cp, lengths, 0.1)
    assert torch.isfinite(ctx).all()
    assert torch.equal(cc[0, 0, 4], nc[0]) and torch.equal(cc[1, 0, 0], nc[1])
    assert torch.isnan(cc[0, 0, 5:]).all() and torch.isnan(cp[1, 0, 1:4]).sum() == 0
    # a row of length 0 attends only its new row: ctx is that row
    assert torch.equal(ctx[1], nc[1][None].expand(H, r))


REFUSALS = {  # (r, dp, S, cache dtype): does the Pallas kernel take it?
    "path": (128, 128, 64, "bf16"),
    "r96": (96, 128, 64, "bf16"),
    "rope64": (128, 64, 64, "bf16"),
    "S60": (128, 128, 60, "bf16"),
    "fp8_cache": (128, 128, 64, "fp8"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_mla_decode_route_takes_what_the_pallas_kernel_takes(case):
    r, dp, S, cdt = REFUSALS[case]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cdt == "bf16"
                else (jnp.float8_e4m3fn, torch.float8_e4m3fn))
    try:
        JK.mla_decode_attention(jnp.zeros((1, 2, r), jnp.bfloat16), jnp.zeros((1, 2, dp), jnp.bfloat16),
                                jnp.zeros((1, r), jnp.bfloat16), jnp.zeros((1, dp), jnp.bfloat16),
                                jnp.zeros((1, 1, S, r), jdt), jnp.zeros((1, 1, S, dp), jdt),
                                jnp.zeros((1,), jnp.int32), 0.1, interpret=True)
        jax_takes = True
    except JK.KernelUnsupported:
        jax_takes = False
    reason = TK.mla_decode_reason(torch.zeros((1, 2, r), dtype=torch.bfloat16),
                                  torch.zeros((1, 2, dp), dtype=torch.bfloat16),
                                  torch.zeros((1, 1, S, r), dtype=tdt),
                                  torch.zeros((1, 1, S, dp), dtype=tdt))
    assert (reason is None) == jax_takes == (case == "path")


#: the flash-sized MLA layer: qk head 128 + 64 (padded to 256), v head 128
FLASH_MLA = dict(mla=True, hidden_size=128, num_heads=2, num_kv_heads=2, q_lora_rank=0,
                 kv_lora_rank=128, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                 num_layers=1)
TINY_MLA = dict(mla=True, num_layers=1)  # q LoRA 32, r 32, heads 16 / 8 / 16


def _layer(kw, seed=0):
    jspec, spec = JSpec.tiny(**kw), ModelSpec.tiny(**kw)
    jp = jinit(jspec, jax.random.PRNGKey(seed))
    return jspec, spec, jp["layers"][0], params_from_numpy(jp, device="cpu")["layers"][0]


@pytest.mark.parametrize("case", ["no_cache_flash", "no_cache_einsum", "cached_prefill",
                                  "decode"])
def test_mla_attention_matches_jax(case, monkeypatch):
    kw = FLASH_MLA if case in ("no_cache_flash", "decode") else TINY_MLA
    jspec, spec, jlayer, tlayer = _layer(kw)
    B, T = 2, 16
    x = (np.random.default_rng(1).standard_normal((B, T, spec.hidden_size)) * 0.5
         ).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T))
    calls = {"flash": 0, "mla": 0}
    plain_flash, plain_mla = TF.flash_attention_plain, TK.mla_decode_attention_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TF, "flash_attention_plain", count("flash", plain_flash))
    monkeypatch.setattr(TK, "mla_decode_attention_plain", count("mla", plain_mla))
    if case.startswith("no_cache"):
        jo, _ = jt.mla_attention(jlayer, jspec, _bf(x), jnp.asarray(pos), None)
        to, _ = tt.mla_attention(tlayer, spec, _tb(x), torch.from_numpy(pos.copy()), None)
        _close(to, jo)
        assert calls["flash"] == int(case == "no_cache_flash")
        return
    jc, tc = JKVCache.init(jspec, B, 32)[0], KVCache.init(spec, B, 32, device="cpu")[0]
    jo, jc = jt.mla_attention(jlayer, jspec, _bf(x), jnp.asarray(pos), jc)
    to, tc = tt.mla_attention(tlayer, spec, _tb(x), torch.from_numpy(pos.copy()), tc)
    _close(to, jo)
    if case == "decode":
        for t in range(T, T + 3):  # one token at a time: the MLA decode kernel's path
            xt = (np.random.default_rng(t).standard_normal((B, 1, spec.hidden_size)) * 0.5
                  ).astype(np.float32)
            p = np.full((B, 1), t)
            jo, jc = jt.mla_attention(jlayer, jspec, _bf(xt), jnp.asarray(p), jc)
            to, tc = tt.mla_attention(tlayer, spec, _tb(xt), torch.from_numpy(p), tc)
            _close(to, jo)
        assert calls["mla"] == 3
    assert tc.length.tolist() == np.asarray(jc.length).tolist()
    _close(tc.k, jc.k, atol=3e-2)  # the latent rows: post-norm, |c| up to ~4
    assert calls["flash"] == 0


def test_mla_absorb_layout_equal():
    jspec, spec = JSpec.tiny(mla=True), ModelSpec.tiny(mla=True)
    jp = jinit(jspec, jax.random.PRNGKey(3))
    want = jt.mla_absorb_layout(jspec, jp)
    got = tt.mla_absorb_layout(spec, params_from_numpy(jp, device="cpu"))
    for gl, wl in zip(got["layers"], want["layers"]):
        for key in ("w_uk_t", "w_uv"):
            g, w = gl["mla_absorb"][key], wl["mla_absorb"][key]
            assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    again = tt.mla_absorb_layout(spec, got)  # weights already there are kept
    assert again["layers"][0]["mla_absorb"] is got["layers"][0]["mla_absorb"]
    dense = ModelSpec.tiny()
    assert tt.mla_absorb_layout(dense, {"layers": []}) == {"layers": []}


def test_rope_interleaved_equal():
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5))
    jcos, jsin = jt.rotary_cos_sin(jnp.asarray(pos), 8, 10000.0)
    tcos, tsin = tt.rotary_cos_sin(torch.from_numpy(pos.copy()), 8, 10000.0)
    want = jt.apply_rope_interleaved(_bf(x), jcos, jsin)
    got = tt.apply_rope_interleaved(_tb(x), tcos, tsin)
    _close(got, want, atol=0)


def _model(kw, seed=0):
    jspec, spec = JSpec.tiny(**kw), ModelSpec.tiny(**kw)
    jp = jinit(jspec, jax.random.PRNGKey(seed))
    return jspec, spec, jt.fuse_for_decode(jspec, jp), \
        tt.fuse_for_decode(spec, params_from_numpy(jp, device="cpu"))


def _prefill_and_decode(jspec, spec, jp, tp, fp8=False, steps=4, B=2, T=8):
    ids = np.random.default_rng(7).integers(1, spec.vocab_size, (B, T + steps))
    jc = JKVCache.init(jspec, B, 32, fp8=fp8)
    tc = KVCache.init(spec, B, 32, device="cpu", fp8=fp8)
    jl, jc = jforward(jp, jspec, jnp.asarray(ids[:, :T], jnp.int32), caches=jc)
    with torch.no_grad():
        tl, tc = forward(tp, spec, torch.as_tensor(ids[:, :T]), caches=tc)
    _close(tl, jl)
    for t in range(T, T + steps):
        jl, jc = jforward(jp, jspec, jnp.asarray(ids[:, t:t + 1], jnp.int32), caches=jc)
        with torch.no_grad():
            tl, tc = forward(tp, spec, torch.as_tensor(ids[:, t:t + 1]), caches=tc)
        _close(tl, jl)
    return jc, tc


@pytest.mark.parametrize("kind", ["dense", "mla"])
def test_fp8_kv_cache_matches_jax(kind, monkeypatch):
    kw = {} if kind == "dense" else dict(mla=True)
    jspec, spec, jp, tp = _model(dict(kw, head_dim=128) if kind == "dense" else kw)
    caches = KVCache.init(spec, 1, 8, device="cpu", fp8=True, k_scale=0.5)
    assert caches[0].k.dtype == torch.float8_e4m3fn and float(caches[0].k_scale) == 0.5
    assert caches[0].clone().k_scale is caches[0].k_scale
    calls = []
    monkeypatch.setattr(TK, "decode_attention_plain", lambda *a: calls.append(a))
    monkeypatch.setattr(TK, "mla_decode_attention_plain", lambda *a: calls.append(a))
    jc, tc = _prefill_and_decode(jspec, spec, jp, tp, fp8=True)
    assert not calls  # an fp8 cache takes the plain attention path, as in JAX
    assert tc[0].k.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tc[0].k.float().numpy(), np.asarray(jc[0].k, np.float32))
    out = generate(spec, tp, [[1, 2, 3]], max_new_tokens=3, fp8_kv=True, device="cpu")
    assert out.shape == (1, 3)


def test_tiny_mla_moe_model_matches_jax():
    kw = dict(mla=True, moe=True, num_layers=2)
    jspec, spec, jp, tp = _model(kw, seed=1)
    assert "moe" in tp["layers"][1] and "mlp" in tp["layers"][0]  # first layer dense
    assert tp["layers"][1]["moe"]["e_score_correction_bias"].dtype == torch.float32
    _prefill_and_decode(jspec, spec, jp, tp)
    own = init_params(spec, device="cpu")  # the port's own random MLA+MoE model runs
    assert "kv_b_proj" in own["layers"][0] and "shared_experts" in own["layers"][1]["moe"]
    assert generate(spec, own, [[1, 2]], max_new_tokens=2, device="cpu").shape == (1, 2)
