"""Port parity for W8A8 (slice 7b): the dynamic activation quantizers, the
int8 GEMM's plain version (K10's arithmetic) and ``w8a8_token_matmul``,
the routing of W8A8 linears, the W8A8 RTN recipe through ``oneshot`` and
through the ``do_oneshot`` / ``serve`` CLIs, against the JAX package on the
CPU. The kernel itself runs on the card (``tests/test_torch_cuda.py``).

Tolerances:

* the dynamic quantizers' codes and scales, K10's plain version and
  ``w8a8_token_matmul``: equal, bit for bit (the integer sums are exact;
  both packages divide by tensors, round half away from zero and multiply
  the f32 sum by the row's scale, then the column's);
* the W8A8 records and checkpoints: equal, bit for bit (RTN codes depend on
  the weights alone);
* logits of a served W8A8 checkpoint: within 2e-2 of the largest |logit|
  (the rule of ``chip_smoke.logits_agree``: bf16 activations rounded in
  other places).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.cli.do_oneshot import main as jdo_oneshot
from quantizers_tpu.cli.make_tiny_model import main as jmake_tiny
from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu.models import ModelSpec as JSpec
from quantizers_tpu.models import forward as jforward
from quantizers_tpu.models import init_params as jinit
from quantizers_tpu.models.loader import load_compressed_model as jload_compressed
from quantizers_tpu.oneshot import make_batches as jmake_batches
from quantizers_tpu.oneshot import oneshot as joneshot
from quantizers_tpu.ops import dispatch as jd
from quantizers_tpu.ops import linear as jl
from quantizers_tpu.recipes import parse_recipe as jparse
from quantizers_tpu_torch.cli.do_oneshot import main as do_oneshot
from quantizers_tpu_torch.cli.serve import main as serve
from quantizers_tpu_torch.cli.validate_config import main as validate
from quantizers_tpu_torch.convert import params_from_numpy
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core import scheme as ts
from quantizers_tpu_torch.formats.safetensors_io import ShardedReader
from quantizers_tpu_torch.models import ModelSpec, forward
from quantizers_tpu_torch.models.loader import load_compressed_model
from quantizers_tpu_torch.oneshot import oneshot
from quantizers_tpu_torch.ops import dispatch as td
from quantizers_tpu_torch.ops import kernels as K
from quantizers_tpu_torch.ops import linear as tl
from quantizers_tpu_torch.recipes import parse_recipe

ROOT = Path(__file__).resolve().parent.parent
W8A8_RECIPE = ROOT / "configs" / "recipes" / "recipe_w8a8_int8.yaml"
LOGIT_RTOL = 2e-2
QUANTIZERS = ("dynamic_quantize_token_fp8", "dynamic_quantize_group_fp8",
              "dynamic_quantize_token_int8")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(a):
    """A JAX or torch array as f32 numpy (fp8 and bf16 values are exact in f32)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype != torch.int8 else a.numpy()
    return np.asarray(a.astype(jnp.float32)) if a.dtype != jnp.int8 else np.asarray(a)


def _both(x, dtype):
    t = torch.from_numpy(x).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32), t


# ---------------------------------------------------------------------------
# the dynamic activation quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QUANTIZERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale", [((4, 7, 300), 3.0), ((9, 128), 0.01), ((2, 1000), 50.0)])
def test_dynamic_quantizers_match_jax(name, dtype, shape, scale):
    x = _rand(shape, 0, scale)
    x[0, ..., :5] = 0.0  # a zero head, and (shape (9, 128)) whole zero groups
    x.reshape(-1, shape[-1])[1] = 0.0  # an all-zero row: the 1e-12 floor
    jx, tx = _both(x, dtype)
    jq, jsc = getattr(jn, name)(jx)
    tq, tsc = getattr(tn, name)(tx)
    assert tuple(tq.shape) == jq.shape and tuple(tsc.shape) == jsc.shape
    assert tsc.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), _np(jq))
    np.testing.assert_array_equal(_np(tsc), _np(jsc))


@pytest.mark.parametrize("name", QUANTIZERS)
def test_dynamic_quantizers_on_non_finite_rows_match_jax(name):
    """+-inf and NaN inputs: the row's absmax (and scale) is inf or NaN, the
    non-finite element's code NaN (fp8) or what the cast gives (int8), the
    rest of an inf row 0, in both packages alike."""
    x = _rand((4, 256), 1, 2.0)
    x[0, 5], x[1, 7], x[2, 3] = np.inf, -np.inf, np.nan
    jq, jsc = getattr(jn, name)(jnp.asarray(x))
    tq, tsc = getattr(tn, name)(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), _np(jq))
    np.testing.assert_array_equal(_np(tsc), _np(jsc))
    if name != "dynamic_quantize_token_int8":
        assert np.isnan(_np(tq)[0, 5]) and np.isnan(_np(tq)[2, 3])


def test_fp8_saturation_rule():
    """The FP8 quantizers clamp x / scale to +-448 before the cast (NaN stays
    NaN), so that the CPU and the card agree past the range: the fp8 KV
    cache's row (ROADMAP queue 3)."""
    q = torch.tensor([1.0, 300.0, 470.0, 600.0, -2000.0, 5000.0, float("inf"),
                      float("-inf"), float("nan")])
    got = tn._to_fp8_saturated(q).float()
    assert got[:8].tolist() == [1.0, 288.0, 448.0, 448.0, -448.0, 448.0, 448.0, -448.0]
    assert bool(got[8].isnan())


# ---------------------------------------------------------------------------
# K10's plain version and w8a8_token_matmul
# ---------------------------------------------------------------------------

def _w8a8_lin(k=128, n=96, seed=20, scale=0.05):
    """The same W8A8 linear from each package's quantize."""
    w = _rand((n, k), seed, scale)
    jsch, tsch = js.PRESET_SCHEMES["W8A8"], ts.PRESET_SCHEMES["W8A8"]
    jlin = jl.from_quantized(jn.quantize(jnp.asarray(w), jsch.weights), jsch.weights,
                             act_args=jsch.input_activations)
    tlin = tl.from_quantized(tn.quantize(torch.from_numpy(w), tsch.weights), tsch.weights,
                             act_args=tsch.input_activations)
    return jlin, tlin


def test_act_meta_recorded():
    jlin, tlin = _w8a8_lin()
    assert tlin.meta == jlin.meta and tlin.meta_dict.get("act") == "token_i8"
    assert td.is_w8a8(tlin)
    # weight-only W8A16 carries none
    w = _rand((96, 128), 21, 0.05)
    args = ts.PRESET_SCHEMES["W8A16"].weights
    lin16 = tl.from_quantized(tn.quantize(torch.from_numpy(w), args), args)
    assert "act" not in lin16.meta_dict and not td.is_w8a8(lin16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 7, 128), (1, 128), (33, 128)])
def test_w8a8_token_matmul_matches_jax(dtype, shape):
    jlin, tlin = _w8a8_lin()
    jx, tx = _both(_rand(shape, 22, 3.0), dtype)
    got = td.w8a8_token_matmul(tx, tlin)
    want = jd.w8a8_token_matmul(jx, jlin)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    # the float emulation of the JAX test, to f32 rounding
    xq, sx = tn.dynamic_quantize_token_int8(tx.float())
    ref = (xq.float().numpy() @ tlin.weight.float().numpy()) * sx.numpy() \
        * tlin.scale.float().numpy().reshape(-1)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-2 if dtype == torch.bfloat16 else 1e-5,
                               atol=1e-4)


def test_w8a8_sums_round_once_past_2_24():
    """|sum| above 2^24 rounds to f32 once, to nearest even, in both
    packages: every code at +-127 against a weight of +-127 over K 2048."""
    k, n, m = 2048, 128, 4
    rng = np.random.default_rng(5)
    w8 = (rng.integers(0, 2, (k, n)) * 254 - 127).astype(np.int8)
    sc = np.full((1, n), 1e-3, np.float32)
    meta = (("k", k), ("n", n), ("group_size", None), ("act", "token_i8"))
    tlin = tl.QuantLinear(kind="w8", weight=torch.from_numpy(w8),
                          scale=torch.from_numpy(sc).bfloat16(), meta=meta)
    jlin = jl.QuantLinear(kind="w8", weight=jnp.asarray(w8),
                          scale=jnp.asarray(sc).astype(jnp.bfloat16), meta=meta)
    x = np.where(rng.integers(0, 2, (m, k)) > 0, 1.0, -1.0).astype(np.float32) * 3.0
    x[:, :1500] = np.abs(x[:, :1500]) * np.sign(w8[:1500, 0])  # column 0 sums far past 2^24
    got, want = td.w8a8_token_matmul(torch.from_numpy(x), tlin), jd.w8a8_token_matmul(
        jnp.asarray(x), jlin)
    np.testing.assert_array_equal(_np(got), _np(want))
    xq, _ = tn.dynamic_quantize_token_int8(torch.from_numpy(x))
    exact = xq.long() @ torch.from_numpy(w8).long()
    assert exact.abs().max() > 2 ** 24
    plain = K.w8a8_matmul_plain(xq, torch.ones(m), torch.from_numpy(w8), torch.ones(n))
    assert torch.equal(plain, exact.float())  # int64 -> f32 rounds once, to nearest even


def test_dispatch_routes_by_act_meta():
    """apply() takes the int8 path at every row count (the JAX package checks
    W8A8 before its row crossover); use_kernel=False is the A16 oracle."""
    jlin, tlin = _w8a8_lin(seed=23)
    for rows in (8, 600):
        jx, tx = _both(_rand((rows, 128), 24, 2.0), torch.float32)
        routed = tlin.apply(tx)
        assert torch.equal(routed, td.w8a8_token_matmul(tx, tlin))
        np.testing.assert_array_equal(routed.numpy(), np.asarray(jlin.apply(jx)))
        # the A16 oracle sums in f32 in another order than XLA: f32 rounding
        a16 = tlin.apply(tx, use_kernel=False)
        np.testing.assert_allclose(a16.numpy(), np.asarray(jlin.apply(jx, use_kernel=False)),
                                   rtol=1e-5, atol=1e-6)
        assert not torch.equal(routed, a16)
        np.testing.assert_allclose(routed.numpy(), a16.numpy(), rtol=0.15, atol=0.3)


def test_group_scales_fall_back_to_dequant():
    """int32 sums are exact only with per-channel scales: a group-wise w8
    linear with an act meta keeps the dequantize path, as in JAX."""
    w = _rand((96, 128), 25, 0.05)
    ja = js.QuantizationArgs(num_bits=8, type=js.QuantType.INT,
                             strategy=js.QuantStrategy.GROUP, group_size=32)
    ta = ts.QuantizationArgs(num_bits=8, type=ts.QuantType.INT,
                             strategy=ts.QuantStrategy.GROUP, group_size=32)
    jlin = jl.from_quantized(jn.quantize(jnp.asarray(w), ja), ja)
    tlin = tl.from_quantized(tn.quantize(torch.from_numpy(w), ta), ta)
    object.__setattr__(jlin, "meta", jlin.meta + (("act", "token_i8"),))
    tlin = tl.QuantLinear(kind=tlin.kind, weight=tlin.weight, scale=tlin.scale,
                          meta=tlin.meta + (("act", "token_i8"),))
    assert not td.is_w8a8(tlin)
    jx, tx = _both(_rand((4, 128), 26), torch.bfloat16)
    y = tlin.apply(tx)
    assert torch.equal(y, td.reference_quant_matmul(tx, tlin))
    np.testing.assert_array_equal(_np(y), _np(jlin.apply(jx)))
    with pytest.raises(K.KernelUnsupported, match="per-channel"):
        K.w8a8_matmul(*tn.dynamic_quantize_token_int8(tx.float()), tlin)


def test_w8a8_matmul_wrapper_flattens_and_copies():
    """The wrapper takes (..., K) codes with (..., 1) scales, an offset view
    of them, and out_dtype; on the CPU it adds nothing to its count."""
    _, tlin = _w8a8_lin(k=160, n=48, seed=27)
    xq, sx = tn.dynamic_quantize_token_int8(torch.from_numpy(_rand((2, 3, 160), 28, 4.0)))
    before = K.w8a8_matmul.launches
    got = K.w8a8_matmul(xq, sx, tlin, out_dtype=torch.float32)
    assert got.shape == (2, 3, 48) and got.dtype == torch.float32
    plain = K.w8a8_matmul_plain(xq.reshape(6, 160), sx.reshape(6), tlin.weight, tlin.scale)
    assert torch.equal(got.reshape(6, 48), plain)
    buf = torch.empty(xq.numel() + 3, dtype=torch.int8)
    view = buf[3:].view(xq.shape)
    view.copy_(xq)
    assert torch.equal(K.w8a8_matmul(view, sx, tlin), plain.bfloat16().reshape(2, 3, 48))
    assert K.w8a8_matmul.launches == before


#: K10's plans: decode at Qwen3-4B's served shapes (m 8: q|k|v, o, gate|up,
#: down), one row, the batcher's 17-64 rows; prefill where a block's share
#: of x outgrows the decode body (64 rows at K 9728 and past), at the row
#: prefill, the calibration propagate and prefill; a short K; f32 x; int8
#: codes; a smaller card
@pytest.mark.parametrize("m,k,n,sms,want", [
    (8, 2560, 6144, 132, (True, 16, 4)),      # q|k|v: 48 column tiles
    (8, 4096, 2560, 132, (True, 16, 8)),      # o_proj: 20 tiles, 64 K steps
    (8, 2560, 19456, 132, (True, 16, 1)),     # gate|up: 152 tiles fill the SMs
    (8, 9728, 2560, 132, (True, 16, 8)),      # down_proj: 152 K steps
    (1, 2560, 4096, 132, (True, 16, 8)),      # one row, q_proj: 32 tiles
    (17, 2560, 1024, 132, (True, 32, 8)),     # 8 tiles
    (64, 9728, 2560, 132, (False, 128, 8)),    # 64 rows x 1216 of K: 152 KB of x a block
    (40, 4096, 2560, 132, (True, 64, 8)),
    (16, 50000, 2560, 132, (False, 128, 8)),   # a long K
    (65, 2560, 1024, 132, (False, 128, 4)),   # past the decode body's rows: 8 wgmma tiles
    (128, 2560, 6144, 132, (False, 128, 4)),  # the row prefill: 48 wgmma tiles
    (512, 2560, 1024, 132, (False, 128, 4)),  # k_proj in the calibration propagate
    (129, 520, 264, 132, (False, 64, 2)),     # N % 16 != 0: the mma.sync body, 9 tiles
    (1024, 2560, 9728, 132, (False, 128, 1)), # gate at prefill: 608 wgmma tiles
    (3, 100, 300, 132, (True, 16, 1)),        # 2 K steps: one block a tile
    (8, 2560, 6144, 66, (True, 16, 2)),       # a card of half the SMs
])
def test_w8a8_splits(m, k, n, sms, want):
    plan = K.w8a8_plan(m, k, n, sms)
    assert tuple(plan) == want
    steps = -(-k // K.W8A8_BK)
    assert 1 <= plan.split <= min(steps, K.W8A8_MAX_SPLIT)
    if plan.decode:  # a block's share of x (bf16) fits the decode body
        assert m <= K.W8A8_DECODE_ROWS and K._x_share(m, steps, plan.split, 2) <= K.W8A8_X_SHARE


@pytest.mark.parametrize("m,k,elem,split", [
    (16, 9728, 2, 1),   # 16 rows: 304 KB of bf16 x at split 1; 152 at 2, 76 at 4
    (16, 9728, 4, 2),   # f32 x: twice the bytes
    (64, 4096, 1, 1),   # int8 codes: a quarter of f32's
    (64, 4096, 4, 8),   # 64 rows of f32 at K 4096: 128 KB a block even at 8
])
def test_w8a8_plan_x_share(m, k, elem, split):
    """The decode body's share of x: 128-byte boxes of 64 columns a K step,
    the least split that holds it; past split 8 the prefill body."""
    steps = -(-k // K.W8A8_BK)
    fits = [s for s in range(1, 9) if K._x_share(m, steps, s, elem) <= K.W8A8_X_SHARE]
    plan = K.w8a8_plan(m, k, 1024, 132, elem)
    assert plan.decode == bool(fits)
    if fits:
        assert min(fits) <= plan.split and plan.split >= split
    assert K._x_share(3, 4, 1, 2) == 4 * 384  # 3 rows x 128 bytes a box, 128-aligned


# ---------------------------------------------------------------------------
# K10 with its quantizer: kernels.w8a8_token_matmul and its plain version
# ---------------------------------------------------------------------------

#: 0.5 - 2^-25, whose f32 |q| + 0.5 rounds up to 1.0 (roundf would give 0)
TIE = np.float32(0.5) - np.float32(2.0 ** -25)


def _edge_rows(k, seed):
    """Rows that reach the quantizer's traps, K wide: random, all zero (the
    1e-12 floor), the tie (absmax 127.5 makes the scale 1.0, so q = x),
    +-inf, NaN, and a row whose codes all sit at +-127.5 (the clamp)."""
    x = _rand((8, k), seed, 3.0)
    x[1] = 0.0
    x[2, :] = TIE
    x[2, 0], x[2, 1], x[2, 2] = 127.5, -TIE, 2.5
    x[3, 5] = np.inf
    x[4, 7] = -np.inf
    x[5, 3] = np.nan
    x[6] = np.where(np.arange(k) % 2, 127.5, -127.5)
    return x


def _same(got, want):
    """Equal bit for bit but that NaN equals NaN."""
    g, w = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.nan_to_num(g), np.nan_to_num(w))


def _jax_x(x, dtype):
    t = torch.from_numpy(x).to(dtype)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
    return jnp.asarray(t.float().numpy()).astype(jdt[dtype]), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 200), (8, 200), (33, 200), (4, 7, 200), (8, 128)])
def test_kernel_w8a8_token_matmul_matches_jax(dtype, shape):
    """kernels.w8a8_token_matmul on the CPU (its plain version) against the
    JAX package's w8a8_token_matmul, bit for bit; K 200 is not a multiple
    of 64 (the kernel's K step)."""
    k = shape[-1]
    jlin, tlin = _w8a8_lin(k=k, n=96, seed=30)
    x = _rand(shape, 31, 3.0)
    x.reshape(-1, k)[0, :4] = [TIE, -TIE, 127.5 / 2, 0.0]
    jx, tx = _jax_x(x, dtype)
    before = K.w8a8_token_matmul.launches
    got = K.w8a8_token_matmul(tx, tlin)
    assert K.w8a8_token_matmul.launches == before  # the CPU launches nothing
    want = jd.w8a8_token_matmul(jx, jlin)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    _same(got, want)
    plain = K.w8a8_token_matmul_plain(tx.reshape(-1, k), tlin).to(dtype)
    assert torch.equal(plain.reshape(got.shape), got)
    assert torch.equal(td.w8a8_token_matmul(tx, tlin), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k", [200, 256])
def test_kernel_w8a8_token_matmul_edge_rows_match_jax(dtype, k):
    """The zero, tie, clamp, +-inf and NaN rows: the same codes, scales and
    outputs as the JAX package's (an inf or NaN row all NaN)."""
    jlin, tlin = _w8a8_lin(k=k, n=64, seed=32)
    x = _edge_rows(k, 33)
    jx, tx = _jax_x(x, dtype)
    jq, jsc = jn.dynamic_quantize_token_int8(jx.astype(jnp.float32))
    tq, tsc = tn.dynamic_quantize_token_int8(tx.float())
    np.testing.assert_array_equal(_np(tq), _np(jq))
    _same(tsc, jsc)
    if dtype == torch.float32:
        assert int(tq[2, 3]) == 1 and int(tq[2, 1]) == -1  # the tie rounds away from 0
        assert int(tq[2, 0]) == 127 and int(tq[6, 0]) == -128 and int(tq[6, 1]) == 127
    got = K.w8a8_token_matmul(tx, tlin)
    _same(got, jd.w8a8_token_matmul(jx, jlin))
    g = got.float()
    assert bool(g[3:6].isnan().all()) and not bool(g[[0, 1, 2, 6, 7]].isnan().any())
    assert bool((g[1] == 0).all())
# ---------------------------------------------------------------------------
# the W8A8 recipe through the engine and the CLIs
# ---------------------------------------------------------------------------

def test_oneshot_w8a8_records_act_meta():
    """RTN with the W8A8 recipe gives serving linears with the act meta, and
    the JAX package's records bit for bit; the propagate forwards run
    through w8a8_token_matmul."""
    jspec = JSpec.tiny()
    jparams = jinit(jspec, jax.random.PRNGKey(0))
    batches = jmake_batches([[1, 2, 3, 4, 5, 6, 7, 8]], max_seq_length=8, batch_size=1)
    jres = joneshot(jspec, jax.tree_util.tree_map(lambda a: a, jparams), jparse(W8A8_RECIPE),
                    batches)
    res = oneshot(ModelSpec.tiny(), params_from_numpy(jparams, device="cpu"),
                  parse_recipe(str(W8A8_RECIPE)), batches, device="cpu")
    for lin in (res.params["layers"][0]["q_proj"], res.params["layers"][0]["mlp"]["down_proj"]):
        assert lin.kind == "w8" and lin.meta_dict.get("act") == "token_i8"
    assert sorted(res.records) == sorted(jres.records) and len(res.records) == 14
    for key, cp in jres.records.items():
        np.testing.assert_array_equal(res.records[key].qt.values.numpy(),
                                      np.asarray(cp.qt.values), err_msg=key)
        np.testing.assert_array_equal(res.records[key].qt.scale.float().numpy(),
                                      np.asarray(cp.qt.scale, np.float32), err_msg=key)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_w8a8")
    assert jmake_tiny([str(d), "--vocab", "300", "--platform", ""]) == 0
    return d


def test_oneshot_serve_w8a8_cli(tiny_dir, tmp_path, capsys):
    """The JAX ``test_cli.py::test_oneshot_serve_w8a8`` round trip through
    the port's CLIs: do_oneshot writes the JAX CLI's checkpoint bit for bit,
    validate_config accepts it, it loads with the act meta, serve answers,
    and its logits agree with the JAX package's on the same checkpoint."""
    run_cfg = tmp_path / "run.yaml"
    run_cfg.write_text(f"model:\n  name: {tiny_dir}\nquantization:\n  recipe: {W8A8_RECIPE}\n"
                       f"calibration_set: {ROOT}/configs/calibration_sets/test-calibrate_quick.yaml\n")
    common = ["--config", str(run_cfg), "--cache-dir", str(tmp_path / "cache"),
              "--max-seq-length", "64"]
    assert jdo_oneshot(common + ["--output", str(tmp_path / "j")]) == 0
    out = tmp_path / "t"
    assert do_oneshot(common + ["--output", str(out), "--device", "cpu"]) == 0
    qcfg = json.loads((out / "config.json").read_text())["quantization_config"]
    (group,) = qcfg["config_groups"].values()
    assert group["input_activations"]["dynamic"] is True
    assert group["input_activations"]["num_bits"] == 8
    assert validate([str(out)]) == 0
    rt, rj = ShardedReader(out), ShardedReader(tmp_path / "j")
    assert sorted(rt.keys()) == sorted(rj.keys())
    for name in rj.keys():
        assert torch.equal(rt.get(name).view(torch.uint8), rj.get(name).view(torch.uint8)), name

    spec, params = load_compressed_model(out, device="cpu")
    lin = params["layers"][0]["q_proj"]
    assert lin.kind == "w8" and lin.meta_dict.get("act") == "token_i8"
    ids = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    got = forward(params, spec, torch.as_tensor(ids).long())[0].float().numpy()
    jspec, jparams = jload_compressed(tmp_path / "j")
    with jax.disable_jit():  # op by op: jitted XLA keeps bf16 intermediates in f32
        want = np.asarray(jforward(jparams, jspec, jnp.asarray(ids))[0], np.float32)
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()

    capsys.readouterr()
    assert serve([str(out), "--prompt", "hello", "--prompt", "the cat", "--max-new-tokens", "4",
                  "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln[:2] in ("0\t", "1\t")]
    assert len(lines) == 2
