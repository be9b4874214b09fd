"""Port parity for NVFP4: the numerics, the ``nvfp4`` QuantLinear in both
layouts, and the NVFP4 matmul kernels' plain version against the JAX
package's Pallas kernels in interpret mode.

Everything up to the matmul is exact: the same f32 operations in the same
order (E4M3 snapping through ``torch.float8_e4m3fn``, which rounds to
nearest even as ml_dtypes does). The matmul rounds each weight to bf16 once
on both sides and sums in f32 in another order, so outputs agree within a
bf16 ulp of each value: held to 1e-2 relative plus 4e-3 absolute (measured:
equal at m = 8; at m = 128 at most one bf16 ulp, 0.0156 at |y| near 3,
where |y| reaches 20).
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core.scheme import PRESET_SCHEMES as JPRESETS
from quantizers_tpu.ops import kernels as JK
from quantizers_tpu.ops import linear as jl
from quantizers_tpu_torch.convert import params_from_numpy, to_tensor
from quantizers_tpu_torch.core import numerics as tn
from quantizers_tpu_torch.core.scheme import PRESET_SCHEMES as TPRESETS
from quantizers_tpu_torch.ops import dispatch as td
from quantizers_tpu_torch.ops import kernels as TK
from quantizers_tpu_torch.ops import linear as tl

JARGS, TARGS = JPRESETS["NVFP4"].weights, TPRESETS["NVFP4"].weights


def _w(shape, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    # heavy tails, so that groups differ widely in scale
    return (rng.standard_t(3, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 256), (48, 100), (8, 16)])
def test_quantize_codes_scales_global_equal(shape):
    w = _w(shape, shape[1])
    jq = jn.quantize(jnp.asarray(w), JARGS)
    tq = tn.quantize(torch.from_numpy(w), TARGS)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.global_scale.numpy(), np.asarray(jq.global_scale))
    assert tq.shape == jq.shape and tq.zero_point is None
    np.testing.assert_array_equal(tn.dequantize(tq, TARGS).numpy(),
                                  np.asarray(jn.dequantize(jq, JARGS)))


def test_fp8_snap_midpoints_subnormals_and_clip():
    # E4M3 neighbours and the midpoints between them (ties go to even), the
    # subnormal range, the 448 maximum and values beyond it
    vals = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    vals = np.sort(vals[np.isfinite(vals)])
    mids = (vals[:-1] + vals[1:]) / 2
    x = np.concatenate([vals, mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf),
                        [448.0, 449.0, 464.0, 480.0, 1e6, -1e6, 2.0 ** -10, 2.0 ** -11]]
                       ).astype(np.float32)
    got = tn.quantize_to_fp8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jn.quantize_to_fp8(jnp.asarray(x))))
    assert got.max() == 448.0 and got.min() == -448.0


def test_fp4_snap_at_the_midpoints():
    mids = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0], np.float32)
    x = np.concatenate([mids, -mids, np.nextafter(mids, np.inf), [0.0, 7.0, -100.0]]
                       ).astype(np.float32)
    got = tn.quantize_to_fp4(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jn.quantize_to_fp4(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:7], [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0])


def _lins(n, k, seed, device_path=True):
    """The JAX NVFP4 linear (from a device or a host QuantizedTensor) and the
    port's own, built from the same weights."""
    w = _w((n, k), seed)
    jq = jn.quantize(jnp.asarray(w), JARGS)
    if not device_path:
        jq = jq._replace(values=np.asarray(jq.values), scale=np.asarray(jq.scale))
    jlin = jl.from_quantized(jq, JARGS)
    tlin = tl.from_quantized(tn.quantize(torch.from_numpy(w), TARGS), TARGS)
    return jlin, tlin


@pytest.mark.parametrize("n,k,device_path", [(256, 256, True), (128, 96, True),
                                             (128, 256, False)])
def test_from_quantized_packed_bytes_and_scales_exact(n, k, device_path):
    jlin, tlin = _lins(n, k, 7, device_path)
    assert tlin.kind == "nvfp4" and tlin.weight.dtype == torch.uint8
    assert tlin.meta == tuple((a, int(b)) for a, b in jlin.meta)
    np.testing.assert_array_equal(tlin.weight.numpy(), np.asarray(jlin.weight))
    assert tlin.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(tlin.scale.float().numpy(),
                                  np.asarray(jlin.scale.astype(jnp.float32)))


def _to_i8_jax(jlin):
    return dataclasses.replace(jlin, weight=jl.nvfp4_packed_to_i8(jlin.weight),
                               scale=(jlin.scale.astype(jnp.float32) * 0.5).astype(jlin.scale.dtype))


def test_dequantize_both_layouts_exact():
    jlin, tlin = _lins(256, 256, 3)
    tlin = params_from_numpy(jlin, device="cpu")
    want = np.asarray(jlin.dequantize(jnp.float32))
    np.testing.assert_array_equal(tlin.dequantize(torch.float32).numpy(), want)
    ti8 = tl.nvfp4_device_layout({"l": tlin}, nvfp4_int8=True)["l"]
    assert ti8.weight.dtype == torch.int8 and ti8.weight.shape == (256, 256)
    np.testing.assert_array_equal(ti8.dequantize(torch.float32).numpy(),
                                  np.asarray(_to_i8_jax(jlin).dequantize(jnp.float32)))
    # halving the bf16 scale and doubling the values changes nothing
    np.testing.assert_array_equal(ti8.dequantize(torch.float32).numpy(), want)
    np.testing.assert_array_equal(ti8.dequantize(torch.bfloat16).float().numpy(),
                                  np.asarray(jlin.dequantize(jnp.bfloat16).astype(jnp.float32)))


def test_packed_to_i8_exact_on_every_code():
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, (3, 64, 128), dtype=np.uint8)
    packed[0, 0, :16] = np.arange(16) * 17  # every code in both nibbles
    got = tl.nvfp4_packed_to_i8(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.nvfp4_packed_to_i8(jnp.asarray(packed))))
    assert got.dtype == np.int8 and got.shape == (3, 128, 128)


@pytest.mark.parametrize("layout", ["packed", "int8"])
@pytest.mark.parametrize("m", [8, 128])
def test_nvfp4_linear_matches_pallas_interpret(layout, m):
    jlin, _ = _lins(256, 256, m)
    if layout == "int8":
        jlin = _to_i8_jax(jlin)
    tlin = params_from_numpy(jlin, device="cpu")
    xj = jnp.asarray(np.random.default_rng(m).standard_normal((m, 256)) * 0.5, jnp.bfloat16)
    want = np.asarray(JK.nvfp4_matmul(xj, jlin, interpret=True), np.float32)
    TK.reset_launch_counts()
    got = td.quant_matmul(to_tensor(np.asarray(xj), "cpu"), tlin)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=4e-3)
    # the reference path (dequantize to bf16, f32 sums) agrees as closely
    ref = td.reference_quant_matmul(to_tensor(np.asarray(xj), "cpu"), tlin)
    np.testing.assert_allclose(ref.float().numpy(), want, rtol=1e-2, atol=4e-3)
    # CPU tensors take the plain version: no launch
    assert all(v == 0 for v in TK.launch_counts().values())
    assert TK.supports(tlin)


@pytest.mark.parametrize("n,k,layout", [
    (192, 256, "packed"),  # 128 does not divide N
    (128, 48, "packed"),   # 2g does not divide K
    (128, 128, "packed"),  # 8g does not divide K/2 (the packed tile quantum)
    (128, 96, "int8"),     # 8g does not divide K
])
def test_rejects_what_the_pallas_kernel_rejects(n, k, layout):
    jlin, _ = _lins(n, k, 1)
    if layout == "int8":
        jlin = _to_i8_jax(jlin)
    tlin = params_from_numpy(jlin, device="cpu")
    xj = jnp.zeros((2, k), jnp.bfloat16)
    with pytest.raises(JK.KernelUnsupported):
        JK.nvfp4_matmul(xj, jlin, interpret=True)
    with pytest.raises(TK.KernelUnsupported):
        TK.nvfp4_matmul(torch.zeros((2, k), dtype=torch.bfloat16), tlin)
    assert not TK.supports(tlin)
    # the dispatcher takes the reference path instead
    got = td.quant_matmul(torch.ones((2, k), dtype=torch.bfloat16), tlin)
    torch.testing.assert_close(got, td.reference_quant_matmul(
        torch.ones((2, k), dtype=torch.bfloat16), tlin), rtol=0, atol=0)


def test_int8_layout_goes_to_its_own_wrapper_and_device_check():
    jlin, _ = _lins(256, 256, 2)
    tlin = params_from_numpy(_to_i8_jax(jlin), device="cpu")
    with pytest.raises(TK.KernelUnsupported):
        TK.nvfp4_i8_matmul(torch.zeros((2, 256)), params_from_numpy(jlin, device="cpu"))
    meta = torch.zeros((2, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TK.nvfp4_matmul(meta, tlin)
