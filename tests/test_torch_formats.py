"""Port parity for the checkpoint formats: the compressed-tensors packing
and per-format serialization give the JAX package's bytes exactly, the
``quantization_config`` schema round-trips, and safetensors files (single
and sharded with the index) written by either package read identically in
the other. Every comparison is bit for bit: these are integer layouts and
dtype casts, with no arithmetic of their own.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantizers_tpu import formats as jf
from quantizers_tpu.core import numerics as jn
from quantizers_tpu.core import scheme as js
from quantizers_tpu_torch import formats as tf
from quantizers_tpu_torch.convert import to_tensor
from quantizers_tpu_torch.core import scheme as ts
from quantizers_tpu_torch.core.numerics import QuantizedTensor


def _bits(x) -> np.ndarray:
    """Raw bytes of a numpy array (ml_dtypes included) or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _same(t: torch.Tensor, a) -> None:
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    assert t.element_size() == a.dtype.itemsize
    np.testing.assert_array_equal(_bits(t), _bits(a))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_int32_packing_matches(bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    vals = np.random.default_rng(bits).integers(lo, hi + 1, (6, 45)).astype(np.int8)
    want = jf.pack_int_to_int32(vals, bits)
    got = tf.pack_int_to_int32(torch.from_numpy(vals), bits)
    _same(got, want)
    np.testing.assert_array_equal(tf.unpack_int32_to_int(got, bits, 45).numpy(), vals)
    _same(tf.unpack_int32_to_int(got, bits, 45), jf.unpack_int32_to_int(want, bits, 45))


def test_fp4_packing_matches():
    grid = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
    rng = np.random.default_rng(0)
    vals = grid[rng.integers(0, 8, (5, 33))] * rng.choice([-1.0, 1.0], (5, 33)).astype(np.float32)
    t = torch.from_numpy(vals)
    _same(tf.fp4_encode(t), jf.fp4_encode(vals))
    packed = tf.pack_fp4_to_uint8(t)
    _same(packed, jf.pack_fp4_to_uint8(vals))
    _same(tf.unpack_uint8_to_fp4(packed, 33), jf.unpack_uint8_to_fp4(np.asarray(packed), 33))
    _same(tf.fp4_decode(torch.arange(16, dtype=torch.uint8)),
          jf.fp4_decode(np.arange(16, dtype=np.uint8)))


def _to_port(qt) -> QuantizedTensor:
    def conv(a):
        return None if a is None else to_tensor(np.asarray(a), "cpu")
    return QuantizedTensor(conv(qt.values), conv(qt.scale), conv(qt.zero_point),
                           conv(qt.global_scale), tuple(qt.shape))


# (args, scale dtype): w4 pack-quantized (symmetric, and asymmetric with
# packed zero points), int8 int-quantized per channel, NVFP4
FORMAT_CASES = {
    "w4_g32": dict(num_bits=4, type="int", symmetric=True, strategy="group", group_size=32),
    "w4_asym": dict(num_bits=4, type="int", symmetric=False, strategy="group", group_size=32),
    "int8_channel": dict(num_bits=8, type="int", symmetric=True, strategy="channel"),
    "nvfp4": dict(num_bits=4, type="float", symmetric=True, strategy="tensor_group",
                  group_size=16),
}


@pytest.mark.parametrize("case", sorted(FORMAT_CASES))
def test_compress_and_decompress_match(case):
    jargs = js.QuantizationArgs.from_dict(FORMAT_CASES[case])
    targs = ts.QuantizationArgs.from_dict(FORMAT_CASES[case])
    w = (np.random.default_rng(1).standard_normal((48, 96)) * 0.05).astype(np.float32)
    jqt = jn.quantize(jnp.asarray(w), jargs)
    want = jf.compress_tensor("m", jqt, jargs)
    got = tf.compress_tensor("m", _to_port(jqt), targs)
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key])

    jback = jf.decompress_tensor("m", want, jargs)
    back = tf.decompress_tensor("m", got, targs)
    assert back.shape == tuple(jback.shape)
    for field in ("values", "scale", "zero_point"):
        a, b = getattr(jback, field), getattr(back, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if jback.global_scale is not None:
        assert float(back.global_scale) == float(jback.global_scale)


def test_quantization_config_round_trips():
    groups = {"group_0": ts.PRESET_SCHEMES["W4A16_G32"], "group_1": ts.PRESET_SCHEMES["NVFP4"]}
    groups = {k: ts.QuantScheme.from_dict(dict(v.to_dict(), targets=[f"re:.*{k}$"]))
              for k, v in groups.items()}
    cfg = tf.build_quantization_config(groups, ["lm_head"], kv_cache_scheme=None)
    assert cfg["format"] == "mixed-precision" and cfg["quant_method"] == "compressed-tensors"
    jcfg = jf.build_quantization_config(
        {k: js.QuantScheme.from_dict(v.to_dict()) for k, v in groups.items()}, ["lm_head"])
    assert json.dumps(cfg, sort_keys=True) == json.dumps(jcfg, sort_keys=True)
    back, ignore, kv = tf.parse_quantization_config(json.loads(json.dumps(cfg)))
    assert ignore == ["lm_head"] and kv is None
    assert {k: v.to_dict() for k, v in back.items()} == {k: v.to_dict() for k, v in groups.items()}


def _pair(seed: int):
    """The same tensors in both packages' types: bf16, F8_E4M3, I32, F32,
    U8, a 0-d f32 and an I64 shape vector."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((4, 7)).astype(np.float32)
    arrays = {
        "a.bf16": f32.astype(ml_dtypes.bfloat16),
        "b.fp8": np.clip(f32 * 50, -448, 448).astype(ml_dtypes.float8_e4m3fn),
        "c.i32": rng.integers(-2**31, 2**31 - 1, (3, 5), dtype=np.int64).astype(np.int32),
        "d.f32": f32,
        "e.u8": rng.integers(0, 256, (9,), dtype=np.uint8),
        "f.scalar": np.asarray(1.5, np.float32),
        "g.shape": np.asarray([4, 7], np.int64),
    }
    tensors = {k: to_tensor(v, "cpu") if v.dtype.name != "float8_e4m3fn"
               else torch.from_numpy(v.view(np.uint8).copy()).view(torch.float8_e4m3fn)
               for k, v in arrays.items()}
    return arrays, tensors


def _check_same(tensors, arrays):
    assert sorted(tensors) == sorted(arrays)
    for k in arrays:
        _same(tensors[k], arrays[k])


def test_safetensors_files_cross_read(tmp_path):
    arrays, tensors = _pair(0)
    jf.write_safetensors(tmp_path / "jax.safetensors", arrays, metadata={"format": "pt"})
    tf.write_safetensors(tmp_path / "port.safetensors", tensors, metadata={"format": "pt"})
    # each package reads either file as the other does; the JAX writer
    # stores a 0-d array with shape [1] (np.ascontiguousarray), the port
    # with shape [], as the format allows
    for path in ("jax.safetensors", "port.safetensors"):
        mine, theirs = tf.read_safetensors(tmp_path / path), jf.read_safetensors(tmp_path / path)
        assert sorted(mine) == sorted(arrays)
        for k in arrays:
            _same(mine[k], theirs[k])
            np.testing.assert_array_equal(_bits(mine[k]), _bits(arrays[k]))
    assert tuple(tf.read_safetensors(tmp_path / "port.safetensors")["f.scalar"].shape) == ()
    # without the 0-d tensor the two files are the same bytes
    del arrays["f.scalar"], tensors["f.scalar"]
    jf.write_safetensors(tmp_path / "jax.safetensors", arrays, metadata={"format": "pt"})
    tf.write_safetensors(tmp_path / "port.safetensors", tensors, metadata={"format": "pt"})
    assert (tmp_path / "jax.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()
    with tf.LazySafetensors(tmp_path / "jax.safetensors") as f:
        assert f.metadata == {"format": "pt"} and f.info("a.bf16") == ("BF16", (4, 7))


def test_sharded_checkpoints_cross_read(tmp_path):
    arrays, tensors = _pair(1)
    del arrays["f.scalar"], tensors["f.scalar"]  # see test_safetensors_files_cross_read
    jw = jf.ShardedWriter(tmp_path / "jax", max_shard_bytes=64)
    jw.add_many(arrays)
    jfiles = jw.finalize(metadata={"format": "pt"})
    tw = tf.ShardedWriter(tmp_path / "port", max_shard_bytes=64)
    tw.add_many(tensors)
    tfiles = tw.finalize(metadata={"format": "pt"})
    assert tfiles == jfiles and len(tfiles) > 1
    for name in [*tfiles, tf.INDEX_NAME]:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    with tf.ShardedReader(tmp_path / "jax", max_open_shards=1) as r:
        _check_same({k: r.get(k) for k in r.keys()}, arrays)
        assert [f for f, _ in r.iter_shards()] == sorted(tfiles, key=tf.natural_sort_key)
    with jf.ShardedReader(tmp_path / "port") as r:
        for k in arrays:
            np.testing.assert_array_equal(_bits(r.get(k)), _bits(arrays[k]))
