"""aimet_tpu_torch.ops.kv_cache against aimet_tpu.ops.kv_cache on the same
numpy inputs. Tolerance: cache bytes and scales bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops import kv_cache as jkv
from aimet_tpu_torch.ops import kv_cache as tkv

B, S, KH, D = 3, 16, 2, 8


def _caches():
    return (jkv.init_quantized_kv_cache(B, S, KH, D),
            tkv.init_quantized_kv_cache(B, S, KH, D, device="cpu"))


def _assert_same(jc, tc):
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)


def _kv(rs, t):
    return [(rs.randn(B, t, KH, D) * 2).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("lengths", [None, [5, 2, 6]])
def test_prefill_bit_exact(lengths):
    rs = np.random.RandomState(0)
    k, v = _kv(rs, 6)
    jc, tc = _caches()
    jc = jkv.prefill_kv(jc, jnp.asarray(k), jnp.asarray(v),
                        lengths=None if lengths is None
                        else jnp.asarray(lengths))
    out = tkv.prefill_kv(tc, torch.from_numpy(k), torch.from_numpy(v),
                         lengths=lengths)
    assert out is tc                        # in place
    _assert_same(jc, tc)
    jd, _ = jkv.dequantize_kv(jc)
    td, _ = tkv.dequantize_kv(tc)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("index", [4, [4, 7, 15], [0, 16, 3]])
def test_append_bit_exact(index):
    """Scalar and per-slot positions; 16 is past the cache and dropped."""
    rs = np.random.RandomState(1)
    k0, v0 = _kv(rs, 4)
    k1, v1 = _kv(rs, 1)
    jc, tc = _caches()
    jc = jkv.prefill_kv(jc, jnp.asarray(k0), jnp.asarray(v0))
    tkv.prefill_kv(tc, torch.from_numpy(k0), torch.from_numpy(v0))
    jidx = jnp.asarray(index, jnp.int32)
    tidx = torch.as_tensor(index)
    jc = jkv.append_kv(jc, jnp.asarray(k1), jnp.asarray(v1), jidx)
    tkv.append_kv(tc, torch.from_numpy(k1), torch.from_numpy(v1), tidx)
    _assert_same(jc, tc)


def test_append_at_rounding_ties_bit_exact():
    """Values whose x * (1 / scale) is exactly k + 0.5 in f32, or an ulp
    either side: the codes must be the formula's (IEEE reciprocal, product
    rounded once, round half to even), as in the JAX package. Random data
    almost never comes this close to a boundary, so a reciprocal an ulp
    off or another rounding rule would pass the other tests."""
    rs = np.random.RandomState(5)
    scale = (rs.rand(B, KH).astype(np.float32) + np.float32(0.5)) / 64
    r = (np.float32(1) / scale)[:, None, :, None]
    k = (np.arange(-60, 60, 120 / D, dtype=np.float32)[None, None, None, :]
         + np.float32(0.5)).repeat(B, 0).repeat(KH, 2) / r
    for _ in range(4):                      # walk x onto the exact tie
        t = k * r
        k = np.where(t == np.floor(t) + np.float32(0.5), k,
                     np.nextafter(k, np.where(t < np.floor(t) + 0.5,
                                              np.inf, -np.inf)
                                  .astype(np.float32)))
    t = k * r
    assert (t == np.floor(t) + np.float32(0.5)).mean() > 0.5
    k = np.concatenate([k, np.nextafter(k, np.float32(np.inf)),
                        np.nextafter(k, np.float32(-np.inf))], axis=1)
    want = np.clip(np.rint(k * r), -127, 127)
    jc, tc = _caches()
    jc = jkv.QuantizedKVCache(jc.k, jc.v, jnp.asarray(scale),
                              jnp.asarray(scale))
    tc = tkv.QuantizedKVCache(tc.k, tc.v, torch.from_numpy(scale),
                              torch.from_numpy(scale.copy()))
    jc = jkv.append_kv(jc, jnp.asarray(k), jnp.asarray(k), 2)
    tkv.append_kv(tc, torch.from_numpy(k), torch.from_numpy(k), 2)
    np.testing.assert_array_equal(tc.k.numpy()[:, 2:5], want)
    _assert_same(jc, tc)


def test_init_puts_the_cache_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkv.init_quantized_kv_cache(B, S, KH, D)
    c = tkv.init_quantized_kv_cache(B, S, KH, D, device="cpu")
    assert {getattr(c, n).device.type
            for n in ("k", "v", "k_scale", "v_scale")} == {"cpu"}


def test_flatten_views_share_storage_and_equal_jax():
    """(B, S, KH*D) views of the same bytes: a write through either shape
    is seen by the other; the bytes equal the JAX package's reshape."""
    rs = np.random.RandomState(2)
    k0, v0 = _kv(rs, 5)
    jc, tc = _caches()
    jc = jkv.prefill_kv(jc, jnp.asarray(k0), jnp.asarray(v0))
    tkv.prefill_kv(tc, torch.from_numpy(k0), torch.from_numpy(v0))
    (jf,), (tf,) = jkv.flatten_kv_caches([jc]), tkv.flatten_kv_caches([tc])
    assert tf.k.shape == (B, S, KH * D) and tf.k_scale is tc.k_scale
    assert tf.k.data_ptr() == tc.k.data_ptr()
    _assert_same(jf, tf)
    tf.k[1, 3, D + 2] = 99
    assert tc.k[1, 3, 1, 2] == 99
    tc.v[2, 7, 1, 0] = -42
    assert tf.v[2, 7, D] == -42


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("index", [4, 15, 14, -2, -20, "tensor 13",
                                   "tensor -1", [4, 7, 11],
                                   [13, 15, 2], [14, 16, 20]])
@pytest.mark.parametrize("flat", [False, True])
def test_append_of_several_rows_bit_exact(T, index, flat):
    """T > 1 rows a slot: a scalar start placed as
    ``dynamic_update_slice`` places it (negative from the end, then clamped
    so the rows fit: 15, 14, -2, -20 at S = 16), also as a 0-dim tensor;
    per-slot starts whose rows
    cross the end of the cache (those rows are dropped, a slot with none
    inside keeps its bytes). Flat caches give the same bytes."""
    rs = np.random.RandomState(3)
    k0, v0 = _kv(rs, 4)
    k1, v1 = _kv(rs, T)
    jc, tc = _caches()
    jc = jkv.prefill_kv(jc, jnp.asarray(k0), jnp.asarray(v0))
    tkv.prefill_kv(tc, torch.from_numpy(k0), torch.from_numpy(v0))
    if isinstance(index, str):
        i = int(index.split()[1])
        jidx, tidx = jnp.asarray(i, jnp.int32), torch.tensor(i)
    else:
        jidx, tidx = jnp.asarray(index, jnp.int32), (
            index if np.ndim(index) == 0 else torch.tensor(index))
    jc = jkv.append_kv(jc, jnp.asarray(k1), jnp.asarray(v1), jidx)
    target = tkv.flatten_kv_caches([tc])[0] if flat else tc
    out = tkv.append_kv(target, torch.from_numpy(k1), torch.from_numpy(v1),
                        tidx)
    assert out is target
    _assert_same(jc, tc)


def test_append_drops_negative_positions():
    """Per-slot rows before the cache are dropped too (the JAX scatter
    would wrap a negative index to the end; the port's kernels drop it)."""
    rs = np.random.RandomState(4)
    k1, v1 = _kv(rs, 3)
    _, tc = _caches()
    before = tc.k.clone()
    tkv.append_kv(tc, torch.from_numpy(k1), torch.from_numpy(v1),
                  torch.tensor([-1, -3, 5]))
    want = before.clone()
    want[0, 0:2] = tkv._quant(torch.from_numpy(k1[0:1, 1:]), tc.k_scale[0:1])
    want[2, 5:8] = tkv._quant(torch.from_numpy(k1[2:3]), tc.k_scale[2:3])
    assert torch.equal(tc.k, want)
