"""The dynamic full-INT8 matmuls of aimet_tpu_torch (``matmul_w8a8``,
``matmul_w8a8_fusedq``, ``matmul_q8``, ``int8_matmul_int32``) against the
JAX package's kernels in Pallas interpret mode, on the same numpy inputs,
through the port's plain versions (CPU).

Tolerances:
- ``matmul_q8`` (with and without ``col_bias``, f32 and bf16 out) bit for
  bit: the same int32 sums and the same epilogue, (acc * sx) * sw, or
  fma(acc * sx, sw, bias) where XLA contracts the JAX kernel's bias add;
- ``int8_matmul_int32`` equal to the int64 product;
- ``matmul_w8a8`` (K1 + KQ8 at every K) against both of the JAX
  package's routes (its fused kernel up to K = 8192, its K-split kernel
  above or with ``block_k``), f32 and bf16, bit for bit on every row
  where both packages quantize alike. The port quantizes in f32 with IEEE
  division. Inside an XLA fusion on the CPU the JAX kernels' row scale
  ``max(amax, 1e-8) / 127`` is compiled as ``amax * (1 / 127)``, an ulp
  off the quotient in about 3 % of rows of f32 data and in most rows of
  bf16 data (ROADMAP queue C); such a row is held within 4 ulps of its
  largest output plus one level of x for each value whose x / scale lies
  within ``TIE_ULPS`` f32 ulps of a rounding boundary (a code there may
  land a level off). Rows with the same scale are bit for bit. A bf16 x
  is quantized in f32 by the port (the JAX package's K-split route
  quantizes bf16 in bf16, a second formula): the bf16 oracle above
  K = 8192 is the f32 formula, JAX's ``quantize_activation_per_row`` on
  the f32 upcast and its ``matmul_q8``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops import int_matmul as jim
from aimet_tpu_torch.ops import int_matmul as tim

TIE_ULPS = 4


def _codes(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("m,k,n", [(37, 300, 130), (5, 8320, 77),
                                   (64, 256, 256)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_matmul_q8_bit_exact_with_jax_kernel(m, k, n, bias, out):
    rs = np.random.RandomState(m + k)
    xq, w = _codes(rs, m, k), _codes(rs, k, n)
    sx = rs.uniform(1e-3, 2e-2, m).astype(np.float32)
    sw = rs.uniform(1e-3, 2e-2, n).astype(np.float32)
    cb = rs.randn(n).astype(np.float32) if bias else None
    want = jim.matmul_q8(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(w),
                         jnp.asarray(sw),
                         None if cb is None else jnp.asarray(cb),
                         out_dtype=getattr(jnp, out))
    got = tim.matmul_q8(_to_torch(xq), _to_torch(sx), _to_torch(w),
                        _to_torch(sw), None if cb is None else _to_torch(cb),
                        out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_int8_matmul_int32_exact():
    rs = np.random.RandomState(1)
    xq, w = _codes(rs, 19, 1030), _codes(rs, 1030, 45)
    got = tim.int8_matmul_int32(_to_torch(xq), _to_torch(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), xq.astype(np.int64) @ w.astype(np.int64))


def _near_ties(x):
    """Per row: the values whose IEEE x / scale (scale = max(amax, 1e-8) /
    127) lies within TIE_ULPS ulps of a rounding boundary; the row scales;
    whether XLA's fused scale, amax * (1 / 127), is that quotient."""
    amax = np.maximum(np.abs(x).max(axis=1), np.float32(1e-8))
    s = amax / np.float32(127)
    t = x / s[:, None]
    tie = np.abs(t - (np.floor(t) + np.float32(0.5))) <= \
        TIE_ULPS * np.spacing(np.abs(t))
    return tie, s, s == amax * (np.float32(1) / np.float32(127))


@pytest.mark.parametrize("m,k,n,block_k", [
    (40, 300, 130, None),         # JAX's fused route, ragged M / K / N
    (8, 8200, 40, None),          # K > 8192: JAX's K-split route
    (33, 520, 96, 256),           # block_k: JAX's K-split route at small K
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_w8a8_matches_jax_kernels(m, k, n, block_k, dtype):
    rs = np.random.RandomState(k + n)
    x32 = (rs.randn(m, k) * 2).astype(np.float32)
    jx = jnp.asarray(x32).astype(getattr(jnp, dtype))
    x = np.asarray(jx.astype(jnp.float32))           # the values both see
    w = _codes(rs, k, n)
    sw = rs.uniform(1e-3, 2e-2, n).astype(np.float32)
    xla_scale = not (dtype == "bfloat16" and (block_k or k > 8192))
    if xla_scale:
        want = jim.matmul_w8a8(jx, jnp.asarray(w), jnp.asarray(sw),
                               block_k=block_k)
    else:
        # the f32 formula, op by op (the JAX K-split route quantizes bf16
        # in bf16)
        xq, sx = jim.quantize_activation_per_row(jnp.asarray(x))
        want = jim.matmul_q8(xq, sx, jnp.asarray(w), jnp.asarray(sw),
                             out_dtype=jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    got = tim.matmul_w8a8(_to_torch(x, getattr(torch, dtype)), _to_torch(w),
                          _to_torch(sw))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    got = got.float().numpy()
    tie, s, same_scale = _near_ties(x)
    exact = same_scale if xla_scale else np.ones(m, bool)
    assert exact.any()
    np.testing.assert_array_equal(got[exact], want[exact])
    # the other rows: an ulp in the scale, and a code a level off at each
    # near-tie
    ulp = np.spacing(np.abs(want).max(axis=1)) * (
        2 ** 16 if dtype == "bfloat16" else 1)
    bound = tie.sum(axis=1) * 127 * s * sw.max() * 1.01 + 4 * ulp
    diff = np.abs(got - want).max(axis=1)
    assert (diff[~exact] <= bound[~exact]).all()
    # the plain version and the public wrapper are one
    np.testing.assert_array_equal(
        tim.matmul_w8a8_torch(_to_torch(x, getattr(torch, dtype)),
                              _to_torch(w), _to_torch(sw)).float().numpy(),
        got)


def test_matmul_w8a8_rejects_bad_shapes():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        tim.matmul_w8a8(x, torch.zeros(12, 8, dtype=torch.int8),
                        torch.ones(8))
    with pytest.raises(ValueError):
        tim.matmul_q8(torch.zeros(4, 10, dtype=torch.int8), torch.ones(3),
                      torch.zeros(10, 8, dtype=torch.int8), torch.ones(8))
