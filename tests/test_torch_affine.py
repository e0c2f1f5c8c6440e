"""aimet_tpu_torch.quantization.{affine, grads} against aimet_tpu's on the
same numpy inputs: every encoding field, code and fake-quant output bit for
bit (float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.quantization import affine as jaf
from aimet_tpu.quantization import grads as jgr
from aimet_tpu_torch.quantization import affine as taf
from aimet_tpu_torch.quantization import grads as tgr

FIELDS = ("min", "max", "delta", "offset")
# (bitwidth, symmetric, strict_symmetric, unsigned_symmetric)
GRIDS = [(8, False, False, False), (8, True, False, False),
         (8, True, True, False), (8, True, False, True),
         (4, True, False, False), (4, False, False, False),
         (16, False, False, False)]


def _ranges():
    rng = np.random.RandomState(0)
    mn = (rng.randn(64) * 3).astype(np.float32)
    mx = (mn + np.abs(rng.randn(64)) * 4).astype(np.float32)
    # straddling, all-positive, all-negative, zero-width and infinite ranges
    mn[:4] = [0.0, 0.5, -3.0, -np.inf]
    mx[:4] = [2.0, 0.5, -1.0, np.inf]
    return mn, mx


def _same(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_num_quant_steps():
    for bw in (2, 4, 8, 16):
        for strict in (False, True):
            assert taf.num_quant_steps(bw, strict_symmetric=strict) == \
                jaf.num_quant_steps(bw, strict_symmetric=strict)


@pytest.mark.parametrize("bw,sym,strict,unsigned", GRIDS)
def test_encoding_from_min_max_bit_for_bit(bw, sym, strict, unsigned):
    mn, mx = _ranges()
    got = taf.compute_encoding_from_min_max(torch.from_numpy(mn),
                                            torch.from_numpy(mx), bw, sym,
                                            strict, unsigned)
    want = jaf.compute_encoding_from_min_max(jnp.asarray(mn), jnp.asarray(mx),
                                             bw, sym, strict, unsigned)
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f))
    assert got.num_steps == want.num_steps


def test_gate_min_max_and_reduce():
    mn, mx = _ranges()
    mn, mx = mn[4:], mx[4:]
    gmn, gmx = taf.gate_min_max(torch.from_numpy(mn), torch.from_numpy(mx))
    wmn, wmx = jaf.gate_min_max(jnp.asarray(mn), jnp.asarray(mx))
    _same(gmn, wmn)
    _same(gmx, wmx)
    x = np.random.RandomState(1).randn(3, 5, 7).astype(np.float32)
    for axis in (None, 0, 2):
        got = taf.reduce_min_max(torch.from_numpy(x), channel_axis=axis)
        want = jaf.reduce_min_max(jnp.asarray(x), channel_axis=axis)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("bw,sym,strict,unsigned", GRIDS[:5])
@pytest.mark.parametrize("axis", [None, 1])
def test_quantize_paths_bit_for_bit(bw, sym, strict, unsigned, axis):
    rng = np.random.RandomState(2)
    x = (rng.randn(16, 12) * 2).astype(np.float32)
    mn = x.min(axis=0) if axis is not None else x.min()
    mx = x.max(axis=0) if axis is not None else x.max()
    tenc = taf.compute_encoding_from_min_max(torch.as_tensor(mn),
                                             torch.as_tensor(mx), bw, sym,
                                             strict, unsigned)
    jenc = jaf.compute_encoding_from_min_max(jnp.asarray(mn), jnp.asarray(mx),
                                             bw, sym, strict, unsigned)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _same(taf.quantize_dequantize_encoding(tx, tenc, channel_axis=axis),
          jaf.quantize_dequantize_encoding(jx, jenc, channel_axis=axis))
    for signed in (True, False):
        _same(taf.quantize_to_int(tx, tenc, channel_axis=axis, signed=signed,
                                  dtype=torch.int32),
              jaf.quantize_to_int(jx, jenc, channel_axis=axis, signed=signed,
                                  dtype=jnp.int32))
    b = tenc.broadcast_to(x.shape, axis)
    q = taf.quantize(tx, b.delta, b.offset, tenc.num_steps)
    jb = jenc.broadcast_to(x.shape, axis)
    _same(q, jaf.quantize(jx, jb.delta, jb.offset, jenc.num_steps))
    _same(taf.dequantize(q, b.delta, b.offset),
          jaf.dequantize(jnp.asarray(q.numpy()), jb.delta, jb.offset))


@pytest.mark.parametrize("bw,sym,strict,unsigned", GRIDS[:6])
def test_fake_quant_forward_bit_for_bit(bw, sym, strict, unsigned):
    rng = np.random.RandomState(3)
    x = (rng.randn(8, 32) * 1.5).astype(np.float32)
    if unsigned:
        x = np.abs(x)
    for mn, mx in ((x.min(), x.max()),
                   (np.float32(-0.7), np.float32(2.3))):
        got = tgr.quantize_dequantize(
            torch.from_numpy(x), torch.tensor(mn), torch.tensor(mx),
            bitwidth=bw, symmetric=sym, strict_symmetric=strict,
            unsigned_symmetric=unsigned)
        want = jgr.quantize_dequantize(
            jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx), bitwidth=bw,
            symmetric=sym, strict_symmetric=strict,
            unsigned_symmetric=unsigned)
        _same(got, want)
    # per-channel (C, 1) encodings broadcast against x
    mn, mx = x.min(axis=1, keepdims=True), x.max(axis=1, keepdims=True)
    got = tgr.quantize_dequantize(torch.from_numpy(x), torch.from_numpy(mn),
                                  torch.from_numpy(mx), bitwidth=bw,
                                  symmetric=sym)
    want = jgr.quantize_dequantize(jnp.asarray(x), jnp.asarray(mn),
                                   jnp.asarray(mx), bitwidth=bw,
                                   symmetric=sym)
    _same(got, want)
