"""aimet_tpu_torch.quantization.blockwise against aimet_tpu's on the same
numpy weights: blockwise encodings, LPBQ scale compression and both
fake-quant paths bit for bit (float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.quantization import blockwise as jbw
from aimet_tpu_torch.quantization import blockwise as tbw
from aimet_tpu_torch.quantization import grads as tgr

FIELDS = ("min", "max", "delta", "offset")


def _w(shape=(64, 24), seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(
        np.float32)


def _same(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("block,axis,bw,sym", [
    (16, 0, 4, True), (8, 0, 4, False), (32, 0, 8, True), (6, 1, 4, True),
])
def test_blockwise_encoding_and_qdq(block, axis, bw, sym):
    w = _w()
    got = tbw.blockwise_encoding(torch.from_numpy(w), block, axis, bw, sym)
    want = jbw.blockwise_encoding(jnp.asarray(w), block, axis, bw, sym)
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f))
    # the quantsim's blockwise fake-quant: the blocked view on this grid
    qdq = tgr.quantize_dequantize(tbw._to_blocks(torch.from_numpy(w), block,
                                                 axis), got.min, got.max,
                                  bitwidth=bw, symmetric=sym)
    _same(qdq.reshape(w.shape),
          jbw.blockwise_quantize_dequantize(jnp.asarray(w), block, axis, bw,
                                            sym))


@pytest.mark.parametrize("block,axis,group,sbw", [
    (16, 0, -1, 4), (8, 0, 2, 4), (8, 0, 4, 3), (6, 1, 2, 4),
])
def test_lpbq_bit_for_bit(block, axis, group, sbw):
    w = _w(seed=1)
    got_out, got = tbw.grouped_block_quantize_dequantize(
        torch.from_numpy(w), block, axis, 4, sbw, group)
    want_out, want = jbw.grouped_block_quantize_dequantize(
        jnp.asarray(w), block, axis, 4, sbw, group)
    _same(got_out, want_out)
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f))
    scale = np.abs(_w((8, 12), seed=2)) + 1e-3
    for g, w_ in zip(tbw.lpbq_compress_scales(torch.from_numpy(scale), 4, 0,
                                              sbw),
                     jbw.lpbq_compress_scales(jnp.asarray(scale), 4, 0, sbw)):
        _same(g, w_)


def test_block_size_must_divide():
    with pytest.raises(ValueError):
        tbw.blockwise_encoding(torch.zeros(10, 4), 3, 0)
