"""Weight-only INT4 / INT8 matmuls of aimet_tpu_torch (the plain versions
the CPU takes) against aimet_tpu.ops.int_matmul on the same numpy inputs:
the Pallas kernels ``matmul_w4`` / ``matmul_w8`` in interpret mode and their
XLA oracles ``matmul_w4_xla`` / ``matmul_w8_xla``.

Tolerances: INT8 codes and scales bit-exact; f32 outputs at rtol = atol =
1e-4 (as tests/test_int_matmul.py: same products, sums in another order);
bf16 outputs within 1e-2 of their max (one bf16 rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops import int_matmul as jim
from aimet_tpu_torch.ops import int_matmul as tim

BLK = dict(block_m=128, block_n=128, block_k=256)


@pytest.mark.parametrize("k,n", [(64, 32), (160, 48), (7, 5)])
def test_quantize_weight_per_channel_bit_exact(k, n):
    w = np.random.RandomState(k).randn(k, n).astype(np.float32)
    w[:, 0] = 0.0                                  # the 1e-8 scale floor
    jq, js = jim.quantize_weight_per_channel(jnp.asarray(w))
    tq, ts = tim.quantize_weight_per_channel(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _inputs(m, k, n, w4, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32)
    w = rs.randn(k, n).astype(np.float32) * 0.1
    quant = jim.quantize_weight_int4 if w4 else jim.quantize_weight_per_channel
    wq, s = (np.array(a) for a in quant(jnp.asarray(w)))
    return x, wq, s


SHAPES = [
    (16, 256, 256),       # decode M
    (5, 384, 200),        # ragged M and N
    (33, 512, 130),       # M above one sublane tile, ragged N
]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("w4", [True, False], ids=["w4", "w8"])
def test_weight_only_f32_matches_jax(m, k, n, w4):
    x, wq, s = _inputs(m, k, n, w4, m + k)
    jargs = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s))
    kernel, oracle = ((jim.matmul_w4, jim.matmul_w4_xla) if w4
                      else (jim.matmul_w8, jim.matmul_w8_xla))
    targs = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s))
    got = (tim.matmul_w4 if w4 else tim.matmul_w8)(*targs)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for want in (kernel(*jargs, **BLK), oracle(*jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    plain = tim.matmul_w4_torch if w4 else tim.matmul_w8_torch
    np.testing.assert_array_equal(plain(*targs).numpy(), got.numpy())


@pytest.mark.parametrize("w4", [True, False], ids=["w4", "w8"])
def test_weight_only_bf16_matches_jax(w4):
    x, wq, s = _inputs(16, 512, 256, w4, 3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    oracle = jim.matmul_w4_xla if w4 else jim.matmul_w8_xla
    want = np.asarray(oracle(xb, jnp.asarray(wq), jnp.asarray(s))
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = (tim.matmul_w4 if w4 else tim.matmul_w8)(
        xt, torch.from_numpy(wq), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 1e-2, err


def test_decode_splits_fill_the_card_at_decode_only():
    # decode M: a (4096, 4096) projection has 32 output tiles, so its
    # K range is split to give ~4 blocks per SM; prefill M needs none
    assert 32 * tim.decode_splits(16, 4096, 64) >= 4 * 132
    assert tim.decode_splits(4096, 4096, 64) == 1
    assert tim.decode_splits(16, 4096, 3) == 1      # >= 2 steps a split


def test_weight_only_rejects_bad_shapes():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        tim.matmul_w4(x, torch.zeros(4, 8, dtype=torch.int8), torch.ones(8))
    with pytest.raises(ValueError):
        tim.matmul_w8(x, torch.zeros(10, 8, dtype=torch.int8), torch.ones(7))
