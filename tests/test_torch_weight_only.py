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


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (1, 4096, 4096, torch.bfloat16, True),
    (64, 28672, 4096, torch.bfloat16, True),
    (65, 4096, 4096, torch.bfloat16, False),     # prefill M: the tile
    (0, 4096, 4096, torch.bfloat16, False),
    (16, 4096, 4096, torch.float32, False),      # f32 x: the tile
    (16, 4104, 4096, torch.bfloat16, False),     # N % 16
    (16, 4096, 4104, torch.bfloat16, False),     # K % 16
    (16, 1296, 1040, torch.bfloat16, True),
])
def test_w8_decode_route_edges(m, n, k, dtype, want):
    assert tim.w8_decode_route(m, n, k, dtype) is want


def _pieces(plan, b):
    """Block b's pieces under a decode plan, as ``decode_gemm.cuh``'s
    ``for_pieces`` walks them: (slice, first stage, end stage), in order."""
    total = plan.slices * plan.steps
    u, u1 = b * total // plan.blocks, (b + 1) * total // plan.blocks
    out = []
    while u < u1:
        j = u // plan.steps
        ue = min(u1, (j + 1) * plan.steps)
        out.append((j, u - j * plan.steps, ue - j * plan.steps))
        u = ue
    return out


def _plan_bytes(plan, n, rows):
    """Weight bytes each block of a decode plan streams (int8 rows of n
    columns, slices of 256)."""
    out = []
    for b in range(plan.blocks):
        total = 0
        for j, s0, s1 in _pieces(plan, b):
            cols = min(256, n - j * 256)
            total += cols * (min(s1 * 64, rows) - s0 * 64)
        out.append(total)
    return out


@pytest.mark.parametrize("n,k", [(6144, 4096), (4096, 4096), (28672, 4096),
                                 (4096, 14336), (128256, 4096),
                                 (1296, 1040)])
def test_w8_decode_plan_shares_bytes_evenly(n, k):
    """Over 132 SMs every block streams the same weight bytes, within one
    stage (64 rows x the slice) and the narrower last slice; each block at
    least two stages; pieces cover every (slice, stage) unit once, and the
    workspace slots (slice + block) are distinct and within its size."""
    m = 16
    plan = tim.decode_plan(m, n, k, 132)
    assert plan.slices == -(-n // 256) and plan.steps == -(-k // 64)
    assert plan.blocks == min(132, plan.slices * plan.steps // 2)
    seen, slots = [], set()
    for b in range(plan.blocks):
        pieces = _pieces(plan, b)
        assert sum(s1 - s0 for _, s0, s1 in pieces) >= 2
        for j, s0, s1 in pieces:
            seen += [(j, s) for s in range(s0, s1)]
            assert j + b not in slots
            slots.add(j + b)
    assert sorted(seen) == [(j, s) for j in range(plan.slices)
                            for s in range(plan.steps)]
    assert (max(slots) + 1) * m * 256 <= plan.ws_values
    got = _plan_bytes(plan, n, k)
    assert sum(got) == n * k
    assert max(got) - min(got) <= 2 * 64 * 256


def test_w8_decode_plan_at_small_shapes():
    # fewer than 2 x 132 stages: fewer blocks, two stages each at least
    plan = tim.decode_plan(16, 512, 1024, 132)
    assert plan.slices == 2 and plan.steps == 16 and plan.blocks == 16
    # N below one slice: one slice of 256 columns (the kernel masks the
    # columns past N), one block
    plan = tim.decode_plan(1, 128, 16, 132)
    assert (plan.slices, plan.steps, plan.blocks) == (1, 1, 1)
    assert plan.ws_values == 1 * 256


def test_weight_only_rejects_bad_shapes():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        tim.matmul_w4(x, torch.zeros(4, 8, dtype=torch.int8), torch.ones(8))
    with pytest.raises(ValueError):
        tim.matmul_w8(x, torch.zeros(10, 8, dtype=torch.int8), torch.ones(7))


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (16, 256, 2048),
                                   (40, 384, 200)])
def test_matmul_w4_decode_matches_jax(m, k, n):
    """``matmul_w4_decode`` against the JAX package's (its Pallas kernel in
    interpret mode with the swept decode blocks) at KW4's tolerances: f32 at
    rtol = atol = 1e-4, bf16 within 1e-2 of its max; the same bits as
    ``matmul_w4``."""
    x, wq, s = _inputs(m, k, n, True, m + n)
    jargs = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s))
    targs = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s))
    got = tim.matmul_w4_decode(*targs)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jim.matmul_w4_decode(*jargs)),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tim.matmul_w4(*targs))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jim.matmul_w4_decode(xb, *jargs[1:]).astype(
        jnp.float32))
    gotb = tim.matmul_w4_decode(
        torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16), *targs[1:])
    assert gotb.dtype == torch.bfloat16
    err = np.abs(gotb.float().numpy() - want).max() / np.abs(want).max()
    assert err < 1e-2, err


@pytest.mark.parametrize("n", [1, 4096, 6144, 16383, 16384, 28672, 131072])
def test_decode_blocks_is_the_jax_tuple(n):
    assert tim.decode_blocks(n) == jim.decode_blocks(n)
