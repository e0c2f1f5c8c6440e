"""aimet_tpu_torch.ops.int_matmul against aimet_tpu.ops.int_matmul on the
same numpy inputs (CPU; the JAX Pallas kernel runs in interpret mode).

Tolerances: codes, packed bytes and scales bit-exact; the f32 matmul at
rtol 1e-6 (exact integer sum, same epilogue order); the bf16 matmul within
one bf16 ulp of the in-kernel-quantizing TPU kernel, which quantizes in f32
as the port does, on every row where XLA's fused quantizer gives the IEEE
codes (see the test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops import int_matmul as jim
from aimet_tpu_torch.ops import int_matmul as tim


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("k,n", [(64, 32), (160, 48), (8, 5)])
def test_weight_int4_quant_and_pack_bit_exact(k, n):
    w = np.random.RandomState(k).randn(k, n).astype(np.float32)
    jp, js = jim.quantize_weight_int4(jnp.asarray(w))
    tp, ts = tim.quantize_weight_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(tim.unpack_int4(tp).numpy(),
                                  _np(jim.unpack_int4(jp)))


def test_pack_unpack_every_code_pair():
    codes = np.arange(-8, 8, dtype=np.int32)
    lo, hi = np.meshgrid(codes, codes, indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()])                   # (2, 256)
    tp = tim.pack_int4_split_half(torch.from_numpy(q))
    np.testing.assert_array_equal(
        tp.numpy(), _np(jim.pack_int4_split_half(jnp.asarray(q))))
    np.testing.assert_array_equal(tim.unpack_int4(tp).numpy(), q)


@pytest.mark.parametrize("m,k", [(7, 96), (1, 4), (33, 300),
                                 (64, 147), (40, 64), (9, 576)])
def test_activation_quant_f32_bit_exact(m, k):
    x = (np.random.RandomState(m).randn(m, k) * 3).astype(np.float32)
    x[0, :] = 0.0                                 # the 1e-8 scale floor
    jq, js = jim.quantize_activation_per_row(jnp.asarray(x))
    tq, ts = tim.quantize_activation_per_row(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_activation_quant_plan_fits_its_kernels(dtype):
    """K1's plan: the narrow rows' kernel up to its K limit for the dtype
    (lanes a power of two up to 32, at most 8 values a lane below 32 lanes
    and 32 at 32, rows a multiple of 256 / lanes, their codes within 227
    KB), else the wide rows' kernel."""
    elem = torch.empty((), dtype=dtype).element_size()
    limit = tim.ACT_QUANT_NARROW_MAX_K[dtype]
    assert limit <= 1024
    for k in (1, 2, 7, 8, 9, 63, 64, 65, 147, 256, 257, 512, 576, 1024,
              1025, 4096):
        plan = tim.act_quant_plan(k, dtype)
        if k > limit:
            assert plan is None
            continue
        lanes, rows = plan
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert k <= 8 * lanes or (lanes == 32 and k <= 1024)
        assert lanes == 1 or k > 8 * (lanes // 2)
        assert rows % (256 // lanes) == 0 and rows * k + 16 <= 227 * 1024
        assert rows == 256 // lanes or rows * k * elem <= \
            tim.ACT_QUANT_STAGE_BYTES
    assert set(tim.quantize_activation_per_row.routes) == {"narrow", "wide"}


def test_activation_codes_by_reciprocal_equal_division():
    """The narrow kernel's codes (csrc/row_quant.cuh, code_by_inv): y = x *
    (1 / s) rounded half to even where y lies more than 1e-4 from a
    half-integer, else x / s, equal rint(x / s) (IEEE f32) on random rows
    and on values at, just off and 2^-16 off half-integers of the grid."""
    rs = np.random.RandomState(5)
    x = (rs.randn(2000, 96) * rs.exponential(3.0, (2000, 1))).astype(
        np.float32)
    amax = np.abs(x).max(1)
    halves = (rs.randint(-127, 127, (2000, 32)) + 0.5).astype(np.float32)
    sc0 = (np.maximum(amax, np.float32(1e-8)) / np.float32(127)).astype(
        np.float32)
    near = (halves * sc0[:, None]).astype(np.float32)
    nudge = np.float32(2.0 ** -16) * sc0[:, None]
    x = np.concatenate([x, near, near + nudge, near - nudge,
                        np.nextafter(near, np.float32(np.inf))], 1)
    x = np.clip(x, -amax[:, None], amax[:, None])        # amax unchanged
    s = (np.maximum(np.abs(x).max(1), np.float32(1e-8))
         / np.float32(127)).astype(np.float32)[:, None]
    inv = (np.float32(1) / s).astype(np.float32)
    y = (x * inv).astype(np.float32)
    div = (x / s).astype(np.float32)
    clear = np.abs(y - np.floor(y) - np.float32(0.5)) > np.float32(1e-4)
    got = np.clip(np.rint(np.where(clear, y, div)), -127, 127)
    np.testing.assert_array_equal(got, np.clip(np.rint(div), -127, 127))
    assert (~clear).sum() > 0 and (np.rint(y) != np.rint(div)).any()


def _weights(k, n, seed):
    rs = np.random.RandomState(seed)
    packed = rs.randint(-128, 128, (k // 2, n)).astype(np.int8)
    scale = (rs.uniform(0.5, 1.5, n) * 0.02 / np.sqrt(k)).astype(np.float32)
    return packed, scale


@pytest.mark.parametrize("m,k2,n", [
    (5, 48, 40),          # odd M, K2 not a multiple of 256
    (17, 96, 33),         # ragged N
    (3, 4104, 16),        # K = 8208 > 8192 (the TPU's K-split path)
])
def test_matmul_w4a8_f32_matches_xla(m, k2, n):
    rs = np.random.RandomState(m)
    x = rs.randn(m, 2 * k2).astype(np.float32)
    packed, scale = _weights(2 * k2, n, m + 1)
    want = _np(jim.matmul_w4a8_xla(jnp.asarray(x), jnp.asarray(packed),
                                   jnp.asarray(scale)))
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scale))
    got = tim.matmul_w4a8(*args)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tim.matmul_w4a8_torch(*args).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("m,k2,n", [
    (9, 64, 24), (32, 160, 130),
    (1, 32, 16), (16, 64, 48), (64, 32, 32),   # decode M: the fused route
])
def test_matmul_w4a8_bf16_matches_fusedq_kernel(m, k2, n):
    rs = np.random.RandomState(k2)
    x32 = rs.randn(m, 2 * k2).astype(np.float32)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    x_bf16_as_f32 = np.array(xb.astype(jnp.float32))
    packed, scale = _weights(2 * k2, n, k2 + 1)
    want = np.asarray(jim.matmul_w4a8_fusedq(
        xb, jnp.asarray(packed), jnp.asarray(scale)).astype(jnp.float32))
    xt = torch.from_numpy(x_bf16_as_f32).to(torch.bfloat16)
    # codes: the port's f32 quantizer == JAX's quantizer on the f32 upcast
    tq, ts = tim.quantize_activation_per_row(xt)
    jq, js = jim.quantize_activation_per_row(jnp.asarray(x_bf16_as_f32))
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    got, fq, fs = tim.matmul_w4a8_fusedq(xt, torch.from_numpy(packed),
                                         torch.from_numpy(scale),
                                         return_codes=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(fq, tq) and torch.equal(fs, ts)
    assert torch.equal(tim.matmul_w4a8(xt, torch.from_numpy(packed),
                                       torch.from_numpy(scale)), got)
    got = got.to(torch.float32).numpy()
    # XLA's CPU fusion of x / scale is not always an IEEE division: in a
    # fused (jit / interpret-mode) program a row's codes can shift by one
    # level at a rounding boundary. Rows where the fused quantizer agrees
    # with the IEEE codes must match within one bf16 ulp; the rest only
    # within the size of a one-level code change.
    fused_q = np.asarray(jax.jit(jim.quantize_activation_per_row)(
        jnp.asarray(x_bf16_as_f32))[0])
    same = (fused_q == tq.numpy()).all(axis=1)
    assert same.sum() >= m - 2, np.flatnonzero(~same)
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16  # bf16 ulp
    diff = np.abs(got - want)
    assert np.all(diff[same] <= ulp[same]), diff[same].max()
    assert np.all(diff[~same] <= 1e-2 * np.abs(want).max())


def test_matmul_w4a8_fusedq_takes_the_jax_signature():
    """Block sizes are accepted and unused; the output dtype defaults to
    x's; the route needs nothing of the CPU (the plain versions, no
    launch counted)."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(16, 64).astype(np.float32))
    packed, scale = (torch.from_numpy(a) for a in _weights(64, 32, 4))
    before = tim.matmul_w4a8_fusedq.launches
    got = tim.matmul_w4a8_fusedq(x, packed, scale, block_m=8, block_n=128)
    assert got.dtype == torch.float32
    assert torch.equal(got, tim.matmul_w4a8_torch(x, packed, scale))
    assert torch.equal(tim.matmul_w4a8_fusedq(
        x, packed, scale, out_dtype=torch.bfloat16),
        tim.matmul_w4a8_torch(x, packed, scale, torch.bfloat16))
    assert tim.matmul_w4a8_fusedq.launches == before
    assert tim.w4a8_fusedq_decode_route(16, 32, 32, x.dtype)


def test_matmul_w4a8_rejects_bad_shapes():
    x = torch.zeros(4, 10)
    for fn in (tim.matmul_w4a8, tim.matmul_w4a8_fusedq):
        with pytest.raises(ValueError):
            fn(x, torch.zeros(4, 8, dtype=torch.int8), torch.ones(8))



@pytest.mark.parametrize("m,n,k2,want", [
    (16, 28672, 2048, True),          # decode: W_gate|up
    (1, 6144, 2048, True),
    (64, 131072, 2048, True),         # lm_head at its padded width
    (65, 4096, 2048, False),          # prefill M: the tile
    (0, 4096, 2048, False),
    (16, 1000, 72, False),            # ragged: N % 16
    (37, 1008, 72, False),            # K/2 % 16
    (17, 1296, 528, True),            # no whole slice or stage
])
def test_w4a8_decode_route_edges(m, n, k2, want):
    assert tim.w4a8_decode_route(m, n, k2) is want


def _block_pieces(plan, b):
    """Block b's pieces under a decode plan, as ``decode_gemm.cuh``'s
    ``for_pieces`` walks them: (slice, first stage, end stage)."""
    total = plan.slices * plan.steps
    u, u1 = b * total // plan.blocks, (b + 1) * total // plan.blocks
    out = []
    while u < u1:
        j = u // plan.steps
        ue = min(u1, (j + 1) * plan.steps)
        out.append((j, u - j * plan.steps, ue - j * plan.steps))
        u = ue
    return out


@pytest.mark.parametrize("n,k2", [(6144, 2048), (4096, 2048), (28672, 2048),
                                  (4096, 7168), (131072, 2048), (1296, 528)])
def test_w4a8_decode_plan_shares_weight_bytes_evenly(n, k2):
    """K2's decode route cuts the packed (K/2, N) weight as KW8's cuts its
    int8 one: over 132 SMs every block streams the same packed bytes within
    one stage (64 rows x a slice) and the narrower last slice, at least two
    stages each; the pieces cover every (slice, stage) unit once and their
    int32 workspace slots (slice + block) are distinct and within it."""
    m = 16
    plan = tim.decode_plan(m, n, k2, 132)
    assert plan.slices == -(-n // 256) and plan.steps == -(-k2 // 64)
    seen, slots, got = [], set(), []
    for b in range(plan.blocks):
        pieces = _block_pieces(plan, b)
        assert sum(s1 - s0 for _, s0, s1 in pieces) >= 2
        nbytes = 0
        for j, s0, s1 in pieces:
            seen += [(j, s) for s in range(s0, s1)]
            assert j + b not in slots
            slots.add(j + b)
            nbytes += min(256, n - 256 * j) * (min(64 * s1, k2) - 64 * s0)
        got.append(nbytes)
    assert sorted(seen) == [(j, s) for j in range(plan.slices)
                            for s in range(plan.steps)]
    assert (max(slots) + 1) * m * 256 <= plan.ws_values
    assert sum(got) == n * k2
    assert max(got) - min(got) <= 2 * 64 * 256
