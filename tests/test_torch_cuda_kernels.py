"""The port's CUDA kernels against their plain PyTorch versions on the card,
at main-path shapes. Every test here needs a CUDA device and skips without
one. This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: codes, W4A8, static-INT8 (KSQ) and dynamic full-INT8 (K1 +
KQ8, KQ8 with its int32 entry) GEMM outputs, the integer convs on the card
against the same functions on the CPU, and KV-cache bytes bit-exact; the
rest as max |kernel - plain| relative to max |plain|: decode attention and
the fused layer kernels < 2e-2 (< 6e-2 with int8 dots), the weight-only
GEMMs (KW4, KW8, group-wise KW4G; bf16 or f32 x) and their im2col convs
(``conv2d_w8``, ``conv2d_w4`` at ResNet-50 conv shapes) < 1e-2, and their
repeated calls give the same bits. KDL (``fused_decode_layer``) gives
KSOL's bits on the same inputs, and KFL the same bits with gate and up
separate or concatenated. KGQA: f32 q within 1e-4 of the max (f32 sums of
1024 rows in another order); bf16 q within one bf16 ulp of every prob
(v_scale * sum_s ulp(p_s) |v_s|) plus that. KQ8's int32 entry is
bit-exact on both routes (a K-major transposed-view weight: TMA + wgmma;
an N-major one: the mma.sync tile), at conv-patch K including the stem's
147; KW4G takes group sizes that are not multiples of 16 (8, 24) within
the same 1e-2; K3, KGQA and KSOL keep their tolerances and bit-exact
cache bytes at S = 16,384, whose score rows do not fit in shared memory.
KW8's decode weight-streaming route (bf16 x, M <= 64) keeps KW8's 1e-2 at
M = 1, 16, 17, 32, 64 on N and K that fill no whole slice or stage, and
the whole-layer kernels (KSOL, KDL, KFL) keep theirs at M = 1, 16, 33, 64
with KDL = KSOL bit for bit and repeated launches bit-identical. K2's
decode route is bit-exact at the same M and ragged widths, and at the
``lm_head``'s; K3 split across blocks keeps bit-exact cache bytes and 2e-2
at rep 1, 4, 8, D 40, 64, 128, every position kind, B = 1 and S = 16,384,
with repeated launches bit-identical. KW4's decode route (bf16 x, M <= 64)
keeps 1e-2 at M = 1, 16, 33, 64 and the Llama widths; its TMA + wgmma
tile (M > 64) keeps it at M = 65, 128, 300, 4096 with ragged N and K/2
(through ``matmul_w4`` where the route takes it, else launched directly),
f32 x (1e-4 with an f32 output; K/2 = 100, whose high half the f32 pairs
realign) and ``conv2d_w4``, is exact on one tile of
small integers, and both repeat their bits; both C entries refuse short
buffers. KW8's TMA + wgmma tile (M > 64) keeps KW8's 1e-2 at ragged M, N
and K (and 1e-4 with an f32 x and an f32 output), K2's is bit-exact at M =
65, 200, 4096 with ragged N and K/2 and at every Llama-3-8B layer shape;
both are exact on one tile of small integers, repeat their bits, and their
C entries refuse operands their TMA boxes cannot map. KSQ's TMA + wgmma
tile (M > 64) is bit-exact, codes and outputs, with f32 and bf16 x and
out at ragged M, N and K, the lowered forward's linears and its f32
lm_head cut in M; KW4G's keeps 1e-2 with a bf16 x at groups 64, 128 and
256, and with an f32 x and out W4G_F32_TOL (no worse than the block tile
it replaces); both are exact on one tile of small integers, repeat their
bits, and their C entries refuse what their boxes and stages cannot take.
KQ8's float entries on the TMA + wgmma tile (M > 64) are bit-exact with
and without a column bias, f32 and bf16 out, at ragged M, N and K, at the
ResNet-50 conv patches and at M = 4096, through ``matmul_w8a8`` too; exact
on one tile of small integers; their C entry refuses what its boxes cannot
map. K2's fused decode kernel (``matmul_w4a8_fusedq`` at M <= 64) gives K1
+ K2's decode route's codes, scales and outputs bit for bit, bf16 and f32
x, at ragged M, N and K, in one launch; it repeats its bits and refuses a
grid that cannot be resident at once. K1 is bit-exact on both of its
kernels (narrow rows: several a block; wide rows: a block a row) at K = 1
to 4096, f32 and bf16, at M that leaves a partial block, on a view one
element into its buffer and on all-zero rows (the 1e-8 floor). KGQA split
across 1 to 24 chunks keeps its tolerances at positions -1, 0, on chunk
edges, the last row and past S, repeats its bits, and its C entry refuses
a short workspace.
"""
import pytest
import torch

from aimet_tpu_torch.ops import int_conv as tic
from aimet_tpu_torch.ops import int_matmul as tim
from aimet_tpu_torch.ops.decode_attention_fused import (
    fused_decode_attention, fused_decode_attention_torch)
from aimet_tpu_torch.ops.decode_layer_sol import (sol_decode_layer,
                                                  sol_decode_layer_torch)
from aimet_tpu_torch import _build
from aimet_tpu_torch.ops import fused_layer as flay
from aimet_tpu_torch.ops.decode_attention import (
    fused_gqa_decode_attention, fused_gqa_decode_attention_torch)
from aimet_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                             fused_decode_layer_torch,
                                             fused_wo_mlp, fused_wo_mlp_torch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("m,k2,n,dtype", [
    (16, 2048, 6144, torch.bfloat16),       # decode wqkv
    (37, 72, 1000, torch.float32),          # ragged M, N and K
    (300, 7168, 4096, torch.bfloat16),      # prefill-like w_down
])
def test_w4a8_kernels_match_plain(gen, m, k2, n, dtype):
    x = torch.randn((m, 2 * k2), generator=gen, device="cuda").to(dtype)
    packed = torch.randint(-128, 128, (k2, n), dtype=torch.int8,
                           generator=gen, device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    q, s = tim.quantize_activation_per_row(x)
    pq, ps = tim._quantize_activation_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(tim.matmul_w4a8(x, packed, scale),
                       tim.matmul_w4a8_torch(x, packed, scale))


@pytest.mark.parametrize("positions", ["scalar", "mixed", "outside"])
def test_decode_attention_kernel_matches_plain(gen, positions):
    b, s, h, kh, d = 16, 1024, 32, 8, 128
    kc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    vc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    ks = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    vs = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    qkv = torch.randn((b, (h + 2 * kh) * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    if positions == "scalar":
        pos = torch.full((b,), 700, dtype=torch.int32, device="cuda")
    else:
        pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, s - 1
        if positions == "outside":
            pos[1], pos[2] = s, s + 7
    ang = pos.float()[:, None] * torch.rand(d // 2, generator=gen,
                                            device="cuda")
    cos, sin = torch.cos(ang), torch.sin(ang)
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = fused_decode_attention(qkv, cos, sin, kc, vc, ks, vs, pos,
                                       n_heads=h, n_kv_heads=kh)
    ref, _, _ = fused_decode_attention_torch(qkv, cos, sin, kc2, vc2, ks, vs,
                                             pos, n_heads=h, n_kv_heads=kh)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err < 2e-2, err


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("m,k,n", [
    (16, 4096, 6144),                       # decode wqkv
    (37, 144, 1000),                        # ragged M, N and K
    (300, 2048, 4096),                      # prefill-like
])
@pytest.mark.parametrize("w4", [True, False], ids=["w4", "w8"])
def test_weight_only_kernels_match_plain(gen, m, k, n, w4):
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-128, 128, (k // 2 if w4 else k, n), dtype=torch.int8,
                      generator=gen, device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    fn, plain = ((tim.matmul_w4, tim.matmul_w4_torch) if w4
                 else (tim.matmul_w8, tim.matmul_w8_torch))
    got = fn(x, w, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert _rel(got, plain(x, w, scale)) < 1e-2
    assert torch.equal(fn(x, w, scale), got)          # fixed split order


@pytest.mark.parametrize("m,k,n", [
    (16, 4096, 6144),                       # decode
    (37, 144, 1000),                        # ragged M, N and K
    (300, 4096, 4096),                      # prefill-like (lm_head runs f32)
])
@pytest.mark.parametrize("w4", [True, False], ids=["w4", "w8"])
def test_weight_only_kernels_take_f32_x(gen, m, k, n, w4):
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randint(-128, 128, (k // 2 if w4 else k, n), dtype=torch.int8,
                      generator=gen, device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    fn, plain = ((tim.matmul_w4, tim.matmul_w4_torch) if w4
                 else (tim.matmul_w8, tim.matmul_w8_torch))
    got = fn(x, w, scale)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got, plain(x, w, scale)) < 1e-2
    assert torch.equal(fn(x, w, scale), got)


@pytest.mark.parametrize("m,k,n,group,dtype", [
    (16, 4096, 4096, 128, torch.bfloat16),  # decode
    (37, 512, 1000, 16, torch.bfloat16),    # ragged M and N, smallest group
    (300, 4096, 1000, 128, torch.float32),  # f32 x
    (64, 14336, 4096, 128, torch.bfloat16),  # w_down
])
def test_w4_grouped_kernel_matches_plain(gen, m, k, n, group, dtype):
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    packed, scales = tim.quantize_weight_int4_grouped(w, group)
    got = tim.matmul_w4_grouped(x, packed, scales, group_size=group)
    want = tim.matmul_w4_grouped_torch(x, packed, scales, group)
    assert got.dtype == dtype and got.shape == (m, n)
    assert _rel(got, want) < 1e-2
    assert torch.equal(tim.matmul_w4_grouped(x, packed, scales,
                                             group_size=group), got)


@pytest.mark.parametrize("m,k,n,x_dtype,out_dtype", [
    (16, 4096, 4096, torch.bfloat16, torch.float32),   # decode, split K
    (37, 144, 1000, torch.float32, torch.float32),     # ragged M, N and K
    (300, 14336, 4096, torch.bfloat16, torch.bfloat16),  # w_down
    (2048, 4096, 1024, torch.bfloat16, torch.bfloat16),  # prefill wk
])
def test_staticq_kernel_matches_plain_bit_for_bit(gen, m, k, n, x_dtype,
                                                  out_dtype):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 2).to(x_dtype)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sv = torch.rand((n,), generator=gen, device="cuda") * 1e-4
    cb = torch.randn((n,), generator=gen, device="cuda")
    kw = dict(inv_delta=1 / 0.0317, offset=-131.0, num_steps=255.0,
              out_dtype=out_dtype, return_codes=True)
    got, codes = tim.matmul_w8a8_staticq(x, w, sv, cb, **kw)
    want, pcodes = tim.matmul_w8a8_staticq_torch(x, w, sv, cb, **kw)
    assert torch.equal(codes, pcodes)
    assert got.dtype == out_dtype and torch.equal(got, want)


def _int4(gen, k, n):
    return (torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                          generator=gen, device="cuda"),
            (torch.rand((n,), generator=gen, device="cuda") + 0.5)
            * (1.5 / k ** 0.5) / 4)


def _block(gen, a, d, f, nq):
    return dict(
        wo_pair=_int4(gen, a, d), gateup_pair=_int4(gen, d, 2 * f),
        down_pair=_int4(gen, f, d),
        mlp_gamma=(torch.rand(d, generator=gen, device="cuda") + 0.5).to(
            torch.bfloat16),
        next_qkv=None if not nq else (_int4(gen, d, nq), (torch.rand(
            d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)))


def _jax_form(kw, separate=False):
    """``_block``'s arguments in the JAX signature of fused_wo_mlp /
    fused_decode_layer: gate|up as one array located by
    ``up_block_offset``, or (``separate``) as two contiguous arrays."""
    kw = dict(kw)
    w, s = kw.pop("gateup_pair")
    f = w.shape[1] // 2
    if separate:
        kw.update(gate_pair=(w[:, :f].contiguous(), s[:f]),
                  up_pair=(w[:, f:].contiguous(), s[f:]))
    else:
        kw.update(gate_pair=(w, s[:f]), up_pair=(w, s[f:]), block_g=f,
                  up_block_offset=1, n_f=f)
    return kw


@pytest.mark.parametrize("next_qkv", [False, True])
def test_fused_wo_mlp_kernel_matches_plain(gen, next_qkv):
    m, a, d, f, nq = 16, 2048, 2048, 5632, 3072
    ao = torch.randn((m, a), generator=gen, device="cuda").to(torch.bfloat16)
    resid = torch.randn((m, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    blk = _block(gen, a, d, f, nq if next_qkv else 0)
    kw = _jax_form(blk)
    got = fused_wo_mlp(ao, resid, **kw)
    want = fused_wo_mlp_torch(ao, resid, **kw)
    sep = fused_wo_mlp(ao, resid, **_jax_form(blk, separate=True))
    got, want, sep = ((got, want, sep) if next_qkv
                      else ((got,), (want,), (sep,)))
    for g, w, p in zip(got, want, sep):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g, w) < 2e-2
        assert torch.equal(g, p)     # gate and up apart: the same bits


@pytest.mark.parametrize("int8_dots", [False, True])
@pytest.mark.parametrize("next_qkv", [False, True])
def test_sol_decode_layer_kernel_matches_plain(gen, int8_dots, next_qkv):
    b, s, h, kh, d, f, pos = 16, 512, 16, 4, 128, 5632, 300
    dm = h * d
    kc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    vc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    ks = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    vs = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    qkv = torch.randn((b, (h + 2 * kh) * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    resid = torch.randn((b, dm), generator=gen, device="cuda").to(
        torch.bfloat16)
    ang = torch.full((b, 1), float(pos), device="cuda") * torch.rand(
        d // 2, generator=gen, device="cuda")
    cos, sin = torch.cos(ang), torch.sin(ang)
    kw = _block(gen, dm, dm, f, (h + 2 * kh) * d if next_qkv else 0)
    kc2, vc2 = kc.clone(), vc.clone()
    got = sol_decode_layer(qkv, resid, kc, vc, ks, vs, pos, cos, sin,
                           n_heads=h, n_kv_heads=kh, int8_dots=int8_dots,
                           **kw)
    want = sol_decode_layer_torch(qkv, resid, kc2, vc2, ks, vs, pos, cos,
                                  sin, n_heads=h, n_kv_heads=kh,
                                  int8_dots=int8_dots, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    n_out = 2 if next_qkv else 1
    for g, w in zip(got[:n_out], want[:n_out]):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g, w) < (6e-2 if int8_dots else 2e-2)


@pytest.mark.parametrize("m,k,n,dtype", [
    (16, 4096, 6144, torch.bfloat16),           # decode M: split K
    (37, 300, 1000, torch.float32),             # ragged M, N and K
    (2048, 4096, 1024, torch.bfloat16),         # prefill
    (300, 14336, 4096, torch.bfloat16),         # w_down's K
    (64, 1152, 128, torch.float32),             # a ResNet-50 conv's K
])
def test_w8a8_kernels_match_plain_bit_for_bit(gen, m, k, n, dtype):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 2).to(dtype)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    got = tim.matmul_w8a8(x, w, sw)
    assert got.dtype == dtype
    assert torch.equal(got, tim.matmul_w8a8_torch(x, w, sw))


@pytest.mark.parametrize("m,k,n,bias,out_dtype", [
    (16, 4096, 4096, True, torch.float32),      # decode, split K
    (37, 144, 1000, False, torch.bfloat16),     # ragged M, N and K
    (1024, 14336, 4096, True, torch.bfloat16),  # w_down
    (4096, 1152, 128, False, torch.float32),    # a ResNet-50 conv
])
def test_q8_kernel_matches_plain_bit_for_bit(gen, m, k, n, bias,
                                             out_dtype):
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen,
                       device="cuda")
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sx = torch.rand((m,), generator=gen, device="cuda") * 1e-2
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    cb = torch.randn((n,), generator=gen, device="cuda") if bias else None
    got = tim.matmul_q8(xq, sx, w, sw, cb, out_dtype=out_dtype)
    assert torch.equal(got, tim.matmul_q8_torch(xq, sx, w, sw, cb,
                                                out_dtype))
    assert torch.equal(tim.int8_matmul_int32(xq, w),
                       tim.int8_matmul_int32_torch(xq, w))


@pytest.mark.parametrize("groups,strides,lhs", [
    (1, (1, 1), None), (1, (2, 2), None), (1, (1, 1), (2, 2)),
    (96, (2, 2), None)])
def test_int_convs_on_card_match_cpu(gen, groups, strides, lhs):
    x = torch.rand((4, 96, 28, 28), generator=gen, device="cuda") * 4 - 1
    w = torch.randint(-127, 128, (64 if groups == 1 else 96, 96 // groups,
                                  3, 3), dtype=torch.int8, generator=gen,
                      device="cuda")
    ws = torch.rand((w.shape[0],), generator=gen, device="cuda") * 1e-2
    kw = dict(strides=strides, padding=((1, 1), (0, 2)),
              feature_group_count=groups, lhs_dilation=lhs)
    enc = (5.0 / 255, -51.0, 255.0)
    for fn, args in ((tic.conv2d_int8_static, enc), (tic.conv2d_w8a8_dynamic,
                                                     ())):
        got = fn(x, w, ws, *args, **kw)
        want = fn(x.cpu(), w.cpu(), ws.cpu(), *args, **kw)
        assert torch.equal(got.cpu(), want)
    if groups == 1 and lhs is None:
        wq, s = tic.quantize_conv_weight_per_channel(
            torch.randn((64, 96, 3, 3), generator=gen, device="cuda"))
        got = tic.conv2d_w8a8(x, wq, s, (3, 3), strides=strides)
        want = tic.conv2d_w8a8(x.cpu(), wq.cpu(), s.cpu(), (3, 3),
                               strides=strides)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bits,shape,co,k,stride", [
    (8, (8, 3, 224, 224), 64, 7, 2),        # ResNet-50 stem: K = 147
    (8, (8, 512, 7, 7), 512, 3, 1),         # layer4 3x3: K = 4608
    (4, (8, 64, 56, 56), 256, 1, 1),        # layer1 1x1: K = 64
    (4, (8, 128, 28, 28), 128, 3, 1),       # layer2 3x3: K = 1152
])
def test_weight_only_im2col_convs_match_plain(gen, bits, shape, co, k,
                                              stride):
    x = torch.randn(shape, generator=gen, device="cuda")
    w = torch.randn((co, shape[1], k, k), generator=gen, device="cuda") * 0.03
    quant, conv, mm = (
        (tic.quantize_conv_weight_per_channel, tic.conv2d_w8,
         tim.matmul_w8_torch) if bits == 8 else
        (tic.quantize_conv_weight_int4, tic.conv2d_w4, tim.matmul_w4_torch))
    wq, s = quant(w)
    got = conv(x, wq, s, (k, k), strides=(stride, stride))
    want = tic._im2col_conv(mm, x, wq, s, (k, k), (stride, stride), "SAME",
                            None, None)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < 1e-2


def _layer_inputs(gen, b, s, h, kh, d, pos):
    kc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    vc = torch.randint(-127, 128, (b, s, kh, d), dtype=torch.int8,
                       generator=gen, device="cuda")
    ks = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    vs = torch.rand((b, kh), generator=gen, device="cuda") * 0.05 + 0.01
    qkv = torch.randn((b, (h + 2 * kh) * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    resid = torch.randn((b, h * d), generator=gen, device="cuda").to(
        torch.bfloat16)
    ang = torch.full((1, 1), float(pos), device="cuda") * torch.rand(
        d // 2, generator=gen, device="cuda")
    return qkv, resid, kc, vc, ks, vs, torch.cos(ang), torch.sin(ang)


@pytest.mark.parametrize("flat", [False, True], ids=["4d", "flat"])
@pytest.mark.parametrize("next_qkv", [False, True])
def test_fused_decode_layer_kernel_matches_plain_and_sol(gen, next_qkv,
                                                         flat):
    """KDL against its plain version, and against KSOL on the same inputs
    (the same kernel code: the same bits), at the KSOL test's shapes: at
    Llama-3-8B widths these weights take both just above 2e-2 of the max
    against the plain version, whose decode attention rounds its probs and
    context to bf16 where the kernel keeps f32 (chip_smoke.py holds KDL at
    those widths on its own weights)."""
    b, s, h, kh, d, f, pos = 16, 512, 16, 4, 128, 5632, 300
    qkv, resid, kc, vc, ks, vs, cos, sin = _layer_inputs(gen, b, s, h, kh,
                                                         d, pos)
    blk = _block(gen, h * d, h * d, f, (h + 2 * kh) * d if next_qkv else 0)
    kw = dict(_jax_form(blk), n_heads=h, n_kv_heads=kh)
    caches = [(kc.clone(), vc.clone()) for _ in range(3)]
    view = (lambda t: t.view(b, s, kh * d)) if flat else (lambda t: t)
    before = fused_decode_layer.launches
    got = fused_decode_layer(qkv, resid, view(caches[0][0]),
                             view(caches[0][1]), ks, vs, pos, cos, sin, **kw)
    assert fused_decode_layer.launches == before + 1
    want = fused_decode_layer_torch(qkv, resid, view(caches[1][0]),
                                    view(caches[1][1]), ks, vs, pos, cos,
                                    sin, **kw)
    sol = sol_decode_layer(qkv, resid, *caches[2], ks, vs, pos, cos, sin,
                           n_heads=h, n_kv_heads=kh, **blk)
    torch.cuda.synchronize()
    assert got[-2].dim() == (3 if flat else 4)
    assert got[-2].data_ptr() == caches[0][0].data_ptr()
    for c in caches[1:]:
        assert torch.equal(caches[0][0], c[0]) and torch.equal(
            caches[0][1], c[1])
    n_out = 2 if next_qkv else 1
    for g, w, o in zip(got[:n_out], want[:n_out], sol[:n_out]):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g, w) < 2e-2
        assert torch.equal(g, o)


def test_fused_decode_layer_copies_no_weight(gen, monkeypatch):
    """The kernel gets pointers into the arrays passed: gate at w_gateup's
    start, up F columns on, both with a row stride of 2F."""
    b, s, h, kh, d, f, pos = 16, 256, 32, 8, 128, 14336, 100
    qkv, resid, kc, vc, ks, vs, cos, sin = _layer_inputs(gen, b, s, h, kh,
                                                         d, pos)
    blk = _block(gen, h * d, h * d, f, (h + 2 * kh) * d)
    seen = []
    launch = _build.launch

    def spy(name, *args):
        if name == "aimet_fused_layer":
            a = flay._Args.from_address(args[0])
            seen.append({n: getattr(a, n) for n in (
                "wo", "wg", "wu", "wd", "wq", "ld_gu", "F")})
        return launch(name, *args)

    monkeypatch.setattr(_build, "launch", spy)
    fused_decode_layer(qkv, resid, kc, vc, ks, vs, pos, cos, sin,
                       n_heads=h, n_kv_heads=kh, **_jax_form(blk))
    (a,) = seen
    wgu = blk["gateup_pair"][0]
    assert a["wg"] == wgu.data_ptr() and a["wu"] == wgu.data_ptr() + f
    assert a["ld_gu"] == 2 * f and a["F"] == f
    assert a["wo"] == blk["wo_pair"][0].data_ptr()
    assert a["wd"] == blk["down_pair"][0].data_ptr()
    assert a["wq"] == blk["next_qkv"][0][0].data_ptr()


def _gqa_flip_bound(q, kc, vc, ks, vs, pos):
    """v_scale * sum_s ulp_bf16(p_s) |v[s]|: the context's change when every
    prob's bf16 rounding moves by one ulp."""
    D = q.shape[-1]
    qs = q * (ks / D ** 0.5)[:, :, None, None].to(q.dtype)
    sc = torch.einsum("bkrd,bskd->bkrs", qs.float(), kc.float())
    live = torch.arange(kc.shape[1], device=q.device) <= pos
    p = torch.softmax(sc.masked_fill(~live, -1e30), -1)
    ulp = torch.where(p > 0, torch.exp2(torch.floor(torch.log2(
        p.clamp_min(1e-30))) - 7), torch.zeros_like(p))
    return torch.einsum("bkrs,bskd->bkrd", ulp,
                        vc.abs().float()) * vs[:, :, None, None]


@pytest.mark.parametrize("pos", [700, 0, -1, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gqa_attention_kernel_matches_plain(gen, dtype, pos):
    b, s, kh, rep, d = 16, 1024, 8, 4, 128
    _, _, kc, vc, ks, vs, _, _ = _layer_inputs(gen, b, s, kh * rep, kh, d,
                                               0)
    q = torch.randn((b, kh, rep, d), generator=gen, device="cuda").to(dtype)
    before = fused_gqa_decode_attention.launches
    got = fused_gqa_decode_attention(q, kc, vc, ks, vs, pos)
    assert fused_gqa_decode_attention.launches == before + 1
    want = fused_gqa_decode_attention_torch(q, kc, vc, ks, vs, pos)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == torch.float32:
        assert _rel(got, want) < 1e-4
    else:
        bound = _gqa_flip_bound(q, kc, vc, ks, vs, pos) \
            + 1e-4 * want.abs().max()
        assert ((got - want).abs() <= bound).all()
    assert torch.equal(fused_gqa_decode_attention(q, kc, vc, ks, vs, pos),
                       got)


def _kmajor(w_nk, pad=False):
    """(N, K) int8 -> the (K, N) transposed view the integer conv passes;
    ``pad``: rows padded to a multiple of 16 bytes first, as the conv does
    for K = 147."""
    if pad:
        n, k = w_nk.shape
        buf = torch.zeros((n, -(-k // 16) * 16), dtype=torch.int8,
                          device=w_nk.device)
        buf[:, :k] = w_nk
        w_nk = buf[:, :k]
    return w_nk.t()


@pytest.mark.parametrize("k", [147, 576, 1152])
@pytest.mark.parametrize("n", [64, 128, 2048])
@pytest.mark.parametrize("layout", ["kmajor", "nmajor"])
def test_q8_int32_entry_matches_plain_bit_for_bit(gen, k, n, layout):
    """KQ8's int32 entry at conv-patch K (147: ResNet-50's stem, padded
    rows), with a K-major transposed-view weight (TMA + wgmma route) or a
    contiguous N-major one (the mma.sync tile), ragged M."""
    m = 1000
    kp = -(-k // 16) * 16
    xbuf = torch.randint(-128, 128, (m, kp), dtype=torch.int8,
                         generator=gen, device="cuda")
    x = xbuf[:, :k]                              # padded rows, as im2col's
    w_nk = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=gen,
                         device="cuda")
    w = (_kmajor(w_nk, pad=k % 16 != 0) if layout == "kmajor"
         else w_nk.t().contiguous())
    before = tim.matmul_q8.launches
    got = tim.int8_matmul_int32(x, w)
    assert tim.matmul_q8.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, tim.int8_matmul_int32_torch(x, w))


@pytest.mark.parametrize("m,k,n", [(25088, 1152, 128), (401408, 147, 64),
                                   (1568, 4608, 512), (200, 4608, 512)])
def test_q8_int32_kmajor_at_resnet50_shapes(gen, m, k, n):
    """The K-major route at whole ResNet-50 conv shapes (32 images: more
    tiles than SMs, and layer4's 52 tiles, unsplit) and at a small-M call
    of 8 tiles (split K, integer atomics); repeated calls give the same
    bits."""
    kp = -(-k // 16) * 16
    x = torch.randint(-128, 128, (m, kp), dtype=torch.int8, generator=gen,
                      device="cuda")[:, :k]
    w_nk = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=gen,
                         device="cuda")
    w = _kmajor(w_nk, pad=k % 16 != 0)
    got = tim.int8_matmul_int32(x, w)
    assert torch.equal(got, tim.int8_matmul_int32_torch(x, w))
    assert torch.equal(tim.int8_matmul_int32(x, w), got)


@pytest.mark.parametrize("group", [8, 16, 24, 128])
@pytest.mark.parametrize("m", [16, 37, 300])
def test_w4_grouped_kernel_takes_any_group(gen, group, m):
    """KW4G at group sizes that are not multiples of 16 (8 meets two
    groups in a 16-wide k slice, 24 straddles slices) as well as 16 and
    128, on the decode route (M 16, 37) and the tile route (M 300)."""
    k, n = 768, 1024
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    packed, scales = tim.quantize_weight_int4_grouped(w, group)
    before = tim.matmul_w4_grouped.launches
    got = tim.matmul_w4_grouped(x, packed, scales, group_size=group)
    assert tim.matmul_w4_grouped.launches == before + 1
    want = tim.matmul_w4_grouped_torch(x, packed, scales, group)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert _rel(got, want) < 1e-2
    assert torch.equal(tim.matmul_w4_grouped(x, packed, scales,
                                             group_size=group), got)


_LONG_S, _LONG_POS = 16384, 16000


def test_decode_attention_kernel_at_long_cache(gen):
    """K3 at S = 16,384 (past the 12,352 whose score rows fit in shared
    memory at Llama-3-8B heads): KV bytes bit-exact after the append,
    output within 2e-2 of the max."""
    b, h, kh, d = 4, 32, 8, 128
    qkv, _, kc, vc, ks, vs, cos, sin = _layer_inputs(gen, b, _LONG_S, h, kh,
                                                     d, _LONG_POS)
    pos = torch.full((b,), _LONG_POS, dtype=torch.int32, device="cuda")
    pos[1] = _LONG_S - 1
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = fused_decode_attention(qkv, cos, sin, kc, vc, ks, vs, pos,
                                       n_heads=h, n_kv_heads=kh)
    ref, _, _ = fused_decode_attention_torch(qkv, cos, sin, kc2, vc2, ks, vs,
                                             pos, n_heads=h, n_kv_heads=kh)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert _rel(out, ref) < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gqa_attention_kernel_at_long_cache(gen, dtype):
    b, kh, rep, d = 2, 8, 4, 128
    _, _, kc, vc, ks, vs, _, _ = _layer_inputs(gen, b, _LONG_S, kh * rep,
                                               kh, d, 0)
    q = torch.randn((b, kh, rep, d), generator=gen, device="cuda").to(dtype)
    got = fused_gqa_decode_attention(q, kc, vc, ks, vs, _LONG_POS)
    want = fused_gqa_decode_attention_torch(q, kc, vc, ks, vs, _LONG_POS)
    if dtype == torch.float32:
        assert _rel(got, want) < 1e-4
    else:
        bound = _gqa_flip_bound(q, kc, vc, ks, vs, _LONG_POS) \
            + 1e-4 * want.abs().max()
        assert ((got - want).abs() <= bound).all()


def test_sol_decode_layer_kernel_at_long_cache(gen):
    """KSOL at S = 16,384 (past the 13,248 its 9 warps take in shared
    memory at Llama-3-8B heads): cache bytes bit-exact, output within 2e-2
    of the max."""
    b, h, kh, d, f = 4, 32, 8, 128, 5632
    qkv, resid, kc, vc, ks, vs, cos, sin = _layer_inputs(
        gen, b, _LONG_S, h, kh, d, _LONG_POS)
    kw = _block(gen, h * d, h * d, f, (h + 2 * kh) * d)
    kc2, vc2 = kc.clone(), vc.clone()
    got = sol_decode_layer(qkv, resid, kc, vc, ks, vs, _LONG_POS, cos, sin,
                           n_heads=h, n_kv_heads=kh, **kw)
    want = sol_decode_layer_torch(qkv, resid, kc2, vc2, ks, vs, _LONG_POS,
                                  cos, sin, n_heads=h, n_kv_heads=kh, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) < 2e-2


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 17, 32, 64])
def test_w8_decode_route_matches_plain(gen, m, out_dtype):
    """KW8's decode weight-streaming route (bf16 x, M <= 64) at every M
    tile, on N and K that are multiples of 16 but of no slice or stage
    (1296 = 5 x 256 + 16 columns, 1040 = 16 x 64 + 16 rows): within 1e-2
    of the plain version's max, the same bits on repeated calls."""
    k, n = 1040, 1296
    assert tim.w8_decode_route(m, n, k, torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    before = tim.matmul_w8.launches
    got = tim.matmul_w8(x, w, scale, out_dtype)
    assert tim.matmul_w8.launches == before + 1
    want = tim.matmul_w8_torch(x, w, scale, out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert _rel(got, want) < 1e-2
    for _ in range(3):
        assert torch.equal(tim.matmul_w8(x, w, scale, out_dtype), got)


@pytest.mark.parametrize("m", [1, 16, 33, 64])
def test_w8_decode_route_at_llama_widths(gen, m):
    """KW8's decode route at the w8 serving shapes (W_qkv and W_down of
    Llama-3-8B): slices split across blocks, summed by the block that
    brings the last piece."""
    for k, n in ((4096, 6144), (14336, 4096)):
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                          generator=gen, device="cuda")
        scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
        got = tim.matmul_w8(x, w, scale)
        assert _rel(got, tim.matmul_w8_torch(x, w, scale)) < 1e-2
        assert torch.equal(tim.matmul_w8(x, w, scale), got)


@pytest.mark.parametrize("int8_dots,next_qkv", [
    (False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("m", [1, 16, 33, 64])
def test_whole_layer_kernels_at_every_row_count(gen, m, int8_dots,
                                                next_qkv):
    """KSOL, KDL and KFL at M = 1, 16, 33 and 64 (every M tile of the
    decode streaming routine): within 2e-2 of their plain versions (6e-2
    with int8 dots), cache bytes bit-exact, KDL = KSOL bit for bit, and
    the same bits on a repeated launch."""
    s, h, kh, d, f, pos = 256, 16, 4, 128, 5632, 200
    qkv, resid, kc, vc, ks, vs, cos, sin = _layer_inputs(gen, m, s, h, kh,
                                                         d, pos)
    blk = _block(gen, h * d, h * d, f, (h + 2 * kh) * d if next_qkv else 0)
    kw = dict(n_heads=h, n_kv_heads=kh)
    caches = [(kc.clone(), vc.clone()) for _ in range(4)]
    got = sol_decode_layer(qkv, resid, *caches[0], ks, vs, pos, cos, sin,
                           int8_dots=int8_dots, **kw, **blk)
    again = sol_decode_layer(qkv, resid, *caches[1], ks, vs, pos, cos, sin,
                             int8_dots=int8_dots, **kw, **blk)
    want = sol_decode_layer_torch(qkv, resid, *caches[2], ks, vs, pos, cos,
                                  sin, int8_dots=int8_dots, **kw, **blk)
    torch.cuda.synchronize()
    n_out = 2 if next_qkv else 1
    for c in caches[1:3]:
        assert torch.equal(caches[0][0], c[0]) and torch.equal(
            caches[0][1], c[1])
    for g, a, w in zip(got[:n_out], again[:n_out], want[:n_out]):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g, w) < (6e-2 if int8_dots else 2e-2)
        assert torch.equal(g, a)
    if int8_dots:
        return
    kdl = fused_decode_layer(qkv, resid, *caches[3], ks, vs, pos, cos, sin,
                             **kw, **_jax_form(blk))
    for g, o in zip(kdl[:n_out], got[:n_out]):
        assert torch.equal(g, o)
    ao = torch.randn((m, h * d), generator=gen, device="cuda").to(
        torch.bfloat16)
    fkw = _jax_form(blk)
    fl = fused_wo_mlp(ao, resid, **fkw)
    fw = fused_wo_mlp_torch(ao, resid, **fkw)
    fl, fw = (fl, fw) if next_qkv else ((fl,), (fw,))
    for g, w in zip(fl, fw):
        assert _rel(g, w) < 2e-2


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 17, 32, 64])
def test_w4a8_decode_route_matches_plain(gen, m, out_dtype):
    """K2's decode weight-streaming route at every M tile, on N and K/2
    that are multiples of 16 but of no slice or stage (1296 = 5 x 256 + 16
    columns, 528 = 8 x 64 + 16 packed rows): bit-exact against the plain
    version, the same bits on repeated calls."""
    k2, n = 528, 1296
    assert tim.w4a8_decode_route(m, n, k2)
    x = torch.randn((m, 2 * k2), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randint(-128, 128, (k2, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    xq, sx = tim.quantize_activation_per_row(x)
    before = tim.w4a8_gemm.launches
    got = tim.w4a8_gemm(xq, sx, w, sw, out_dtype)
    assert tim.w4a8_gemm.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, tim.w4a8_gemm_torch(xq, sx, w, sw, out_dtype))
    for _ in range(3):
        assert torch.equal(tim.w4a8_gemm(xq, sx, w, sw, out_dtype), got)


@pytest.mark.parametrize("m,k2,n", [
    (16, 2048, 131072),      # lm_head at its padded vocabulary width
    (16, 7168, 4096),        # W_down: slices split across blocks
    (64, 2048, 6144),        # W_qkv at the largest M tile
])
def test_w4a8_decode_route_at_llama_widths(gen, m, k2, n):
    x = torch.randn((m, 2 * k2), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randint(-128, 128, (k2, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    got = tim.matmul_w4a8(x, w, sw)
    assert torch.equal(got, tim.matmul_w4a8_torch(x, w, sw))
    assert torch.equal(tim.matmul_w4a8(x, w, sw), got)


def _k3_case(gen, b, s, h, kh, d, pos, dtype=torch.bfloat16):
    """K3 and its plain version on the same inputs: KV bytes bit-exact,
    the output within 2e-2 of the max, a repeated launch (the row already
    appended) the same bits. Returns the relative error."""
    qkv, _, kc, vc, ks, vs, _, _ = _layer_inputs(gen, b, s, h, kh, d, 0)
    qkv = qkv.to(dtype)
    ang = pos.clamp(0, s).float()[:, None] * torch.rand(
        d // 2, generator=gen, device="cuda")
    cos, sin = torch.cos(ang), torch.sin(ang)
    kc2, vc2 = kc.clone(), vc.clone()
    before = fused_decode_attention.launches
    out, _, _ = fused_decode_attention(qkv, cos, sin, kc, vc, ks, vs, pos,
                                       n_heads=h, n_kv_heads=kh)
    assert fused_decode_attention.launches == before + 1
    ref, _, _ = fused_decode_attention_torch(qkv, cos, sin, kc2, vc2, ks, vs,
                                             pos, n_heads=h, n_kv_heads=kh)
    again, _, _ = fused_decode_attention(qkv, cos, sin, kc, vc, ks, vs, pos,
                                         n_heads=h, n_kv_heads=kh)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert out.dtype == dtype and torch.equal(out, again)
    err = _rel(out, ref)
    assert err < 2e-2, err
    return err


@pytest.mark.parametrize("h,kh,d", [(8, 8, 128), (32, 8, 128), (64, 8, 128),
                                    (32, 8, 64), (16, 2, 64), (8, 2, 40)],
                         ids=["rep1", "rep4", "rep8", "rep4-d64",
                              "rep8-d64", "rep4-d40"])
def test_split_attention_every_rep_and_head_dim(gen, h, kh, d):
    """rep 1, 4 and 8 at D 128 and 64, and D 40 (4-byte copies: rows of D
    % 16 != 0 bytes; dims padded to 64 for the MMAs)."""
    b, s = 4, 1000                    # S not a multiple of any chunk
    pos = torch.tensor([999, 0, 511, 640], dtype=torch.int32, device="cuda")
    _k3_case(gen, b, s, h, kh, d, pos)


@pytest.mark.parametrize("kind", ["scalar", "mixed", "outside", "negative"])
def test_split_attention_position_kinds(gen, kind):
    """Every position kind at B = 16, S = 1024 (the batcher's per-slot
    step): one position for every row, per-slot positions, positions >= S
    (nothing written, all rows attended) and negative ones (every row
    masked: the uniform average)."""
    b, s = 16, 1024
    if kind == "scalar":
        pos = torch.full((b,), 700, dtype=torch.int32, device="cuda")
    else:
        pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, s - 1
        if kind == "outside":
            pos[1], pos[2] = s, s + 7
        if kind == "negative":
            pos[1], pos[2] = -1, -5
    _k3_case(gen, b, s, 32, 8, 128, pos)


@pytest.mark.parametrize("b,s,dtype", [(1, 1024, torch.bfloat16),
                                       (1, 16384, torch.float32),
                                       (16, 16384, torch.bfloat16)])
def test_split_attention_one_row_and_long_cache(gen, b, s, dtype):
    """K3 at B = 1 (the fewest blocks) and at S = 16,384 (the most chunks),
    f32 and bf16 qkv."""
    pos = torch.full((b,), s - 384, dtype=torch.int32, device="cuda")
    pos[-1] = s - 1
    _k3_case(gen, b, s, 32, 8, 128, pos, dtype)


def _w4_operands(gen, m, k, n, dtype, mean=0.0):
    x = (torch.randn((m, k), generator=gen, device="cuda") + mean).to(dtype)
    w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                      generator=gen, device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    return x, w, scale


def _w4_route_case(m, k, n, x, w, scale, out_dtype, route):
    """matmul_w4 on the given operands: one launch on ``route``, within
    1e-2 of the plain version's max, the same bits on repeated calls."""
    before = tim.matmul_w4.routes[route]
    got = tim.matmul_w4(x, w, scale, out_dtype)
    assert tim.matmul_w4.routes[route] == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert _rel(got, tim.matmul_w4_torch(x, w, scale, out_dtype)) < 1e-2
    for _ in range(3):
        assert torch.equal(tim.matmul_w4(x, w, scale, out_dtype), got)
    return got


def _w4_tile_case(m, k, n, x, w, scale, out_dtype):
    """The tile on the given operands, checked as ``_w4_route_case`` does:
    through matmul_w4 where its route takes the tile; where the shape has
    too few output tiles for the route (matmul_w4 then takes the block
    tile, checked too), launched directly. Returns the tile's output."""
    if tim.w4_tile_route(m, n, k, x.dtype):
        return _w4_route_case(m, k, n, x, w, scale, out_dtype, "tile")
    want = tim.matmul_w4_torch(x, w, scale, out_dtype)
    before = dict(tim.matmul_w4.routes)
    assert _rel(tim.matmul_w4(x, w, scale, out_dtype), want) < 1e-2
    assert tim.matmul_w4.routes["bf_tile"] == before["bf_tile"] + 1
    launch = lambda: tim._launch_wo_tile(
        tim.matmul_w4, x, w, scale,
        torch.empty((m, n), dtype=out_dtype, device="cuda"))
    got = launch()
    assert tim.matmul_w4.routes["tile"] == before["tile"] + 1
    assert _rel(got, want) < 1e-2
    for _ in range(3):
        assert torch.equal(launch(), got)
    return got


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 33, 64])
def test_w4_decode_route_matches_plain(gen, m, out_dtype):
    """KW4's decode weight-streaming route at every M tile, on N and K/2
    that are multiples of 16 but of no slice or stage (1296 = 5 x 256 + 16
    columns, 528 = 8 x 64 + 16 packed rows), x of non-zero mean."""
    k, n = 1056, 1296
    assert tim.w4_decode_route(m, n, k, torch.bfloat16)
    x, w, scale = _w4_operands(gen, m, k, n, torch.bfloat16, mean=0.5)
    _w4_route_case(m, k, n, x, w, scale, out_dtype, "decode")


@pytest.mark.parametrize("m,k,n", [
    (16, 4096, 131072),      # the padded lm_head
    (1, 4096, 6144),         # layer 0's QKV
    (64, 14336, 4096),       # W_down: slices split across blocks
])
def test_w4_decode_route_at_llama_widths(gen, m, k, n):
    x, w, scale = _w4_operands(gen, m, k, n, torch.bfloat16)
    _w4_route_case(m, k, n, x, w, scale, torch.bfloat16, "decode")


def test_w4_tile_one_tile_exact(gen):
    """The tile on one 128 x 256 tile with small integer inputs, whose f32
    sums are exact: the bits of the plain version, so any slip of the
    fragment layouts, the nibble planes or the column permutation shows.
    (One tile is below the route's tile count: launched directly.)"""
    m, k, n = 128, 128, 256
    r = torch.arange(m, device="cuda")[:, None]
    c = torch.arange(k, device="cuda")[None, :]
    x = ((r * 7 + c * 3) % 11 - 5).to(torch.bfloat16)
    lo = (torch.arange(k // 2 * n, device="cuda").reshape(k // 2, n) % 16)
    hi = (torch.arange(k // 2 * n, device="cuda").reshape(k // 2, n) // 16
          + 5) % 16
    w = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    scale = torch.ones((n,), device="cuda")
    before = tim.matmul_w4.routes["tile"]
    got = tim._launch_wo_tile(tim.matmul_w4, x, w, scale, torch.empty(
        (m, n), dtype=torch.float32, device="cuda"))
    assert tim.matmul_w4.routes["tile"] == before + 1
    assert torch.equal(got, tim.matmul_w4_torch(x, w, scale, torch.float32))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (65, 4096, 4096),        # one row past decode M (16 tiles)
    (128, 2048, 6144),
    (300, 208, 272),         # ragged M, N; K/2 = 104: no whole stage
    (4096, 4096, 6144),      # prefill
    (65, 4096, 28672),       # one row past decode M, on the route
    (300, 208, 2832),        # ragged M, N; K/2 = 104, on the route
])
def test_w4_tile_matches_plain(gen, m, k, n, out_dtype):
    """KW4's TMA + wgmma tile on a bf16 x of non-zero mean (a nibble plane
    or x half slip shows as an offset)."""
    x, w, scale = _w4_operands(gen, m, k, n, torch.bfloat16, mean=0.5)
    _w4_tile_case(m, k, n, x, w, scale, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (65, 4096, 4096),
    (300, 200, 272),         # K/2 = 100: the pairs realign x's high half
    (4096, 4096, 128256),    # the lowered f32 lm_head's width
    (65, 4096, 8192),        # one row past decode M, on the route
])
def test_w4_tile_takes_f32_x(gen, m, k, n, out_dtype):
    """An f32 x on the tile: its bf16 pairs (high part, residual) keep the
    product within ~2^-16, so well inside 1e-2 (here 1e-4 of the max)."""
    x, w, scale = _w4_operands(gen, m, k, n, torch.float32, mean=0.5)
    got = _w4_tile_case(m, k, n, x, w, scale, out_dtype)
    if out_dtype == torch.float32:
        assert _rel(got, tim.matmul_w4_torch(x, w, scale, out_dtype)) < 1e-4


def test_w4_conv_at_resnet50_shape_takes_the_tile(gen):
    """conv2d_w4 at ResNet-50's layer-2 3 x 3 conv (patches 25,088 x
    1152, f32) runs on the tile."""
    x = torch.randn((32, 128, 28, 28), generator=gen, device="cuda")
    wq, s = tic.quantize_conv_weight_int4(
        torch.randn((128, 128, 3, 3), generator=gen, device="cuda") * 0.03)
    before = tim.matmul_w4.routes["tile"]
    got = tic.conv2d_w4(x, wq, s, (3, 3))
    assert tim.matmul_w4.routes["tile"] == before + 1
    want = tic._im2col_conv(tim.matmul_w4_torch, x, wq, s, (3, 3), (1, 1),
                            "SAME", None, None)
    assert _rel(got, want) < 1e-2


def test_w4_routes_refuse_short_buffers(gen):
    """The C entries check their buffers: a decode workspace or counter
    array shorter than the split needs, and an f32 pair workspace shorter
    than 2 M x pair_ld(K) bf16, are launch errors, not writes past them."""
    m, k, n = 16, 4096, 6144
    x, w, scale = _w4_operands(gen, m, k, n, torch.bfloat16)
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    plan = tim.decode_plan(m, n, k // 2, tim._sm_count(x.device))
    ws = torch.empty((plan.ws_values,), dtype=torch.float32, device="cuda")
    cnt = torch.zeros((plan.slices + 2,), dtype=torch.int32, device="cuda")
    stream = _build.stream_ptr(x.device)
    for ws_values, cnt_values in ((plan.ws_values - 1, plan.slices),
                                  (plan.ws_values, plan.slices - 1)):
        with pytest.raises(RuntimeError):
            _build.launch("aimet_w4_decode_gemm", x.data_ptr(), w.data_ptr(),
                          scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
                          cnt.data_ptr(), m, n, k, plan.blocks, ws_values,
                          cnt_values, 1, stream)
    m = 300
    xf, w, scale = _w4_operands(gen, m, k, n, torch.float32)
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    pairs = torch.empty((2 * m, tim.w4_pair_ld(k)), dtype=torch.bfloat16,
                        device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_w4_tile_gemm", xf.data_ptr(), w.data_ptr(),
                      scale.data_ptr(), out.data_ptr(), pairs.data_ptr(), m,
                      n, k, 1, 0, pairs.numel() * 2 - 2,
                      stream)
    torch.cuda.synchronize()
    assert torch.equal(cnt, torch.zeros_like(cnt))


def _w8_tile_case(m, k, n, x, w, scale, out_dtype):
    """KW8's TMA + wgmma tile on the given operands: through matmul_w8
    where its route takes the tile, else (too few output tiles: matmul_w8
    takes the block tile, checked too) launched directly; within 1e-2 of
    the plain version's max, the same bits on repeated calls. Returns the
    tile's output."""
    want = tim.matmul_w8_torch(x, w, scale, out_dtype)
    before = dict(tim.matmul_w8.routes)
    if tim.w8_tile_route(m, n, k, x.dtype):
        launch = lambda: tim.matmul_w8(x, w, scale, out_dtype)
    else:
        assert _rel(tim.matmul_w8(x, w, scale, out_dtype), want) < 1e-2
        assert tim.matmul_w8.routes["bf_tile"] == before["bf_tile"] + 1
        launch = lambda: tim._launch_wo_tile(
            tim.matmul_w8, x, w, scale,
            torch.empty((m, n), dtype=out_dtype, device="cuda"))
    t0 = tim.matmul_w8.routes["tile"]
    got = launch()
    assert tim.matmul_w8.routes["tile"] == t0 + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert _rel(got, want) < 1e-2
    for _ in range(3):
        assert torch.equal(launch(), got)
    return got


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (65, 4096, 4096),        # one row past decode M (16 tiles)
    (200, 4104, 272),        # ragged M, N; K = 4104: no whole stage
    (4096, 4096, 6144),      # prefill QKV
    (65, 4096, 28672),       # one row past decode M, on the route
    (300, 1032, 2832),       # ragged M, N, K on the route
])
def test_w8_tile_matches_plain(gen, m, k, n, out_dtype):
    """KW8's TMA + wgmma tile on a bf16 x of non-zero mean."""
    x = (torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    _w8_tile_case(m, k, n, x, w, scale, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (65, 4096, 4096),
    (300, 100, 272),         # K = 100: the pair rows pad to 104
    (4096, 4096, 128256),    # the lowered f32 lm_head's width
    (65, 4096, 8192),        # one row past decode M, on the route
])
def test_w8_tile_takes_f32_x(gen, m, k, n, out_dtype):
    """An f32 x on KW8's tile: its bf16 pairs (high part, residual) keep
    the product within ~2^-16, so with an f32 output within 1e-4 of the
    max."""
    x = torch.randn((m, k), generator=gen, device="cuda") + 0.5
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    scale = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    got = _w8_tile_case(m, k, n, x, w, scale, out_dtype)
    if out_dtype == torch.float32:
        assert _rel(got, tim.matmul_w8_torch(x, w, scale, out_dtype)) < 1e-4


def test_w8_tile_one_tile_exact(gen):
    """KW8's tile on one 128 x 256 tile of small integers (exact f32
    sums): the plain version's bits, so a slip of the fragment layout,
    the int8-to-bf16 unpack or the column permutation shows."""
    m, k, n = 128, 192, 256
    r = torch.arange(m, device="cuda")[:, None]
    c = torch.arange(k, device="cuda")[None, :]
    x = ((r * 7 + c * 3) % 11 - 5).to(torch.bfloat16)
    w = ((torch.arange(k * n, device="cuda").reshape(k, n) * 37) % 256
         - 128).to(torch.int8)
    scale = torch.ones((n,), device="cuda")
    got = tim._launch_wo_tile(tim.matmul_w8, x, w, scale, torch.empty(
        (m, n), dtype=torch.float32, device="cuda"))
    assert torch.equal(got, tim.matmul_w8_torch(x, w, scale, torch.float32))


def _w4a8_operands(gen, m, k2, n):
    x = torch.randn((m, 2 * k2), generator=gen, device="cuda") + 0.5
    xq, sx = tim.quantize_activation_per_row(x)
    wp = torch.randint(-128, 128, (k2, n), dtype=torch.int8, generator=gen,
                       device="cuda")
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    return xq, sx, wp, sw


def _w4a8_tile_case(xq, sx, wp, sw, out_dtype):
    """K2's tile bit-exact against w4a8_gemm_torch, through w4a8_gemm where
    its route takes the tile, else launched directly (w4a8_gemm's block
    tile checked too); repeated calls the same bits."""
    m, (k2, n) = xq.shape[0], wp.shape
    want = tim.w4a8_gemm_torch(xq, sx, wp, sw, out_dtype)
    if tim.w4a8_tile_route(m, n, k2):
        launch = lambda: tim.w4a8_gemm(xq, sx, wp, sw, out_dtype)
    else:
        before = tim.w4a8_gemm.routes["s8_tile"]
        assert torch.equal(tim.w4a8_gemm(xq, sx, wp, sw, out_dtype), want)
        assert tim.w4a8_gemm.routes["s8_tile"] == before + 1
        launch = lambda: tim._launch_w4a8_tile(
            xq, sx, wp, sw,
            torch.empty((m, n), dtype=out_dtype, device="cuda"))
    t0 = tim.w4a8_gemm.routes["tile"]
    got = launch()
    assert tim.w4a8_gemm.routes["tile"] == t0 + 1
    assert torch.equal(got, want)
    for _ in range(3):
        assert torch.equal(launch(), got)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [65, 200, 4096])
def test_w4a8_tile_bit_exact_at_ragged_m(gen, m, out_dtype):
    """K2's TMA + wgmma tile at ragged M, with N and K/2 that fill no
    whole tile or stage (N = 2832: 11 tiles + 16 columns; K/2 = 1040: 8
    stages + 16 packed rows, whose rows past K/2 unpack to 0)."""
    _w4a8_tile_case(*_w4a8_operands(gen, m, 1040, 2832), out_dtype)


@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 4096), (4096, 28672),
                                 (14336, 4096), (4096, 128256)],
                         ids=["qkv", "o", "gate_up", "down", "lm_head"])
def test_w4a8_tile_bit_exact_at_llama_shapes(gen, k, n):
    """K2's tile at each Llama-3-8B layer shape and the lm_head, M = 512
    (a prefill wave), bf16 out."""
    _w4a8_tile_case(*_w4a8_operands(gen, 512, k // 2, n), torch.bfloat16)


def test_w4a8_tile_one_tile_exact(gen):
    """K2's tile on one 128 x 256 tile, unit scales: integer sums exact in
    f32, so the plain version's bits, and a slip of the s8 fragment
    layout, the nibble planes, the byte transpose or the column
    permutation shows."""
    m, k2, n = 128, 128, 256
    r = torch.arange(m, device="cuda")[:, None]
    c = torch.arange(2 * k2, device="cuda")[None, :]
    xq = ((r * 7 + c * 3) % 255 - 127).to(torch.int8)
    lo = (torch.arange(k2 * n, device="cuda").reshape(k2, n) % 16)
    hi = (torch.arange(k2 * n, device="cuda").reshape(k2, n) // 16 + 5) % 16
    wp = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    ones_m = torch.ones((m,), device="cuda")
    ones_n = torch.ones((n,), device="cuda")
    got = tim._launch_w4a8_tile(xq, ones_m, wp, ones_n, torch.empty(
        (m, n), dtype=torch.float32, device="cuda"))
    want = tim.int8_matmul_int32_torch(xq, tim.unpack_int4(wp)).float()
    assert torch.equal(got, want)


def test_tile_routes_refuse_misaligned_operands(gen):
    """The tiles' C entries refuse what their TMA boxes cannot map (K2:
    K/2 % 16; KW8: a bf16 x's rows not 16 bytes; an f32 pair workspace
    short of 2 M x pair_ld_w8(K)): launch errors, not hangs or writes past
    the buffers."""
    stream = _build.stream_ptr(torch.device("cuda"))
    m, k2, n = 200, 1032, 512
    xq = torch.zeros((m, 2 * k2), dtype=torch.int8, device="cuda")
    sx = torch.ones((m,), device="cuda")
    wp = torch.zeros((k2, n), dtype=torch.int8, device="cuda")
    sw = torch.ones((n,), device="cuda")
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_w4a8_tile_gemm", xq.data_ptr(), sx.data_ptr(),
                      wp.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, k2,
                      0, stream)
    k = 4100
    x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((k, n), dtype=torch.int8, device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_w8_tile_gemm", x.data_ptr(), w.data_ptr(),
                      sw.data_ptr(), out.data_ptr(), out.data_ptr(), m, n, k,
                      0, 0, 0, stream)
    xf = torch.zeros((m, k), device="cuda")
    pairs = torch.empty((2 * m, tim.w8_pair_ld(k)), dtype=torch.bfloat16,
                        device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_w8_tile_gemm", xf.data_ptr(), w.data_ptr(),
                      sw.data_ptr(), out.data_ptr(), pairs.data_ptr(), m, n,
                      k, 1, 0, pairs.numel() * 2 - 2, stream)
    torch.cuda.synchronize()


_SQ_ENC = dict(inv_delta=1 / 0.0317, offset=-131.0, num_steps=255.0)


def _staticq_operands(gen, m, k, n, x_dtype):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 2).to(x_dtype)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sv = torch.rand((n,), generator=gen, device="cuda") * 1e-4
    cb = torch.randn((n,), generator=gen, device="cuda")
    return x, w, sv, cb


def _staticq_tile_case(x, w, sv, cb, out_dtype):
    """KSQ's TMA + wgmma tile bit-exact against its plain version, codes
    and outputs: through matmul_w8a8_staticq where its route takes the
    tile, else launched directly on the plain codes (the wrapper's block
    tile checked too); repeated calls the same bits."""
    (m, k), n = x.shape, w.shape[1]
    kw = dict(_SQ_ENC, out_dtype=out_dtype, return_codes=True)
    want, pq = tim.matmul_w8a8_staticq_torch(x, w, sv, cb, **kw)
    before = dict(tim.matmul_w8a8_staticq.routes)
    if tim.w8a8_staticq_tile_route(m, n, k):
        def launch():
            got, q = tim.matmul_w8a8_staticq(x, w, sv, cb, **kw)
            assert torch.equal(q, pq)
            return got
    else:
        got, q = tim.matmul_w8a8_staticq(x, w, sv, cb, **kw)
        assert torch.equal(q, pq) and torch.equal(got, want)
        assert (tim.matmul_w8a8_staticq.routes["s8_tile"]
                == before["s8_tile"] + 1)
        before = dict(tim.matmul_w8a8_staticq.routes)
        launch = lambda: tim._launch_staticq_tile(
            pq, w, sv, cb, torch.empty((m, n), dtype=out_dtype,
                                       device="cuda"))
    got = launch()
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert tim.matmul_w8a8_staticq.routes["tile"] == (
        before["tile"] + tim.w8a8_staticq_tile_route(m, n, k))
    for _ in range(3):
        assert torch.equal(launch(), got)


@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("m,k,n", [
    (65, 4096, 6144),        # one row past decode M, on the route
    (200, 4112, 2832),       # ragged M, N; K: 32 stages + 16 rows
    (4096, 4096, 4096),      # the lowered forward's linears
    (4096, 4096, 1024),
    (4096, 14336, 4096),
    (65, 4096, 1024),        # 4 tiles: launched directly
])
def test_staticq_tile_bit_exact(gen, m, k, n, x_dtype, out_dtype):
    _staticq_tile_case(*_staticq_operands(gen, m, k, n, x_dtype), out_dtype)


def test_staticq_tile_at_the_f32_lm_head_cut_in_m(gen):
    """KSQ's tile at the lowered model's f32 lm_head (4096 x 128256), M
    cut to 512."""
    _staticq_tile_case(*_staticq_operands(gen, 512, 4096, 128256,
                                          torch.float32), torch.float32)


def test_staticq_tile_one_tile_exact(gen):
    """KSQ's tile on one 128 x 256 tile of small integers, unit scales and
    zero biases: the int32 sums themselves, so a wrong transposed A
    fragment or column permutation shows as a wrong bit."""
    m, k, n = 128, 256, 256
    r = torch.arange(m, device="cuda")[:, None]
    c = torch.arange(k, device="cuda")[None, :]
    xq = ((r * 7 + c * 3) % 255 - 127).to(torch.int8)
    w = ((torch.arange(k * n, device="cuda").reshape(k, n) * 37) % 23
         - 11).to(torch.int8)
    got = tim._launch_staticq_tile(
        xq, w, torch.ones((n,), device="cuda"),
        torch.zeros((n,), device="cuda"),
        torch.empty((m, n), dtype=torch.float32, device="cuda"))
    assert torch.equal(got, tim.int8_matmul_int32_torch(xq, w).float())


# KW4G's tile with an f32 x and an f32 output, max |diff| / max |plain|:
# no worse than the block tile it replaces at the same shape (both take x
# as a bf16 high part and residual; measured on the H100 at M = 4096 and
# the lowered forward's linears: the block tile <= 4.96e-6, the tile
# <= 5.03e-6)
W4G_F32_TOL = 1e-5


def _w4g_operands(gen, m, k, n, group, x_dtype):
    x = torch.randn((m, k), generator=gen, device="cuda").to(x_dtype)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    packed, scales = tim.quantize_weight_int4_grouped(w, group)
    return x, packed, scales


def _w4g_tile_case(x, packed, scales, group, out_dtype, tol=1e-2):
    """KW4G's TMA + wgmma tile within ``tol`` of its plain version's max:
    through matmul_w4_grouped where its route takes the tile, else
    launched directly (the wrapper's block tile checked too); repeated
    calls the same bits. Returns (the tile's output, its error)."""
    (m, k), n = x.shape, packed.shape[1]
    want = tim.matmul_w4_grouped_torch(x, packed, scales, group, out_dtype)
    before = dict(tim.matmul_w4_grouped.routes)
    if tim.w4g_tile_route(m, n, k, group, x.dtype):
        launch = lambda: tim.matmul_w4_grouped(
            x, packed, scales, group_size=group, out_dtype=out_dtype)
    else:
        assert _rel(tim.matmul_w4_grouped(x, packed, scales,
                                          group_size=group,
                                          out_dtype=out_dtype), want) < 1e-2
        assert (tim.matmul_w4_grouped.routes["bf_tile"]
                == before["bf_tile"] + 1)
        before = dict(tim.matmul_w4_grouped.routes)
        launch = lambda: tim._launch_w4g_tile(
            x, packed, scales,
            torch.empty((m, n), dtype=out_dtype, device="cuda"), group)
    got = launch()
    assert tim.matmul_w4_grouped.routes["tile"] == before["tile"] + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    err = _rel(got, want)
    assert err < tol
    for _ in range(3):
        assert torch.equal(launch(), got)
    return got, err


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("m,k,n", [
    (300, 4096, 4096),       # ragged M
    (65, 4608, 2832),        # one row past decode M; N: 22 tiles + 16
    (4096, 4096, 1024),      # the lowered forward's k / v
])
def test_w4g_tile_matches_plain(gen, m, k, n, group, out_dtype):
    """KW4G's tile on a bf16 x within 1e-2 of the plain version's max, at
    groups of one, two and four stages."""
    _w4g_tile_case(*_w4g_operands(gen, m, k, n, group, torch.bfloat16),
                   group, out_dtype)


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (4096, 14336, 4096),
                                   (300, 4096, 14336), (65, 384, 272)])
def test_w4g_tile_takes_f32_x_no_worse_than_the_block_tile(gen, m, k, n):
    """An f32 x with an f32 output (the lowered model's linears): the tile
    within W4G_F32_TOL of the plain version's max, and within the block
    tile's own error at the same shape (doubled: two f32 sums in another
    order); K = 384 with group 64: three stages, a tile of 65 rows."""
    group = 64 if k == 384 else 128
    x, packed, scales = _w4g_operands(gen, m, k, n, group, torch.float32)
    want = tim.matmul_w4_grouped_torch(x, packed, scales, group)
    block = tim._launch_bf_tile(
        "aimet_w4g_gemm", tim.matmul_w4_grouped, x, packed, scales,
        torch.empty((m, n), device="cuda"), group)
    got, err = _w4g_tile_case(x, packed, scales, group, torch.float32,
                              W4G_F32_TOL)
    assert err <= 2 * _rel(block, want) + 1e-7


def test_w4g_tile_one_tile_exact(gen):
    """KW4G's tile on one 128 x 128 tile of small integers, scales powers
    of two that differ by group, column and plane (exact f32 sums): the
    plain version's bits, so a slip of the fragment layout, the nibble
    planes, the column permutation or a plane's group scale shows."""
    m, k, n, group = 128, 512, 128, 64
    r = torch.arange(m, device="cuda")[:, None]
    c = torch.arange(k, device="cuda")[None, :]
    x = ((r * 7 + c * 3) % 11 - 5).to(torch.bfloat16)
    lo = torch.arange(k // 2 * n, device="cuda").reshape(k // 2, n) % 16
    hi = (torch.arange(k // 2 * n, device="cuda").reshape(k // 2, n) // 16
          + 5) % 16
    wp = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    gi = torch.arange(k // group, device="cuda")[:, None]
    ci = torch.arange(n, device="cuda")[None, :]
    scales = torch.exp2(-((gi * 3 + ci) % 5).float())
    got = tim._launch_w4g_tile(x, wp, scales, torch.empty(
        (m, n), dtype=torch.float32, device="cuda"), group)
    want = tim.matmul_w4_grouped_torch(x, wp, scales, group, torch.float32)
    assert torch.equal(got, want)


def test_new_tiles_refuse_what_they_cannot_map(gen):
    """KSQ's tile refuses K % 16 (its codes' TMA boxes), KW4G's a group
    that is not whole 64-row stages: launch errors, not hangs."""
    stream = _build.stream_ptr(torch.device("cuda"))
    m, k, n = 200, 4104, 512
    xq = torch.zeros((m, k), dtype=torch.int8, device="cuda")
    w = torch.zeros((k, n), dtype=torch.int8, device="cuda")
    sv = torch.ones((n,), device="cuda")
    out = torch.empty((m, n), device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_staticq_tile_gemm", xq.data_ptr(), w.data_ptr(),
                      sv.data_ptr(), sv.data_ptr(), out.data_ptr(), m, n, k,
                      0, stream)
    k = 4096
    x = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
    wp = torch.zeros((k // 2, n), dtype=torch.int8, device="cuda")
    gs = torch.ones((k // 32, n), device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_w4g_tile_gemm", x.data_ptr(), wp.data_ptr(),
                      gs.data_ptr(), out.data_ptr(), out.data_ptr(), m, n, k,
                      32, 0, 0, 0, stream)
    torch.cuda.synchronize()


def _q8_operands(gen, m, k, n):
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen,
                       device="cuda")
    sx = torch.rand((m,), generator=gen, device="cuda") * 1e-2
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sw = (torch.rand((n,), generator=gen, device="cuda") + 0.5) * 2e-3
    cb = torch.randn((n,), generator=gen, device="cuda")
    return xq, sx, w, sw, cb


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (65, 4096, 6144),        # one row past decode M, on the route
    (200, 4112, 2832),       # ragged M, N; K: 32 stages + 16 rows
    (4096, 14336, 4096),     # q8_gemm[w_down]
    (25088, 1152, 128),      # ResNet-50's 3 x 3 conv patches
    (65, 4096, 1024),        # 4 tiles: launched directly
])
def test_q8_tile_bit_exact(gen, m, k, n, out_dtype, bias):
    """KQ8's TMA + wgmma tile bit-exact against matmul_q8_torch: through
    matmul_q8 where its route takes the tile, else launched directly (the
    wrapper's block tile checked too); repeated calls the same bits."""
    xq, sx, w, sw, cb = _q8_operands(gen, m, k, n)
    cb = cb if bias else None
    want = tim.matmul_q8_torch(xq, sx, w, sw, cb, out_dtype)
    before = dict(tim.matmul_q8.routes)
    if tim.q8_tile_route(m, n, k):
        launch = lambda: tim.matmul_q8(xq, sx, w, sw, cb, out_dtype)
    else:
        assert torch.equal(tim.matmul_q8(xq, sx, w, sw, cb, out_dtype), want)
        assert tim.matmul_q8.routes["s8_tile"] == before["s8_tile"] + 1
        before = dict(tim.matmul_q8.routes)
        launch = lambda: tim._launch_q8_tile(
            xq, sx, w, sw, cb,
            torch.empty((m, n), dtype=out_dtype, device="cuda"))
    got = launch()
    assert tim.matmul_q8.routes["tile"] == before["tile"] + 1
    assert got.dtype == out_dtype and torch.equal(got, want)
    for _ in range(3):
        assert torch.equal(launch(), got)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_fusedq_takes_the_q8_tile(gen, x_dtype):
    """KW8A8 (K1 + KQ8) at 4096 x 28672 on KQ8's tile: bit-exact."""
    x = (torch.randn((4096, 4096), generator=gen, device="cuda") * 2).to(
        x_dtype)
    w = torch.randint(-127, 128, (4096, 28672), dtype=torch.int8,
                      generator=gen, device="cuda")
    sw = (torch.rand((28672,), generator=gen, device="cuda") + 0.5) * 2e-3
    before = tim.matmul_q8.routes["tile"]
    got = tim.matmul_w8a8(x, w, sw)
    assert tim.matmul_q8.routes["tile"] == before + 1
    assert got.dtype == x_dtype
    assert torch.equal(got, tim.matmul_w8a8_torch(x, w, sw))


def test_q8_tile_one_tile_exact(gen):
    """KQ8's tile on one 128 x 256 tile of small integers, unit scales:
    the int32 sums themselves, so a wrong fragment or column shows."""
    m, k, n = 128, 256, 256
    r = torch.arange(m, device="cuda")[:, None]
    c = torch.arange(k, device="cuda")[None, :]
    xq = ((r * 5 + c * 3) % 255 - 127).to(torch.int8)
    w = ((torch.arange(k * n, device="cuda").reshape(k, n) * 37) % 23
         - 11).to(torch.int8)
    one_m, one_n = (torch.ones((d,), device="cuda") for d in (m, n))
    got = tim._launch_q8_tile(xq, one_m, w, one_n, None, torch.empty(
        (m, n), dtype=torch.float32, device="cuda"))
    assert torch.equal(got, tim.int8_matmul_int32_torch(xq, w).float())


def test_q8_tile_refuses_what_it_cannot_map(gen):
    """KQ8's tile entry refuses K % 16 (its codes' TMA boxes) and a
    misaligned column bias: launch errors, not hangs."""
    stream = _build.stream_ptr(torch.device("cuda"))
    m, k, n = 200, 4104, 512
    xq = torch.zeros((m, k), dtype=torch.int8, device="cuda")
    w = torch.zeros((k, n), dtype=torch.int8, device="cuda")
    v = torch.ones((n + 4,), device="cuda")
    out = torch.empty((m, n), device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("aimet_q8_tile_gemm", xq.data_ptr(), v.data_ptr(),
                      w.data_ptr(), v.data_ptr(), 0, out.data_ptr(), m, n, k,
                      0, stream)
    k = 4096
    xq, w = xq[:, :k].contiguous(), w[:k].contiguous()
    with pytest.raises(RuntimeError):
        _build.launch("aimet_q8_tile_gemm", xq.data_ptr(), v.data_ptr(),
                      w.data_ptr(), v.data_ptr(), v[1:].data_ptr(),
                      out.data_ptr(), m, n, k, 0, stream)
    torch.cuda.synchronize()


@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("m,k2,n", [
    (1, 2048, 6144),         # one row: layer 0's QKV width
    (16, 2048, 28672),       # the per-slot step's gate|up
    (17, 528, 1296),         # ragged M; no whole slice or stage
    (33, 7168, 4096),        # W_down: slices split across blocks
    (64, 2048, 131072),      # the padded lm_head at the last M tile
])
def test_w4a8_fusedq_decode_bit_exact(gen, m, k2, n, x_dtype, out_dtype):
    """K2's fused decode kernel: one launch (no K1, no K2 launch), codes
    and scales K1's, the output K2's decode route's on them and the plain
    version's, bit for bit; repeated calls the same bits."""
    x = (torch.randn((m, 2 * k2), generator=gen, device="cuda") * 3).to(
        x_dtype)
    x[0, : min(8, 2 * k2)] = 0.0
    w = torch.randint(-128, 128, (k2, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    counts = lambda: (tim.matmul_w4a8_fusedq.launches,
                      tim.quantize_activation_per_row.launches,
                      tim.w4a8_gemm.launches)
    before = counts()
    got, q, s = tim.matmul_w4a8_fusedq(x, w, sw, out_dtype=out_dtype,
                                       return_codes=True)
    assert counts() == (before[0] + 1, before[1], before[2])
    k1q, k1s = tim.quantize_activation_per_row(x)
    assert torch.equal(q, k1q) and torch.equal(s, k1s)
    assert got.dtype == out_dtype
    assert torch.equal(got, tim.w4a8_gemm(k1q, k1s, w, sw, out_dtype))
    assert torch.equal(got, tim.matmul_w4a8_torch(x, w, sw, out_dtype))
    for _ in range(3):
        again, q2, s2 = tim.matmul_w4a8_fusedq(x, w, sw, out_dtype=out_dtype,
                                               return_codes=True)
        assert torch.equal(again, got) and torch.equal(q2, q)
        assert torch.equal(s2, s)


def test_w4a8_fusedq_off_the_route_is_k1_then_k2(gen):
    """A ragged N (the route needs N % 16) and M = 65 keep K1 + K2: the
    same bits as the plain version, no fused launch."""
    for m, k2, n in ((16, 1024, 1000), (65, 2048, 4096)):
        x = torch.randn((m, 2 * k2), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randint(-128, 128, (k2, n), dtype=torch.int8,
                          generator=gen, device="cuda")
        sw = torch.rand((n,), generator=gen, device="cuda") * 1e-3
        before = (tim.matmul_w4a8_fusedq.launches,
                  tim.quantize_activation_per_row.launches)
        assert torch.equal(tim.matmul_w4a8_fusedq(x, w, sw),
                           tim.matmul_w4a8_torch(x, w, sw))
        assert (tim.matmul_w4a8_fusedq.launches,
                tim.quantize_activation_per_row.launches) == (
                    before[0], before[1] + 1)


def test_w4a8_fusedq_refuses_what_it_cannot_take(gen):
    """The fused entry refuses a grid that cannot be resident at once (two
    blocks an SM of 220 KB), operands its boxes cannot map (K/2 % 16) and
    a misaligned x: launch errors, never a hang or a fallback."""
    stream = _build.stream_ptr(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, k2, n = 16, 2048, 4096
    x = torch.zeros((m, 2 * k2 + 8), dtype=torch.bfloat16, device="cuda")
    xq = torch.empty((m, 2 * k2), dtype=torch.int8, device="cuda")
    sx = torch.empty((m,), device="cuda")
    w = torch.zeros((k2, n), dtype=torch.int8, device="cuda")
    sw = torch.ones((n,), device="cuda")
    out = torch.empty((m, n), device="cuda")
    blocks = 2 * sms + 1
    plan = tim.decode_plan(m, n, k2, blocks)
    ws = torch.empty(((plan.slices + blocks) * m * 256,), dtype=torch.int32,
                     device="cuda")
    cnt = torch.zeros((plan.slices + 2,), dtype=torch.int32, device="cuda")

    def launch(xp, k2_, grid):
        _build.launch("aimet_w4a8_fusedq_decode_gemm", xp, xq.data_ptr(),
                      sx.data_ptr(), w.data_ptr(), sw.data_ptr(),
                      out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), m, n,
                      k2_, grid, ws.numel(), cnt.numel(), 1, 0, stream)
    with pytest.raises(RuntimeError):
        launch(x.data_ptr(), k2, blocks)
    with pytest.raises(RuntimeError):
        launch(x.data_ptr(), k2 - 8, sms)
    with pytest.raises(RuntimeError):
        launch(x[:, 1:].data_ptr(), k2, sms)
    with pytest.raises(RuntimeError):             # no room for the counts
        _build.launch("aimet_w4a8_fusedq_decode_gemm", x.data_ptr(),
                      xq.data_ptr(), sx.data_ptr(), w.data_ptr(),
                      sw.data_ptr(), out.data_ptr(), ws.data_ptr(),
                      cnt.data_ptr(), m, n, k2, sms, ws.numel(),
                      plan.slices + 1, 1, 0, stream)
    torch.cuda.synchronize()
    launch(x.data_ptr(), k2, tim.decode_plan(m, n, k2, sms).blocks)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    assert not cnt.any()                          # the counts left 0


def _k1_check(x):
    """K1 on x against its plain version, codes and scales bit for bit,
    and on a repeated call; returns the route it took."""
    before = dict(tim.quantize_activation_per_row.routes)
    q, s = tim.quantize_activation_per_row(x)
    took = [r for r, n in tim.quantize_activation_per_row.routes.items()
            if n != before[r]]
    pq, ps = tim._quantize_activation_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    q2, s2 = tim.quantize_activation_per_row(x)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    return took[0]


@pytest.mark.parametrize("k", [1, 8, 64, 147, 576, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_act_quant_bit_exact_at_every_row_width(gen, k, dtype):
    """K1 at K = 1 .. 4096 on both of its kernels: M = 300 leaves a
    partial last block of rows on the narrow rows' kernel."""
    x = (torch.randn((300, k), generator=gen, device="cuda") * 3).to(dtype)
    route = _k1_check(x)
    assert route == ("narrow" if tim.act_quant_plan(k, dtype) else "wide")


@pytest.mark.parametrize("m,k", [(1, 147), (23, 64), (1000, 147),
                                 (517, 576), (65, 9)])
def test_act_quant_rows_not_a_multiple_of_the_block(gen, m, k):
    """M not a multiple of the narrow kernel's rows a block (nor of its
    groups of lanes), K whose rows are not 16-byte aligned."""
    lanes, rows = tim.act_quant_plan(k, torch.float32)
    assert m % rows
    _k1_check(torch.randn((m, k), generator=gen, device="cuda"))


@pytest.mark.parametrize("k", [64, 147, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_act_quant_takes_odd_offsets_and_zero_rows(gen, k, dtype):
    """A contiguous (M, K) view one element into its buffer (no row 16-byte
    aligned, nor the codes' span), with all-zero rows: their scale is the
    1e-8 floor over 127 and their codes 0."""
    m = 200
    buf = (torch.randn((m * k + 1,), generator=gen, device="cuda")
           * 3).to(dtype)
    x = buf[1:].view(m, k)
    x[::7] = 0
    _k1_check(x)
    q, s = tim.quantize_activation_per_row(x)
    floor = (torch.tensor(1e-8) / torch.tensor(127.0)).item()
    assert not q[::7].any()
    assert torch.equal(s[::7], torch.full_like(s[::7], floor))


@pytest.mark.parametrize("s,chunk", [(1, 64), (100, 32), (1024, 128),
                                     (4097, 256), (1500, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gqa_attention_split_every_chunk_count(gen, dtype, s, chunk):
    """KGQA's split across one to 24 chunks: within its tolerances of the
    plain version at positions -1, 0, on a chunk's last and first rows,
    the cache's last row and past S, repeating its bits."""
    from aimet_tpu_torch.ops import decode_attention as dgqa
    b, kh, rep, d = 3, 8, 4, 128
    _, _, kc, vc, ks, vs, _, _ = _layer_inputs(gen, b, s, kh * rep, kh, d,
                                               0)
    q = torch.randn((b, kh, rep, d), generator=gen, device="cuda").to(dtype)
    for pos in sorted({-1, 0, chunk - 1, chunk, s - 1, s + 3}):
        got = dgqa._launch_gqa(q, kc, vc, ks, vs, pos, chunk)
        want = fused_gqa_decode_attention_torch(q, kc, vc, ks, vs, pos)
        if dtype == torch.float32:
            assert _rel(got, want) < 1e-4, pos
        else:
            bound = _gqa_flip_bound(q, kc, vc, ks, vs, pos) \
                + 1e-4 * want.abs().max()
            assert ((got - want).abs() <= bound).all(), pos
        assert torch.equal(dgqa._launch_gqa(q, kc, vc, ks, vs, pos, chunk),
                           got)


def test_gqa_attention_refuses_a_short_workspace(gen):
    """KGQA's C entry refuses a chunk it does not take and a workspace or
    counters shorter than its grid needs."""
    from aimet_tpu_torch.ops import decode_attention as dgqa
    b, s, kh, rep, d, chunk = 2, 300, 8, 4, 128, 128
    _, _, kc, vc, ks, vs, _, _ = _layer_inputs(gen, b, s, kh * rep, kh, d,
                                               0)
    q = torch.randn((b, kh, rep, d), generator=gen, device="cuda")
    out = torch.empty_like(q)
    need = dgqa.gqa_workspace_floats(b, kh, rep, d, s, chunk)
    ws = torch.empty((need,), device="cuda")
    cnt = torch.zeros((b * kh,), dtype=torch.int32, device="cuda")

    def launch(ch, ws_values, cnt_values):
        _build.launch("aimet_gqa_attention", q.data_ptr(), kc.data_ptr(),
                      vc.data_ptr(), ks.data_ptr(), vs.data_ptr(), 5,
                      out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, s,
                      kh, rep, d, ch, ws_values, cnt_values, 11.3137, 0,
                      _build.stream_ptr(q.device))
    for args in ((chunk, need - 1, b * kh), (chunk, need, b * kh - 1),
                 (48, need, b * kh), (512, need, b * kh)):
        with pytest.raises(RuntimeError):
            launch(*args)
    launch(chunk, need, b * kh)
    torch.cuda.synchronize()
    assert not cnt.any()                          # the counters left 0
