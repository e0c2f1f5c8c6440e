"""KW8's (``matmul_w8``), K2's (``w4a8_gemm``, and its fused decode
kernel under ``matmul_w4a8_fusedq``) and KQ8's (``matmul_q8``) routes:
which shapes take the decode weight-streaming route, which the TMA +
``wgmma`` tile and which the ``mma.sync`` block tile (``bf_tile`` /
``s8_tile``). The kernels
run only on the card (``test_torch_cuda_kernels.py``); here the routes are
pure shape logic, and the plain versions, which carry the arithmetic, are
held against the JAX package in ``test_torch_weight_only.py`` and
``test_torch_int_matmul.py``.
"""
import os
import subprocess
import sys

import pytest
import torch

from aimet_tpu_torch.ops import int_matmul as tim


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (4096, 28672, 4096, torch.bfloat16, True),   # the prefill's gate|up
    (4096, 6144, 4096, torch.bfloat16, True),    # QKV
    (4096, 4096, 14336, torch.bfloat16, True),   # down
    (4096, 128256, 4096, torch.float32, True),   # a lowered f32 lm_head
    (65, 28672, 4096, torch.bfloat16, True),     # just above decode M
    (64, 28672, 4096, torch.bfloat16, False),    # the decode route's
    (0, 4096, 4096, torch.bfloat16, False),
    (300, 4104, 4096, torch.bfloat16, False),    # N % 16: the block tile
    (300, 4096, 4100, torch.bfloat16, False),    # bf16 rows not 16 bytes
    (300, 4096, 4104, torch.bfloat16, True),     # int8 weights: rows only
    (300, 4096, 4100, torch.float32, True),      # f32 rows 16 bytes
    (300, 4096, 4098, torch.float32, False),     # f32 rows not 16 bytes
    (25088, 128, 1152, torch.float32, True),     # conv2d_w8's patches
    (401408, 64, 147, torch.float32, False),     # the stem's K = 147
    (300, 4096, 4096, torch.float16, False),
])
def test_w8_tile_route_edges(m, n, k, dtype, want):
    assert tim.w8_tile_route(m, n, k, dtype) is want


@pytest.mark.parametrize("m,n,k2,want", [
    (4096, 28672, 2048, True),                   # the prefill's gate|up
    (4096, 131072, 2048, True),                  # the padded lm_head
    (4096, 4096, 7168, True),                    # down
    (65, 28672, 2048, True),                     # just above decode M
    (64, 28672, 2048, False),                    # the decode route's
    (0, 28672, 2048, False),
    (300, 4104, 2048, False),                    # N % 16
    (300, 4096, 2056, False),                    # K/2 % 16: x's high half
    (300, 4096, 2064, True),
    (37, 1000, 72, False),                       # ragged: the block tile
])
def test_w4a8_tile_route_edges(m, n, k2, want):
    assert tim.w4a8_tile_route(m, n, k2) is want


def test_the_tile_counts_of_each_route_decide():
    """Right at each route's tile count the tile takes over from the block
    tile, at every layer width (the count, not M, decides: the tile never
    splits K, so below it most SMs idle); an f32 x maps 2 rows a row."""
    for n in (1024, 4096, 6144, 14336, 28672, 131072):
        for route, dtype, least in (
                (lambda m: tim.w8_tile_route(m, n, 4096, torch.bfloat16),
                 torch.bfloat16, tim.TILE_MIN_TILES),
                (lambda m: tim.w8_tile_route(m, n, 4096, torch.float32),
                 torch.float32, tim.TILE_MIN_TILES),
                (lambda m: tim.w4a8_tile_route(m, n, 2048), torch.int8,
                 tim.TILE_MIN_TILES),
                (lambda m: tim.q8_tile_route(m, n, 4096), torch.int8,
                 tim.Q8_TILE_MIN_TILES)):
            m = tim.TILE_MIN_M
            while tim.tile_count(m, n, dtype) < least:
                assert not route(m)
                m += 1
            assert route(m)
            assert m == tim.TILE_MIN_M or not route(m - 1)


@pytest.mark.parametrize("m,n,dtype,want", [
    (4096, 28672, torch.int8, 32 * 112),         # K2's codes: a row a row
    (65, 4096, torch.int8, 16),
    (129, 4104, torch.bfloat16, 2 * 17),         # a ragged last tile each
    (65, 4096, torch.float32, 32),               # f32 pairs: 2 map rows
])
def test_tile_count_is_map_rows_by_columns(m, n, dtype, want):
    assert tim.tile_count(m, n, dtype) == want


@pytest.mark.parametrize("k", [4096, 4100, 14336, 1152, 200, 4, 12])
def test_w8_pair_rows_are_16_byte_aligned(k):
    """KW8's f32 pairs keep x's K columns in order (int8 weights meet k
    contiguously), each row padded to a multiple of 8 bf16 values (16
    bytes, as TMA needs), never more than 7 past K."""
    ld = tim.w8_pair_ld(k)
    assert ld * 2 % 16 == 0 and k <= ld < k + 8


def test_routes_never_overlap_and_cover_every_m():
    """At every M the decode route, the tile and the block tile split the
    shapes between them: at most one of the first two, the block tile
    where neither takes it."""
    for m in (1, 16, 63, 64, 65, 128, 200, 256, 512, 1024, 4096, 16384):
        for n in (1000, 4096, 6144, 28672, 128256):
            for k in (144, 1152, 4096, 14336):
                for dtype in (torch.bfloat16, torch.float32):
                    d = tim.w8_decode_route(m, n, k, dtype)
                    t = tim.w8_tile_route(m, n, k, dtype)
                    assert not (d and t)
                    assert d == (dtype == torch.bfloat16 and m <= 64
                                 and k % 16 == 0 and n % 16 == 0)
                d = tim.w4a8_decode_route(m, n, k // 2)
                t = tim.w4a8_tile_route(m, n, k // 2)
                assert not (d and t)
                assert d == (m <= 64 and (k // 2) % 16 == 0 and n % 16 == 0)
                assert t == (m >= 65 and (k // 2) % 16 == 0 and n % 16 == 0
                             and tim.tile_count(m, n, torch.int8)
                             >= tim.TILE_MIN_TILES)


def test_route_counts_name_the_tile_and_start_at_zero():
    """The wrappers' route counts name the tile, and a fresh import holds
    0 for every route (a process of its own: this one may have launched)."""
    assert list(tim.matmul_w8.routes) == ["decode", "tile", "bf_tile"]
    assert list(tim.w4a8_gemm.routes) == ["decode", "tile", "s8_tile"]
    code = ("from aimet_tpu_torch.ops import int_matmul as t; "
            "print(t.matmul_w8.routes, t.w4a8_gemm.routes, "
            "t.matmul_w8.launches, t.w4a8_gemm.launches)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__)))).stdout.split()
    assert " ".join(out) == ("{'decode': 0, 'tile': 0, 'bf_tile': 0} "
                             "{'decode': 0, 'tile': 0, 's8_tile': 0} 0 0")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    fns = (tim.matmul_w8, tim.w4a8_gemm, tim.matmul_w4a8_fusedq,
           tim.matmul_q8, tim.quantize_activation_per_row)
    counts = lambda: [(f.launches, dict(getattr(f, "routes", {})))
                      for f in fns]
    before = counts()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(130, 256, generator=g)
    w = torch.randint(-127, 128, (256, 512), dtype=torch.int8, generator=g)
    s = torch.rand(512, generator=g)
    assert torch.equal(tim.matmul_w8(x, w, s), tim.matmul_w8_torch(x, w, s))
    xq, sx = tim.quantize_activation_per_row(x)
    wp = torch.randint(-128, 128, (128, 512), dtype=torch.int8, generator=g)
    assert torch.equal(tim.w4a8_gemm(xq, sx, wp, s),
                       tim.w4a8_gemm_torch(xq, sx, wp, s))
    assert torch.equal(tim.matmul_w4a8_fusedq(x[:16], wp, s),
                       tim.matmul_w4a8_torch(x[:16], wp, s))
    cb = torch.randn(512, generator=g)
    assert torch.equal(tim.matmul_q8(xq, sx, w, s, cb),
                       tim.matmul_q8_torch(xq, sx, w, s, cb))
    assert counts() == before


@pytest.mark.parametrize("m,n,k,want", [
    (4096, 4096, 14336, True),                   # q8_gemm[w_down]
    (4096, 28672, 4096, True),                   # KW8A8's gate|up
    (25088, 128, 1152, True),                    # 3 x 3 conv patches
    (65, 28672, 4096, True),                     # just above decode M
    (64, 28672, 4096, False),                    # decode M: block tile
    (0, 4096, 4096, False),
    (1568, 2048, 512, True),                     # ResNet-50 layer4 1x1
    (32, 1000, 2048, False),                     # its fc: M and N
    (401408, 64, 147, False),                    # the stem's K = 147
    (300, 4104, 4096, False),                    # N % 16
    (300, 4096, 4104, False),                    # K % 16: the codes' boxes
    (300, 4096, 4112, True),
])
def test_q8_tile_route_edges(m, n, k, want):
    assert tim.q8_tile_route(m, n, k) is want


@pytest.mark.parametrize("m,n,k2,dtype,want", [
    (16, 28672, 2048, torch.bfloat16, True),     # the per-slot step's gate|up
    (1, 6144, 2048, torch.bfloat16, True),
    (64, 131072, 2048, torch.float32, True),     # lm_head, an f32 x
    (64, 4096, 7168, torch.bfloat16, True),      # W_down at the last tile
    (65, 4096, 2048, torch.bfloat16, False),     # prefill M: K1 + K2
    (0, 4096, 2048, torch.bfloat16, False),
    (16, 1000, 1024, torch.float32, False),      # N % 16 (a CNN's fc)
    (16, 4096, 1032, torch.bfloat16, False),     # K/2 % 16
    (17, 1296, 528, torch.bfloat16, True),       # no whole slice or stage
    (16, 4096, 2048, torch.float16, False),      # K1 takes f32 / bf16
])
def test_w4a8_fusedq_decode_route_edges(m, n, k2, dtype, want):
    """The fused decode kernel takes exactly K2's decode route's shapes,
    for a bf16 or f32 x."""
    assert tim.w4a8_fusedq_decode_route(m, n, k2, dtype) is want
    assert not want or tim.w4a8_decode_route(m, n, k2)
