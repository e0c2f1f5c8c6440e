"""KW4G's (``matmul_w4_grouped``) and KSQ's (``matmul_w8a8_staticq``)
routes: which shapes take the TMA + ``wgmma`` tile and which the
``mma.sync`` block tile (``bf_tile`` / ``s8_tile``); KW4G's decode
weight-streaming route below 65 rows. The kernels run only on the card
(``test_torch_cuda_kernels.py``); here the routes are pure shape logic,
and the plain versions, which carry the arithmetic, are held against the
JAX package in ``test_torch_lowering.py``.
"""
import os
import subprocess
import sys

import pytest
import torch

from aimet_tpu_torch.ops import int_matmul as tim

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (4096, 4096, 4096, BF16, True),      # the lowered forward's K = 4096
    (4096, 4096, 4096, F32, True),       # as the lowered f32 model calls it
    (4096, 1024, 4096, F32, True),       # k / v
    (4096, 4096, 14336, F32, True),      # down
    (4096, 128256, 4096, F32, True),     # the f32 lm_head
    (65, 28672, 4096, BF16, True),       # just above decode M
    (64, 28672, 4096, BF16, False),      # decode M: the block tile's (K2)
    (0, 4096, 4096, BF16, False),
    (300, 4104, 4096, BF16, False),      # N % 16
    (300, 4096, 4104, BF16, False),      # K % 16: the codes' boxes
    (300, 4096, 4112, BF16, True),
    (65, 1024, 4096, BF16, False),       # 4 output tiles: the block tile
    (320, 768, 4096, BF16, False),       # 3 x 3 = 9
    (384, 1024, 4096, BF16, True),       # 3 x 4 = 12
    (65, 4096, 4096, BF16, True),        # 16
])
def test_w8a8_staticq_tile_route_edges(m, n, k, dtype, want):
    """The route depends on the shape alone (x's dtype is quantized away:
    the tile reads the int8 codes)."""
    assert tim.w8a8_staticq_tile_route(m, n, k) is want


@pytest.mark.parametrize("m,n,k,group,dtype,want", [
    (4096, 4096, 4096, 128, F32, True),    # the lowered forward's shapes
    (4096, 1024, 4096, 128, F32, True),
    (4096, 14336, 4096, 128, F32, True),
    (4096, 4096, 14336, 128, F32, True),
    (4096, 14336, 4096, 128, BF16, True),
    (4096, 14336, 4096, 64, BF16, True),   # a group of one stage
    (4096, 14336, 4096, 256, BF16, True),
    (4096, 14336, 4096, 32, BF16, False),  # not whole stages
    (4096, 14336, 4096, 8, BF16, False),
    (4096, 14336, 4608, 24, BF16, False),
    (4096, 14336, 4608, 192, BF16, True),  # 3 stages, K/2 = 2304 = 12 x 192
    (4096, 14336, 4480, 64, BF16, True),   # K/2 = 2240 = 35 stages
    (4096, 14336, 4480, 128, BF16, False),  # 128 does not divide 2240
    (65, 14336, 4096, 128, BF16, True),    # just above decode M
    (64, 14336, 4096, 128, BF16, False),   # decode M
    (0, 14336, 4096, 128, BF16, False),
    (4096, 14344, 4096, 128, BF16, False),  # N % 16
    (4096, 14336, 4096, 128, torch.float16, False),
])
def test_w4g_tile_route_edges(m, n, k, group, dtype, want):
    assert tim.w4g_tile_route(m, n, k, group, dtype) is want


@pytest.mark.parametrize("m,n,dtype,want", [
    (4096, 14336, BF16, 32 * 112),       # 128 rows x 128 columns
    (4096, 14336, F32, 64 * 112),        # f32 pairs: 2 map rows a row
    (65, 4096, BF16, 32),
    (129, 4104, BF16, 2 * 33),           # a ragged last tile each
])
def test_w4g_tile_count_is_map_rows_by_128_columns(m, n, dtype, want):
    assert tim.w4g_tile_count(m, n, dtype) == want


def test_the_tile_counts_of_each_route_decide():
    """Right at each route's tile count the tile takes over from the block
    tile, at every width (the count, not M, decides: the tile never splits
    K, so below it most SMs idle)."""
    for n in (1024, 4096, 6144, 14336, 128256):
        for route, count, least in (
                (lambda m: tim.w8a8_staticq_tile_route(m, n, 4096),
                 lambda m: tim.tile_count(m, n, torch.int8),
                 tim.STATICQ_TILE_MIN_TILES),
                (lambda m: tim.w4g_tile_route(m, n, 4096, 128, BF16),
                 lambda m: tim.w4g_tile_count(m, n, BF16),
                 tim.W4G_TILE_MIN_TILES),
                (lambda m: tim.w4g_tile_route(m, n, 4096, 128, F32),
                 lambda m: tim.w4g_tile_count(m, n, F32),
                 tim.W4G_TILE_MIN_TILES)):
            m = tim.TILE_MIN_M
            while count(m) < least:
                assert not route(m)
                m += 1
            assert route(m)
            assert m == tim.TILE_MIN_M or not route(m - 1)


def test_routes_never_overlap_and_cover_every_m():
    """At every M KW4G's decode route, its tile and its block tile split
    the shapes between them (at most one of the first two, the block tile
    where neither takes it); KSQ's tile takes exactly the shapes its
    conditions name, the block tile the rest."""
    for m in (1, 16, 63, 64, 65, 128, 200, 256, 512, 1024, 4096, 16384):
        for n in (1000, 1024, 4096, 14336, 128256):
            for k in (256, 1152, 4096, 4608, 14336):
                for group in (8, 24, 64, 128, 256):
                    if (k // 2) % group:
                        continue
                    for dtype in (BF16, F32):
                        d = tim.w4g_decode_route(m, n, k, dtype)
                        t = tim.w4g_tile_route(m, n, k, group, dtype)
                        assert not (d and t)
                        assert t == (m >= 65 and group % 64 == 0
                                     and n % 16 == 0
                                     and tim.w4g_tile_count(m, n, dtype)
                                     >= tim.W4G_TILE_MIN_TILES)
                t = tim.w8a8_staticq_tile_route(m, n, k)
                assert t == (m >= 65 and k % 16 == 0 and n % 16 == 0
                             and tim.tile_count(m, n, torch.int8)
                             >= tim.STATICQ_TILE_MIN_TILES)


def test_route_counts_name_every_route_and_start_at_zero():
    """The wrappers' route and shape counts name the tile, and a fresh
    import holds 0 for every route (a process of its own: this one may
    have launched)."""
    assert list(tim.matmul_w4_grouped.routes) == ["decode", "tile",
                                                  "bf_tile"]
    assert list(tim.matmul_w8a8_staticq.routes) == ["tile", "s8_tile"]
    code = ("from aimet_tpu_torch.ops import int_matmul as t; "
            "print(t.matmul_w4_grouped.routes, t.matmul_w8a8_staticq.routes,"
            " t.matmul_w4_grouped.launches, t.matmul_w8a8_staticq.launches,"
            " len(t.matmul_w4_grouped.shapes),"
            " len(t.matmul_w8a8_staticq.shapes))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__)))).stdout.split()
    assert " ".join(out) == ("{'decode': 0, 'tile': 0, 'bf_tile': 0} "
                             "{'tile': 0, 's8_tile': 0} 0 0 0 0")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    fns = (tim.matmul_w4_grouped, tim.matmul_w8a8_staticq)
    before = [(f.launches, dict(f.routes), dict(f.shapes)) for f in fns]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(130, 256, generator=g)
    w = torch.randn(256, 512, generator=g) * 0.05
    packed, sc = tim.quantize_weight_int4_grouped(w, 64)
    assert torch.equal(
        tim.matmul_w4_grouped(x, packed, sc, group_size=64),
        tim.matmul_w4_grouped_torch(x, packed, sc, 64))
    wq = torch.randint(-127, 128, (256, 512), dtype=torch.int8, generator=g)
    sv = torch.rand(512, generator=g) * 1e-3
    cb = torch.randn(512, generator=g)
    enc = dict(inv_delta=1 / 0.02, offset=-120.0, num_steps=255.0,
               return_codes=True)
    got, q = tim.matmul_w8a8_staticq(x, wq, sv, cb, **enc)
    want, pq = tim.matmul_w8a8_staticq_torch(x, wq, sv, cb, **enc)
    assert torch.equal(got, want) and torch.equal(q, pq)
    assert [(f.launches, f.routes, f.shapes) for f in fns] == before
