"""KW4's routes (``matmul_w4``): which shapes take the decode
weight-streaming route, which the TMA + ``wgmma`` tile and which the
``mma.sync`` block tile, and how the decode route cuts KW4's weights. The
kernels themselves run only on the card (``test_torch_cuda_kernels.py``);
here the routes are pure shape logic and the plain version carries the
arithmetic, held against the JAX package in ``test_torch_weight_only.py``.
"""
import pytest
import torch

from aimet_tpu_torch.ops import int_matmul as tim


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


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (1, 6144, 4096, torch.bfloat16, True),       # layer 0's QKV, one row
    (16, 131072, 4096, torch.bfloat16, True),    # the padded lm_head
    (64, 28672, 4096, torch.bfloat16, True),
    (65, 4096, 4096, torch.bfloat16, False),     # prefill M: the tile
    (0, 4096, 4096, torch.bfloat16, False),
    (16, 4096, 4096, torch.float32, False),      # f32 x: no decode route
    (16, 4104, 4096, torch.bfloat16, False),     # N % 16
    (16, 4096, 4112, torch.bfloat16, False),     # K/2 = 2056: % 16
    (16, 4096, 4128, torch.bfloat16, True),      # K/2 = 2064
    (16, 1296, 1056, torch.bfloat16, True),
])
def test_w4_decode_route_edges(m, n, k, dtype, want):
    assert tim.w4_decode_route(m, n, k, dtype) is want


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (4096, 28672, 4096, torch.bfloat16, True),
    (65, 28672, 4096, torch.bfloat16, True),     # just above decode M
    (65, 4096, 4096, torch.bfloat16, False),     # 16 tiles: the block tile
    (64, 4096, 4096, torch.bfloat16, False),     # the decode route's
    (1, 4096, 4096, torch.float32, False),
    (0, 4096, 4096, torch.bfloat16, False),
    (4096, 128256, 4096, torch.float32, True),   # a lowered f32 lm_head
    (25088, 128, 1152, torch.float32, True),     # conv2d_w4's patches
    (300, 4104, 4096, torch.bfloat16, False),    # N % 16: the block tile
    (300, 4096, 4100, torch.bfloat16, False),    # bf16 rows not 16 bytes
    (300, 4096, 4104, torch.bfloat16, False),    # nor x's high half
    (300, 4096, 4100, torch.float32, True),      # f32 rows are
    (300, 4096, 4098, torch.float32, False),     # f32 rows not 16 bytes
    (300, 4096, 208, torch.bfloat16, True),      # K/2 = 104: no whole stage
    (300, 4096, 200, torch.float32, True),       # f32 pairs realign K/2
    (300, 4096, 4096, torch.float16, False),
])
def test_w4_tile_route_edges(m, n, k, dtype, want):
    assert tim.w4_tile_route(m, n, k, dtype) is want


def test_w4_routes_never_overlap_and_cover_decode_and_prefill():
    for m in (1, 16, 63, 64, 65, 128, 1024, 4096):
        for n in (4096, 28672):
            for dtype in (torch.bfloat16, torch.float32):
                d = tim.w4_decode_route(m, n, 4096, dtype)
                t = tim.w4_tile_route(m, n, 4096, dtype)
                assert not (d and t)
                assert t == (m >= tim.TILE_MIN_M and tim.tile_count(
                    m, n, dtype) >= tim.TILE_MIN_TILES)
                assert d == (dtype == torch.bfloat16 and m <= 64)


@pytest.mark.parametrize("m,n,dtype,want", [
    (4096, 28672, torch.bfloat16, 32 * 112),
    (65, 4096, torch.bfloat16, 16),              # one M tile of 128 rows
    (128, 4096, torch.bfloat16, 16),
    (129, 4104, torch.bfloat16, 2 * 17),         # a ragged last tile each
    (64, 4096, torch.float32, 16),               # f32: 2 map rows a row
    (65, 4096, torch.float32, 32),
    (4096, 128256, torch.float32, 64 * 501),
])
def test_w4_tiles_counts_the_persistent_grids_work(m, n, dtype, want):
    """The tile's planner: 128 map rows (an f32 x's bf16 pairs: 2 a row)
    by 256 columns a tile."""
    assert tim.tile_count(m, n, dtype) == want


def test_w4_tile_route_needs_its_tile_count():
    """Right at the route's tile count the tile takes over from the block
    tile, at every layer width (the count, not M, decides: the tile never
    splits K, so below it most SMs idle)."""
    need = tim.TILE_MIN_TILES
    for n in (4096, 6144, 28672, 131072):
        for dtype in (torch.bfloat16, torch.float32):
            m = tim.TILE_MIN_M
            while tim.tile_count(m, n, dtype) < need:
                m += 1
            assert tim.w4_tile_route(m, n, 4096, dtype)
            assert m == tim.TILE_MIN_M or \
                not tim.w4_tile_route(m - 1, n, 4096, dtype)


@pytest.mark.parametrize("k,want", [(4096, 4096), (4100, 4112), (200, 208),
                                    (208, 208), (4, 16)])
def test_w4_pair_rows_are_16_byte_aligned(k, want):
    """The pair rows hold x's low half, then its high half from the next
    multiple of 8 values: both start 16-byte aligned, as TMA needs."""
    assert tim.w4_pair_ld(k) == want and want * 2 % 16 == 0
    assert want >= -(-(k // 2) // 8) * 8 + k // 2


@pytest.mark.parametrize("n,k", [(6144, 4096), (131072, 4096),
                                 (28672, 4096), (4096, 14336), (1296, 1056)])
@pytest.mark.parametrize("m", [1, 16, 64])
def test_w4_decode_plan_shares_packed_bytes_evenly(m, n, k):
    """KW4's decode route plans K/2 packed rows: every block streams the
    same packed bytes within one stage (64 rows x 256 columns) and the
    narrower last slice, at least two stages a block; the pieces cover
    every (slice, stage) once and the workspace holds every slot."""
    plan = tim.decode_plan(m, n, k // 2, 132)
    assert plan.slices == -(-n // 256) and plan.steps == -(-(k // 2) // 64)
    seen, got, slots = [], [], set()
    for b in range(plan.blocks):
        pieces = _pieces(plan, b)
        assert sum(s1 - s0 for _, s0, s1 in pieces) >= 2
        total = 0
        for j, s0, s1 in pieces:
            seen += [(j, s) for s in range(s0, s1)]
            assert j + b not in slots
            slots.add(j + b)
            total += min(256, n - j * 256) * (min(s1 * 64, k // 2) - s0 * 64)
        got.append(total)
    assert sorted(seen) == [(j, s) for j in range(plan.slices)
                            for s in range(plan.steps)]
    assert (max(slots) + 1) * m * 256 <= plan.ws_values
    assert sum(got) == n * k // 2
    assert max(got) - min(got) <= 2 * 64 * 256


def test_route_counts_start_at_zero_and_name_every_route():
    assert set(tim.matmul_w4.routes) == {"decode", "tile", "bf_tile"}
    assert set(tim.matmul_w8.routes) == {"decode", "tile", "bf_tile"}
    assert set(tim.matmul_w4_grouped.routes) == {"decode", "tile",
                                                 "bf_tile"}
    assert set(tim.w4a8_gemm.routes) == {"decode", "tile", "s8_tile"}
    assert set(tim.matmul_q8.routes) == {"tile", "s8_tile", "int32_kmajor"}
    assert set(tim.matmul_w4a8_fusedq.routes) == {"decode"}


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tim.matmul_w4.launches, dict(tim.matmul_w4.routes))
    x = torch.randn(70, 200)
    w = torch.randint(-128, 128, (100, 48), dtype=torch.int8)
    s = torch.rand(48)
    assert torch.equal(tim.matmul_w4(x, w, s), tim.matmul_w4_torch(x, w, s))
    assert (tim.matmul_w4.launches, tim.matmul_w4.routes) == before
