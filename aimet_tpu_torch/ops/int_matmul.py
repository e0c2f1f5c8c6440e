"""Integer matmuls — the port's part of ``aimet_tpu/ops/int_matmul.py``:

- W4A8: split-half packed INT4 weights x per-row INT8 activations
  (``matmul_w4a8`` = ``matmul_w4a8_fusedq``): kernels K1
  (``csrc/act_quant.cu``) then K2 (``csrc/w4a8_gemm.cu``), or at decode M
  one launch of K2's fused decode kernel, which quantizes the rows itself;
- weight-only INT4 (``matmul_w4``, kernel KW4), INT8 (``matmul_w8``,
  kernel KW8) and group-wise INT4 (``matmul_w4_grouped``, kernel KW4G), all
  ``csrc/wo_gemm.cu``: bf16 or f32 activations, f32 sums;
- static-encoding INT8 (``matmul_w8a8_staticq``, kernel KSQ,
  ``csrc/w8a8_staticq.cu``): activations quantized with a frozen
  calibration encoding, int8 x int8 GEMM — the ``w8a8`` target of
  ``quantsim.lowering``;
- dynamic full INT8 (``matmul_w8a8`` = ``matmul_w8a8_fusedq``): per-row
  INT8 activations x int8 weights, K1 then kernel KQ8 (``matmul_q8``,
  ``csrc/w8a8_gemm.cu``; at prefill M on the TMA + ``wgmma`` tile) at
  every K; KQ8's int32 entry (``int8_matmul_int32``) carries the integer
  convs of ``ops.int_conv``.

Host math (weight/activation quantizers, the split-half packing, the
decode split policy) is plain PyTorch. On a CUDA tensor the wrappers
launch the kernels; on a CPU tensor they take the plain versions beside
them.

Storage contract kept byte for byte (``pack_int4_split_half``): packed row
``r`` holds ``W[r] + 8`` in its low nibble and ``W[r + K/2]`` (two's
complement) in its high nibble, so a weight tree packed by the JAX package
loads unchanged.

Activations are quantized in f32 whatever their dtype, as the TPU kernel
``_w4a8_fusedq_kernel`` does. (The JAX package's XLA oracle and its K-split
path quantize a bf16 input in bf16, which gives different codes.)
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from .._device import on_cuda
from ._common import div_ieee, fma_f32

_GEMM_DTYPES = (torch.float32, torch.bfloat16)
_SMS = 132          # H100 SXM streaming multiprocessors
MAX_DECODE_ROWS = 64
_TILE_M, _TILE_N, _TILE_P = 64, 128, 64


def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel INT4, packed split-half:
    w (K, N) -> (packed (K//2, N) int8, scale (N,) f32); K must be even."""
    amax = w.abs().amax(dim=0)
    scale = div_ieee(amax.clamp_min(1e-8), 7.0)
    q = torch.round(w / scale[None, :]).clamp(-7, 7)
    return pack_int4_split_half(q), scale.to(torch.float32)


def quantize_weight_per_channel(w: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel INT8: w (K, N) -> (codes (K, N) int8,
    scale (N,) f32), scale = max(amax, 1e-8) / 127."""
    amax = w.abs().amax(dim=0)
    scale = div_ieee(amax.clamp_min(1e-8), 127.0)
    q = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_weight_int4_grouped(w: torch.Tensor, group_size: int = 128
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric INT4, one scale per (K-group, out-channel):
    w (K, N) -> (packed (K//2, N) split-half int8, scales (K//group_size,
    N) f32); K % (2 * group_size) == 0, so a group never straddles the two
    nibble planes."""
    K, N = w.shape
    if K % (2 * group_size):
        raise ValueError(f"K={K} is not a multiple of 2 * {group_size}")
    g = K // group_size
    wg = w.reshape(g, group_size, N)
    scale = div_ieee(wg.abs().amax(dim=1).clamp_min(1e-8), 7.0)   # (g, N)
    q = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    return pack_int4_split_half(q.reshape(K, N)), scale.to(torch.float32)


def pack_int4_split_half(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int codes in [-8, 7] -> (K//2, N) int8:
    byte = ((q[k + K/2] & 0xF) << 4) | (q[k] + 8)."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"K must be even, got {K}")
    q = q.to(torch.int32)
    lo = (q[: K // 2] + 8) & 0xF
    hi = (q[K // 2:] & 0xF) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(K//2, N) split-half int8 -> (K, N) int8 codes in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = p >> 4                       # arithmetic: sign-extends the nibble
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def _quantize_activation_plain(x: torch.Tensor):
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1)
    scale = div_ieee(amax.clamp_min(1e-8), 127.0)
    q = torch.round(xf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


# K1's narrow-row kernel takes rows of at most this many values (its own
# limit: 32 lanes of 32), by x's dtype; above, a block a row (where the two
# cross on the H100: chip_smoke.k1_route_sweep). It holds about this many
# bytes of x a block.
ACT_QUANT_NARROW_MAX_K = {torch.float32: 1024, torch.bfloat16: 512}
ACT_QUANT_STAGE_BYTES = 32768
_ACT_QUANT_THREADS = 256


def act_quant_plan(K: int, x_dtype, narrow_max_k: Optional[int] = None,
                   stage_bytes: Optional[int] = None
                   ) -> Optional[Tuple[int, int]]:
    """K1's kernel for rows of K values of ``x_dtype``: None for the wide
    rows' kernel (a block a row), else (lanes a row, rows a block) of the
    narrow rows' kernel: lanes a power of two up to 32, about 8 values a
    lane; rows a multiple of 256 / lanes, about ``stage_bytes`` of x (at
    least one row a group of lanes). ``narrow_max_k`` and ``stage_bytes``
    default to ``ACT_QUANT_NARROW_MAX_K[x_dtype]`` and
    ``ACT_QUANT_STAGE_BYTES`` (other values: a sweep's)."""
    if K > min(narrow_max_k or ACT_QUANT_NARROW_MAX_K[x_dtype], 1024):
        return None
    row_bytes = K * torch.empty((), dtype=x_dtype).element_size()
    lanes = min(32, 1 << max(0, -(-K // 8) - 1).bit_length())
    groups = _ACT_QUANT_THREADS // lanes
    return lanes, groups * max(1, (stage_bytes or ACT_QUANT_STAGE_BYTES)
                               // (groups * row_bytes))


def quantize_activation_per_row(x: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row INT8 in f32: x (M, K) -> (codes (M, K)
    int8, scale (M,) f32), scale = max(amax, 1e-8) / 127. On a CUDA tensor
    this launches kernel K1 (``csrc/act_quant.cu``): its narrow-row kernel
    (several rows a block) or its wide-row one (a block a row), as
    :func:`act_quant_plan` says; ``.routes`` counts "narrow" and "wide"."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if not on_cuda(x):
        return _quantize_activation_plain(x)
    if x.dtype not in _GEMM_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    return _launch_act_quant(x.contiguous(), act_quant_plan(x.shape[1],
                                                            x.dtype))


def _launch_act_quant(x, plan):
    """K1 on a contiguous CUDA x with ``plan`` (:func:`act_quant_plan`'s
    answer, or another one, as a sweep passes)."""
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    lanes, rows = plan or (0, 0)
    _count(quantize_activation_per_row, "narrow" if plan else "wide", x, q)
    _build.launch("aimet_act_quant", x.data_ptr(), q.data_ptr(),
                  sx.data_ptr(), M, K, lanes, rows,
                  int(x.dtype == torch.bfloat16),
                  _build.stream_ptr(x.device))
    return q, sx


quantize_activation_per_row.launches = 0
quantize_activation_per_row.routes = {"narrow": 0, "wide": 0}
quantize_activation_per_row.shapes = {}


def _exact_rows(xq: torch.Tensor, w_q: torch.Tensor, epilogue,
                out_dtype: torch.dtype) -> torch.Tensor:
    """``epilogue(rows, acc)`` of the exact int32 sums xq @ w_q (int8), by
    blocks of rows to bound the wide temporaries: int64 on the CPU, f64 on
    the card (every partial sum stays below 2**53)."""
    wide = torch.int64 if xq.device.type == "cpu" else torch.float64
    w_wide = w_q.to(wide)
    rows = max(1, (1 << 24) // max(1, w_q.shape[1]))
    return torch.cat([
        epilogue(slice(i, i + rows), (xq[i:i + rows].to(wide) @ w_wide).to(
            torch.int32)).to(out_dtype)
        for i in range(0, max(1, xq.shape[0]), rows)])


def w4a8_gemm_torch(x_q: torch.Tensor, x_scale: torch.Tensor,
                    w_packed: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the GEMM on quantized activations:
    (sum_k xq[m,k] W[k,n]) * sx[m] * sw[n], cast to ``out_dtype``."""
    acc = int8_matmul_int32_torch(x_q, unpack_int4(w_packed))
    return (acc.to(torch.float32) * x_scale[:, None]
            * w_scale.to(torch.float32)[None, :]).to(out_dtype)


def matmul_w4a8_torch(x: torch.Tensor, w_packed: torch.Tensor,
                      w_scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the W4A8 matmul (counterpart of the JAX package's
    ``matmul_w4a8_xla``, quantizing in f32)."""
    x_q, x_scale = _quantize_activation_plain(x)
    return w4a8_gemm_torch(x_q, x_scale, w_packed, w_scale,
                           out_dtype or x.dtype)


def decode_splits(M: int, N: int, steps: int) -> int:
    """The decode tile policy of the GEMM kernels (K2, KW4, KW8): how many
    blocks share the K range of one 64 x 128 output tile. At decode M the
    M x N tiles alone cannot fill 132 SMs, so K is split until there are
    ~4 blocks per SM, keeping at least two K steps per split. (The TPU's
    ``decode_blocks`` instead sized one core's weight tiles.)"""
    tiles = -(-M // _TILE_M) * -(-N // _TILE_N)
    want = -(-4 * _SMS // tiles)
    return max(1, min(want, steps // 2))


def _used_splits(steps: int, splits: int) -> int:
    """The non-empty splits when ``steps`` K steps go ``splits`` ways."""
    per = -(-steps // splits)
    return -(-steps // per)


def w4a8_gemm(x_q: torch.Tensor, x_scale: torch.Tensor,
              w_packed: torch.Tensor, w_scale: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """GEMM on per-row quantized activations: x_q (M, K) int8, x_scale (M,)
    f32, split-half INT4 weights (K//2, N) int8, w_scale (N,) f32 ->
    (M, N) ``out_dtype``. On a CUDA tensor it launches kernel K2
    (``csrc/w4a8_gemm.cu``) by one of three routes, picked from the shapes:
    at decode M with aligned shapes (:func:`w4a8_decode_route`) its
    weight-streaming route, one block an SM planned by
    :func:`decode_plan`; above 64 rows with aligned shapes and at least
    ``TILE_MIN_TILES`` output tiles (:func:`w4a8_tile_route`) the
    TMA + ``wgmma`` tile (``csrc/wgmma_wo_tile.cuh``, int8 MMAs, no split
    K); else its block tile, splitting K by :func:`decode_splits` into a
    zeroed int32 buffer. All three are bit-exact. On a CPU tensor it takes
    ``w4a8_gemm_torch``."""
    M, K = x_q.shape
    K2, N = w_packed.shape
    if K != 2 * K2 or x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(f"shape mismatch: x_q {tuple(x_q.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}")
    if not on_cuda(x_q, x_scale, w_packed, w_scale):
        return w4a8_gemm_torch(x_q, x_scale, w_packed, w_scale, out_dtype)
    if out_dtype not in _GEMM_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    for t, dt in ((x_q, torch.int8), (w_packed, torch.int8),
                  (x_scale, torch.float32), (w_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned operands
    x_q, w_packed = (t.contiguous() for t in (x_q, w_packed))
    x_q, w_packed = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (x_q, w_packed))
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if w4a8_decode_route(M, N, K2):
        return _launch_w4a8_decode(x_q, x_scale, w_packed, w_scale, out)
    if w4a8_tile_route(M, N, K2):
        return _launch_w4a8_tile(x_q, x_scale, w_packed, w_scale, out)
    return _launch_s8_tile(x_q, x_scale, w_packed, w_scale, out)


w4a8_gemm.launches = 0
w4a8_gemm.routes = {"decode": 0, "tile": 0, "s8_tile": 0}
w4a8_gemm.shapes = {}


def _launch_s8_tile(x_q, x_scale, w_packed, w_scale, out):
    """K2's ``mma.sync`` block tile on contiguous, aligned CUDA operands,
    splitting K by :func:`decode_splits` into a zeroed int32 buffer."""
    M = x_q.shape[0]
    K2, N = w_packed.shape
    splits = decode_splits(M, N, -(-K2 // _TILE_P))
    ws = (torch.zeros((M, N), dtype=torch.int32, device=x_q.device)
          if splits > 1 else out)
    _count(w4a8_gemm, "s8_tile", x_q, out)
    _build.launch("aimet_w4a8_gemm", x_q.data_ptr(), x_scale.data_ptr(),
                  w_packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), M, N, K2, splits,
                  int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(x_q.device))
    return out


def _count(fn, route: str, x, out, group: int = 0) -> None:
    """One launch of ``fn``'s kernel, by the route it took (``fn.routes``
    counts each route's launches beside ``fn.launches``, the kernel's) and
    by its shape (``fn.shapes``: (route, M, N, K, x dtype, out dtype,
    group) -> launches, K counting unpacked weight rows)."""
    fn.launches += 1
    fn.routes[route] += 1
    key = (route, x.shape[0], out.shape[1], x.shape[1],
           str(x.dtype).split(".")[-1], str(out.dtype).split(".")[-1], group)
    fn.shapes[key] = fn.shapes.get(key, 0) + 1


def w4a8_decode_route(M: int, N: int, K2: int) -> bool:
    """Whether K2 takes its decode weight-streaming route: 1..64 rows of x,
    K/2 packed weight rows and N columns multiples of 16."""
    return 1 <= M <= MAX_DECODE_ROWS and K2 % 16 == 0 and N % 16 == 0


def _launch_w4a8_decode(x_q, x_scale, w_packed, w_scale, out):
    """K2's decode route on contiguous, aligned CUDA operands."""
    M = x_q.shape[0]
    K2, N = w_packed.shape
    plan = decode_plan(M, N, K2, _sm_count(x_q.device))
    ws = torch.empty((plan.ws_values,), dtype=torch.int32,
                     device=x_q.device)
    cnt = _zeroed_counters(x_q.device, plan.slices)
    _count(w4a8_gemm, "decode", x_q, out)
    _build.launch("aimet_w4a8_decode_gemm", x_q.data_ptr(),
                  x_scale.data_ptr(), w_packed.data_ptr(),
                  w_scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  cnt.data_ptr(), M, N, K2, plan.blocks, ws.numel(),
                  cnt.numel(), int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(x_q.device))
    return out


def w4a8_tile_route(M: int, N: int, K2: int) -> bool:
    """Whether K2 takes its TMA + ``wgmma`` tile: M from ``TILE_MIN_M``
    up, K/2 packed rows and N multiples of 16 (x's high half 16-byte
    aligned for its TMA boxes), and at least ``TILE_MIN_TILES`` output
    tiles (:func:`tile_count`; below, the block tile, which splits K, is
    faster)."""
    return (M >= TILE_MIN_M and K2 % 16 == 0 and N % 16 == 0
            and tile_count(M, N, torch.int8) >= TILE_MIN_TILES)


def _launch_w4a8_tile(x_q, x_scale, w_packed, w_scale, out):
    """K2's TMA + ``wgmma`` tile on contiguous, aligned CUDA operands."""
    M = x_q.shape[0]
    K2, N = w_packed.shape
    _count(w4a8_gemm, "tile", x_q, out)
    _build.launch("aimet_w4a8_tile_gemm", x_q.data_ptr(), x_scale.data_ptr(),
                  w_packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(), M,
                  N, K2, int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(x_q.device))
    return out


def w4a8_fusedq_decode_route(M: int, N: int, K2: int, x_dtype) -> bool:
    """Whether :func:`matmul_w4a8_fusedq` takes K2's fused decode kernel
    (K1 folded in, one launch): a bf16 or f32 x of 1..64 rows, K/2 packed
    weight rows and N multiples of 16 (K2's decode route's shapes)."""
    return x_dtype in _GEMM_DTYPES and w4a8_decode_route(M, N, K2)


def _launch_w4a8_fusedq_decode(x, w_packed, w_scale, out_dtype):
    """K2's fused decode kernel on CUDA tensors: one cooperative launch
    that writes K1's codes and scales into workspaces, then runs K2's
    decode route on them (:func:`decode_plan`'s grid, which the C entry
    refuses unless its blocks can all be resident at once). Returns (out,
    codes, scales)."""
    if w_packed.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError(f"expected int8 weights and float32 scales, got "
                        f"{w_packed.dtype}, {w_scale.dtype}")
    if out_dtype not in _GEMM_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned operands
    x, w_packed, w_scale = (t.contiguous() for t in (x, w_packed, w_scale))
    x, w_packed = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (x, w_packed))
    (M, K), (K2, N) = x.shape, w_packed.shape
    plan = decode_plan(M, N, K2, _sm_count(x.device))
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.ws_values,), dtype=torch.int32, device=x.device)
    # the slices' counters, then the rows and the blocks done
    cnt = _zeroed_counters(x.device, plan.slices + 2)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    _count(matmul_w4a8_fusedq, "decode", x, out)
    _build.launch("aimet_w4a8_fusedq_decode_gemm", x.data_ptr(),
                  xq.data_ptr(), sx.data_ptr(), w_packed.data_ptr(),
                  w_scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  cnt.data_ptr(), M, N, K2, plan.blocks, ws.numel(),
                  cnt.numel(), int(x.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(x.device))
    return out, xq, sx


def matmul_w4a8_fusedq(x: torch.Tensor, w_packed: torch.Tensor,
                       w_scale: torch.Tensor, *,
                       block_m: Optional[int] = None,
                       block_n: Optional[int] = None,
                       out_dtype: Optional[torch.dtype] = None,
                       return_codes: bool = False):
    """W4A8 with the per-row activation quantization in the same call (the
    counterpart of the JAX package's ``matmul_w4a8_fusedq``): x (M, K)
    f32/bf16 @ split-half INT4 weights (K//2, N) int8 with per-column
    scales (N,) f32 -> (M, N) ``out_dtype`` (default x's dtype). With
    ``return_codes`` it returns (out, codes (M, K) int8, scales (M,) f32).
    ``block_m`` and ``block_n`` are accepted for the JAX signature and
    unused: the port plans its own tiles.

    On CUDA tensors at decode M (:func:`w4a8_fusedq_decode_route`) it makes
    one launch, K2's fused decode kernel (``csrc/w4a8_gemm.cu``: K1's
    quantizer as its first phase, then K2's decode route; counted in
    ``matmul_w4a8_fusedq.launches`` and ``.routes["decode"]``, not in K1's
    or K2's counts); elsewhere K1 (:func:`quantize_activation_per_row`)
    then K2 (:func:`w4a8_gemm`). On CPU tensors: the plain versions. All
    give the same bits."""
    del block_m, block_n
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError("x must be (M, K) and w_packed (K//2, N)")
    if x.shape[1] != 2 * w_packed.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match w_packed "
                         f"{tuple(w_packed.shape)}")
    out_dtype = out_dtype or x.dtype
    (M, _), (K2, N) = x.shape, w_packed.shape
    if on_cuda(x, w_packed, w_scale) and w4a8_fusedq_decode_route(
            M, N, K2, x.dtype):
        if w_scale.shape != (N,):
            raise ValueError(f"w_scale must be ({N},), got "
                             f"{tuple(w_scale.shape)}")
        out, x_q, x_scale = _launch_w4a8_fusedq_decode(x, w_packed, w_scale,
                                                       out_dtype)
    else:
        x_q, x_scale = quantize_activation_per_row(x)
        out = w4a8_gemm(x_q, x_scale, w_packed, w_scale, out_dtype)
    return (out, x_q, x_scale) if return_codes else out


matmul_w4a8_fusedq.launches = 0
matmul_w4a8_fusedq.routes = {"decode": 0}
matmul_w4a8_fusedq.shapes = {}


def matmul_w4a8(x: torch.Tensor, w_packed: torch.Tensor,
                w_scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W4A8 matmul: x (M, K) f32/bf16 @ split-half INT4 weights
    (K//2, N) int8 with per-column scales (N,) f32 -> (M, N) ``out_dtype``
    (default x's dtype): :func:`matmul_w4a8_fusedq` (on CUDA tensors one
    fused launch at decode M, else K1 then K2; on CPU tensors the plain
    versions; the same bits)."""
    return matmul_w4a8_fusedq(x, w_packed, w_scale, out_dtype=out_dtype)


# --------------------------------------------------------------------------
# weight-only INT4 / INT8 (KW4 / KW8)
# --------------------------------------------------------------------------

def matmul_w8_torch(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of :func:`matmul_w8` (the JAX package's
    ``matmul_w8_xla``): f32 sums of x times the int8 codes, times the
    column scale."""
    acc = x.to(torch.float32) @ w_q.to(torch.float32)
    return (acc * w_scale.to(torch.float32)[None, :]).to(
        out_dtype or x.dtype)


def matmul_w4_torch(x: torch.Tensor, w_packed: torch.Tensor,
                    w_scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of :func:`matmul_w4` (the JAX package's
    ``matmul_w4_xla``): x_lo . lo + x_hi . hi in f32, times the column
    scale, with lo = (p & 15) - 8 and hi = p >> 4."""
    K2 = w_packed.shape[0]
    lo = ((w_packed & 0xF) - 8).to(torch.float32)
    hi = (w_packed >> 4).to(torch.float32)
    xf = x.to(torch.float32)
    acc = xf[:, :K2] @ lo + xf[:, K2:] @ hi
    return (acc * w_scale.to(torch.float32)[None, :]).to(
        out_dtype or x.dtype)


_BF_STEP_K = 64     # k values a step of the weight-only kernels
_S8_STEP_K = 128    # k values a step of KSQ's int8 tile


def _weight_only(name: str, x, w, w_scale, out_dtype, w4: bool, fn):
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x must be (M, K) and w 2-D, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    rows, N = w.shape
    if (2 * rows if w4 else rows) != K or w_scale.shape != (N,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, w_scale {tuple(w_scale.shape)}")
    out_dtype = out_dtype or x.dtype
    if not on_cuda(x, w, w_scale):
        plain = matmul_w4_torch if w4 else matmul_w8_torch
        return plain(x, w, w_scale, out_dtype)
    return _launch_bf_gemm(name, fn, x, w, w_scale, out_dtype, K, N)


def _launch_bf_gemm(name, fn, x, w, w_scale, out_dtype, K, N, group=None):
    """Launch KW4, KW8 (``group`` None) or KW4G on CUDA tensors, by the
    route the shapes pick."""
    M = x.shape[0]
    if x.dtype not in _GEMM_DTYPES or out_dtype not in _GEMM_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 x and output, "
                        f"got {x.dtype} -> {out_dtype}")
    if w.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError(f"expected int8 weights and float32 scales, got "
                        f"{w.dtype}, {w_scale.dtype}")
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned operands
    x, w, w_scale = (t.contiguous() for t in (x, w, w_scale))
    x, w, w_scale = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (x, w, w_scale))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if fn is matmul_w8 and w8_decode_route(M, N, K, x.dtype):
        return _launch_wo_decode("aimet_w8_decode_gemm", fn, x, w, w_scale,
                                 out, K)
    if fn is matmul_w4 and w4_decode_route(M, N, K, x.dtype):
        return _launch_wo_decode("aimet_w4_decode_gemm", fn, x, w, w_scale,
                                 out, K // 2)
    if (fn is matmul_w4 and w4_tile_route(M, N, K, x.dtype)
            or fn is matmul_w8 and w8_tile_route(M, N, K, x.dtype)):
        return _launch_wo_tile(fn, x, w, w_scale, out)
    if (fn is matmul_w4_grouped
            and w4g_tile_route(M, N, K, group, x.dtype)):
        return _launch_w4g_tile(x, w, w_scale, out, group)
    return _launch_bf_tile(name, fn, x, w, w_scale, out, group)


def _launch_bf_tile(name, fn, x, w, w_scale, out, group=None):
    """The ``mma.sync`` block tile of KW4, KW8 or KW4G (``group`` set:
    KW4G, which takes its weight-streaming route where
    :func:`w4g_decode_route` says) on contiguous, aligned CUDA operands,
    splitting K by :func:`decode_splits`."""
    (M, K), N = x.shape, out.shape[1]
    decode = group is not None and w4g_decode_route(M, N, K, x.dtype)
    if decode:
        splits = w4g_decode_splits(M, N, K)
    else:
        steps = -(-K // _BF_STEP_K)
        splits = _used_splits(steps, decode_splits(M, N, steps))
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    sizes = (M, N, K) if group is None else (M, N, K, group)
    flags = () if group is None else (int(decode),)
    _count(fn, "decode" if decode else "bf_tile", x, out, group or 0)
    _build.launch(name, x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                  out.data_ptr(), ws.data_ptr(), *sizes, splits,
                  int(x.dtype == torch.float32),
                  int(out.dtype == torch.bfloat16), *flags,
                  _build.stream_ptr(x.device))
    return out


def matmul_w4(x: torch.Tensor, w_packed: torch.Tensor, w_scale: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Weight-only INT4: x (M, K) @ split-half INT4 weights (K//2, N) int8
    with per-column scales (N,) f32 -> (M, N) ``out_dtype`` (default x's
    dtype). On CUDA tensors (x bf16 or f32) it launches kernel KW4
    (``csrc/wo_gemm.cu``) by one of three routes, picked from the shapes:
    a bf16 x of at most 64 rows with K/2 and N multiples of 16 streams the
    weights through the decode routine (:func:`w4_decode_route`,
    :func:`decode_plan`, one block an SM); M above 64 with operands TMA
    can map and at least ``TILE_MIN_TILES`` output tiles takes the
    TMA + ``wgmma`` tile (:func:`w4_tile_route`,
    ``csrc/wgmma_wo_tile.cuh``, no split K); the rest takes the
    ``mma.sync`` block tile, splitting K by :func:`decode_splits`.
    ``matmul_w4.routes`` counts each route's launches, ``.shapes`` each
    route's launches by shape. On CPU tensors it
    takes :func:`matmul_w4_torch`. An f32 x is not rounded to bf16: the
    kernel takes it as a bf16 high part plus a bf16 residual (within
    ~2^-16 of the f32 product)."""
    return _weight_only("aimet_w4_gemm", x, w_packed, w_scale, out_dtype,
                        True, matmul_w4)


def matmul_w8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Weight-only INT8: x (M, K) @ int8 codes (K, N) with per-column
    scales (N,) f32. On CUDA tensors (x bf16 or f32, as for
    :func:`matmul_w4`) it launches kernel KW8 (``csrc/wo_gemm.cu``) by one
    of three routes, picked from the shapes: a bf16 x of at most 64 rows
    with K and N multiples of 16 takes its decode weight-streaming route
    (:func:`w8_decode_route`, :func:`decode_plan`, one block an SM); M
    above 64 with operands TMA can map and at least ``TILE_MIN_TILES``
    output tiles the TMA + ``wgmma`` tile (:func:`w8_tile_route`,
    ``csrc/wgmma_wo_tile.cuh``, no split K; an f32 x as bf16 pairs, as
    KW4's); the rest its block tile. On CPU tensors it takes
    :func:`matmul_w8_torch`."""
    return _weight_only("aimet_w8_gemm", x, w_q, w_scale, out_dtype, False,
                        matmul_w8)


def matmul_w4_decode(x: torch.Tensor, w_packed: torch.Tensor,
                     w_scale: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Decode-shape weight-only INT4 (the JAX package's single tuned decode
    dispatch, ``matmul_w4_decode``): KW4's decode weight-streaming route
    (:func:`w4_decode_route`: a bf16 x of 1..64 rows, K/2 and N multiples
    of 16), which plans its own split (:func:`decode_plan`); other shapes
    go to :func:`matmul_w4`'s other routes. The same bits as
    :func:`matmul_w4`, which picks the same route."""
    return matmul_w4(x, w_packed, w_scale, out_dtype)


def decode_blocks(n_out: int) -> Tuple[int, int]:
    """The JAX package's (block_n, packed block_k) for weight-only decode
    shapes of ``n_out`` columns, for callers that pass them on. No port
    kernel takes them: the decode routine cuts its own slices and stages
    (:func:`decode_plan`)."""
    return (4096 if n_out >= 16384 else 2048), 512


matmul_w4.launches = 0
matmul_w4.routes = {"decode": 0, "tile": 0, "bf_tile": 0}
matmul_w4.shapes = {}
matmul_w8.launches = 0
matmul_w8.routes = {"decode": 0, "tile": 0, "bf_tile": 0}
matmul_w8.shapes = {}


class DecodePlan(NamedTuple):
    """How the decode weight-streaming routine (``csrc/decode_gemm.cuh``,
    ``Geo``) cuts one GEMM: slices of DECODE_WIDTH columns, stages of
    DECODE_STAGE_ROWS weight rows, ``blocks`` contiguous equal ranges of
    the (slice, stage) units. ``ws_values``: the partial sums it needs
    (f32; int32 for K2), a slot of M x DECODE_WIDTH for each (slice, block)
    meeting (the C entries refuse a shorter workspace)."""
    blocks: int
    slices: int
    steps: int
    ws_values: int


DECODE_WIDTH = 256         # columns a slice of the decode routine
DECODE_STAGE_ROWS = 64     # weight rows a stage of the decode routine


def decode_plan(M: int, N: int, rows: int, sms: int = _SMS,
                halves: int = 1) -> DecodePlan:
    """The cut of a GEMM of M rows of x by ``halves`` weights of ``rows`` x
    ``N`` on ``sms`` blocks: every block at least two stages, so at most
    total / 2 blocks."""
    slices = halves * -(-N // DECODE_WIDTH)
    steps = -(-rows // DECODE_STAGE_ROWS)
    blocks = min(sms, max(1, slices * steps // 2))
    return DecodePlan(blocks, slices, steps,
                      (slices + blocks - 1) * M * DECODE_WIDTH)


def w8_decode_route(M: int, N: int, K: int, x_dtype) -> bool:
    """Whether KW8 takes its decode weight-streaming route: a bf16 x of
    1..64 rows, K and N multiples of 16."""
    return (x_dtype == torch.bfloat16 and 1 <= M <= MAX_DECODE_ROWS
            and K % 16 == 0 and N % 16 == 0)


_COUNTERS = {}


def _zeroed_counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 slice counters, 0, for the current stream of ``device``
    (a kernel leaves them 0; launches on one stream do not overlap)."""
    key = (device.index, _build.stream_ptr(device))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def w4_decode_route(M: int, N: int, K: int, x_dtype) -> bool:
    """Whether KW4 takes its decode weight-streaming route: a bf16 x of
    1..64 rows, K/2 packed rows and N multiples of 16."""
    return (x_dtype == torch.bfloat16 and 1 <= M <= MAX_DECODE_ROWS
            and K % 32 == 0 and N % 16 == 0)


TILE_MIN_M = MAX_DECODE_ROWS + 1      # the tile's rows from here up
TILE_BM, TILE_BN = 128, 256           # the tile's map rows and columns
# the output tiles from which the tile beats the block tiles (which split
# K; the tile never does), measured on the H100 for each format
# (chip_smoke.tile_sweep for KW4, chip_smoke.prefill_sweep for KW8 and
# K2; PERF.md): each loses at 16 tiles (M <= 128 at N = 4096) and wins
# from 24 (N = 6144), at K = 4096 and 14336 alike
TILE_MIN_TILES = 24


def tile_count(M: int, N: int, x_dtype) -> int:
    """The output tiles of the TMA + ``wgmma`` tile (KW4, KW8, K2): 128
    rows of its x map (an f32 x maps 2 rows a row: bf16 high part and
    residual) by 256 columns. Its persistent grid runs one tile a block,
    one block an SM, and never splits K."""
    rows = 2 * M if x_dtype == torch.float32 else M
    return -(-rows // TILE_BM) * -(-N // TILE_BN)


def w4_tile_route(M: int, N: int, K: int, x_dtype) -> bool:
    """Whether KW4 takes its TMA + ``wgmma`` tile: M from ``TILE_MIN_M``
    up, at least ``TILE_MIN_TILES`` output tiles (:func:`tile_count`;
    below, most SMs idle while each block walks all of K, and the block
    tile, which splits K, is faster), and operands the tensor maps take:
    N % 16 and, for a bf16 x, x's high half 16-byte aligned (K % 16: a TMA
    box that starts off 16 bytes hangs the load); an f32 x is rewritten
    as aligned bf16 pairs first, and needs K % 4 (16-byte rows to
    read)."""
    return (x_dtype in _GEMM_DTYPES and M >= TILE_MIN_M and N % 16 == 0
            and K % (16 if x_dtype == torch.bfloat16 else 4) == 0
            and tile_count(M, N, x_dtype) >= TILE_MIN_TILES)


def w8_tile_route(M: int, N: int, K: int, x_dtype) -> bool:
    """Whether KW8 takes its TMA + ``wgmma`` tile: as
    :func:`w4_tile_route`, but int8 weights' x boxes follow k
    contiguously, so a bf16 x needs only 16-byte rows (K % 8); an f32 x
    K % 4."""
    return (x_dtype in _GEMM_DTYPES and M >= TILE_MIN_M and N % 16 == 0
            and K % (8 if x_dtype == torch.bfloat16 else 4) == 0
            and tile_count(M, N, x_dtype) >= TILE_MIN_TILES)


def w4_pair_ld(K: int) -> int:
    """bf16 values a row of KW4's pair matrix for an f32 x (the bf16 high
    parts and residuals of x's rows): x's low half, then its high half
    from the next multiple of 8, rows a multiple of 8 (16 bytes)."""
    hi0 = -(-(K // 2) // 8) * 8
    return -(-(hi0 + K // 2) // 8) * 8


def _launch_wo_decode(name, fn, x, w, w_scale, out, rows):
    """KW8's or KW4's decode route on contiguous, aligned CUDA operands;
    ``rows``: the weight's rows (K, or K/2 packed)."""
    M, K = x.shape
    N = w.shape[1]
    plan = decode_plan(M, N, rows, _sm_count(x.device))
    ws = torch.empty((plan.ws_values,), dtype=torch.float32,
                     device=x.device)
    cnt = _zeroed_counters(x.device, plan.slices)
    _count(fn, "decode", x, out)
    _build.launch(name, x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                  out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), M, N, K,
                  plan.blocks, ws.numel(), cnt.numel(),
                  int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(x.device))
    return out


def w8_pair_ld(K: int) -> int:
    """bf16 values a row of KW8's pair matrix for an f32 x: x's K columns,
    rows a multiple of 8 (16 bytes)."""
    return -(-K // 8) * 8


def _launch_wo_tile(fn, x, w, w_scale, out):
    """KW4's or KW8's (``fn``) TMA + ``wgmma`` tile on contiguous, aligned
    CUDA operands; an f32 x gets its pair matrix in a workspace."""
    M, K = x.shape
    N = w.shape[1]
    f32 = x.dtype == torch.float32
    w4 = fn is matmul_w4
    ws = (torch.empty((2 * M, (w4_pair_ld if w4 else w8_pair_ld)(K)),
                      dtype=torch.bfloat16, device=x.device) if f32 else out)
    _count(fn, "tile", x, out)
    _build.launch("aimet_w4_tile_gemm" if w4 else "aimet_w8_tile_gemm",
                  x.data_ptr(), w.data_ptr(),
                  w_scale.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N, K,
                  int(f32), int(out.dtype == torch.bfloat16),
                  ws.numel() * ws.element_size() if f32 else 0,
                  _build.stream_ptr(x.device))
    return out


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------
# group-wise INT4 (KW4G)
# --------------------------------------------------------------------------

def matmul_w4_grouped_torch(x: torch.Tensor, w_packed: torch.Tensor,
                            scales: torch.Tensor, group_size: int = 128,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Plain version of :func:`matmul_w4_grouped` (the JAX package's
    ``matmul_w4_grouped_xla``): the weights dequantized in f32 (codes times
    their group's scale), cast to x's dtype, then an f32-sum product."""
    K = x.shape[1]
    w_q = unpack_int4(w_packed).to(torch.float32)
    g = K // group_size
    w_deq = (w_q.reshape(g, group_size, -1)
             * scales.to(torch.float32)[:, None, :]).reshape(K, -1)
    acc = x.to(torch.float32) @ w_deq.to(x.dtype).to(torch.float32)
    return acc.to(out_dtype or x.dtype)


_W4G_DEC_N, _W4G_DEC_R = 128, 64   # columns a block, packed rows a step
W4G_TILE_BN = 128        # KW4G's tile: weight columns (its map rows: 128)
W4G_TILE_STAGE = 64      # packed rows a stage of KW4G's tile
# the output tiles of KW4G's tile (128 x 128) from which it beats the
# block tile, which splits K, measured on the H100
# (chip_smoke.new_tile_sweep, PERF.md): with a bf16 x it loses at 16
# tiles and wins from 24, with an f32 x it loses at 24 and wins from 32
W4G_TILE_MIN_TILES = 32


def w4g_decode_route(M: int, N: int, K: int, x_dtype) -> bool:
    """Whether KW4G takes its weight-streaming route (decode M): a bf16 x
    of at most 64 rows, K and N multiples of 16."""
    return (x_dtype == torch.bfloat16 and M <= MAX_DECODE_ROWS
            and K % 16 == 0 and N % 16 == 0)


def w4g_tile_count(M: int, N: int, x_dtype) -> int:
    """The output tiles of KW4G's TMA + ``wgmma`` tile: 128 rows of its x
    map (an f32 x maps 2 rows a row) by 128 columns (one m64 slice a
    consumer warpgroup: its sums and each stage's group sums fill the
    registers)."""
    rows = 2 * M if x_dtype == torch.float32 else M
    return -(-rows // TILE_BM) * -(-N // W4G_TILE_BN)


def w4g_tile_route(M: int, N: int, K: int, group: int, x_dtype) -> bool:
    """Whether KW4G takes its TMA + ``wgmma`` tile: M from ``TILE_MIN_M``
    up; a group of whole stages (a multiple of 64) dividing K/2, so each
    stage's sums of a plane fold with one scale; N % 16; x's boxes
    aligned as for KW4's tile (bf16: K % 16; an f32 x becomes aligned bf16
    pairs, K % 4); and at least ``W4G_TILE_MIN_TILES`` output tiles
    (:func:`w4g_tile_count`). Other groups (8, 24, ...) and fewer tiles
    keep the block tile."""
    return (x_dtype in _GEMM_DTYPES and M >= TILE_MIN_M
            and group % W4G_TILE_STAGE == 0 and (K // 2) % group == 0
            and N % 16 == 0
            and K % (16 if x_dtype == torch.bfloat16 else 4) == 0
            and w4g_tile_count(M, N, x_dtype) >= W4G_TILE_MIN_TILES)


def _launch_w4g_tile(x, w, scales, out, group):
    """KW4G's TMA + ``wgmma`` tile on contiguous, aligned CUDA operands;
    an f32 x gets KW4's pair matrix in a workspace."""
    M, K = x.shape
    N = w.shape[1]
    f32 = x.dtype == torch.float32
    ws = (torch.empty((2 * M, w4_pair_ld(K)), dtype=torch.bfloat16,
                      device=x.device) if f32 else out)
    _count(matmul_w4_grouped, "tile", x, out, group)
    _build.launch("aimet_w4g_tile_gemm", x.data_ptr(), w.data_ptr(),
                  scales.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N, K,
                  group, int(f32), int(out.dtype == torch.bfloat16),
                  ws.numel() * ws.element_size() if f32 else 0,
                  _build.stream_ptr(x.device))
    return out


def w4g_decode_splits(M: int, N: int, K: int) -> int:
    """The K splits of KW4G's weight-streaming route: as many as keep the
    128-column tiles times splits within one wave of co-resident blocks
    (2 an SM up to 32 rows, 1 above: their registers), each split at least
    two 64-row steps of the packed weights (``chip_smoke.py``'s split
    sweep, PERF.md §6)."""
    steps = -(-(K // 2) // _W4G_DEC_R)
    tiles = -(-N // _W4G_DEC_N)
    per_sm = 2 if M <= 32 else 1
    return _used_splits(steps, max(1, min(per_sm * _SMS // tiles,
                                          steps // 2)))


def matmul_w4_grouped(x: torch.Tensor, w_packed: torch.Tensor,
                      scales: torch.Tensor, *, group_size: int = 128,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Group-wise INT4: x (M, K) @ split-half INT4 weights (K//2, N) int8
    with one scale per (K-group, column), scales (K//group_size, N) f32
    (row g covers k in [g * group_size, (g + 1) * group_size)); K must be a
    multiple of 2 * group_size. On CUDA tensors (x bf16 or f32, any group
    size) it launches kernel KW4G (``csrc/wo_gemm.cu``): bf16 MMAs with f32
    sums, each group's sum scaled once, by one of three routes picked from
    the shapes: a bf16 x of at most 64 rows takes its weight-streaming
    route (:func:`w4g_decode_route`); M above 64 with a group of whole
    64-row stages and enough output tiles the TMA + ``wgmma`` tile
    (:func:`w4g_tile_route`, ``csrc/wgmma_wo_tile.cuh``, no split K); the
    rest the ``mma.sync`` block tile. ``.routes`` counts each route's
    launches, ``.shapes`` each route's launches by shape. On CPU tensors
    it takes :func:`matmul_w4_grouped_torch`."""
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError("x must be (M, K) and w_packed (K//2, N)")
    M, K = x.shape
    K2, N = w_packed.shape
    if (K != 2 * K2 or K % (2 * group_size)
            or scales.shape != (K // group_size, N)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, scales "
                         f"{tuple(scales.shape)}, group_size {group_size}")
    out_dtype = out_dtype or x.dtype
    if not on_cuda(x, w_packed, scales):
        return matmul_w4_grouped_torch(x, w_packed, scales, group_size,
                                       out_dtype)
    return _launch_bf_gemm("aimet_w4g_gemm", matmul_w4_grouped, x, w_packed,
                           scales, out_dtype, K, N, group=group_size)


matmul_w4_grouped.launches = 0
matmul_w4_grouped.routes = {"decode": 0, "tile": 0, "bf_tile": 0}
matmul_w4_grouped.shapes = {}


# --------------------------------------------------------------------------
# static-encoding INT8 (KSQ)
# --------------------------------------------------------------------------

def _staticq_constants(inv_delta: float, offset: float, num_steps: float):
    """The kernel's f32 constants: 1/Δ, the shift -offset - 128 and the top
    code num_steps - 128 (the TPU kernel bakes the same three). Its two
    multiply-adds, x * inv + shift and acc * scale_vec + col_bias, run as
    fused multiply-adds where the reference's tests run it (XLA on the CPU
    contracts them), so the port rounds each once too."""
    return tuple(float(np.float32(v)) for v in
                 (inv_delta, -offset - 128.0, num_steps - 128.0))


def quantize_static_q8_torch(x: torch.Tensor, inv_delta: float,
                             offset: float, num_steps: float) -> torch.Tensor:
    """Plain version of KSQ's codes: x (M, K) -> int8 codes
    clip(round(fma(x, inv_delta, -offset - 128)), -128, num_steps - 128),
    f32, round half to even."""
    inv, shift, hi = (torch.tensor(v, dtype=torch.float32, device=x.device)
                      for v in _staticq_constants(inv_delta, offset,
                                                  num_steps))
    q = torch.round(fma_f32(x.to(torch.float32), inv, shift))
    return torch.minimum(torch.maximum(q, torch.full_like(q, -128.0)),
                         hi).to(torch.int8)


def matmul_w8a8_staticq_torch(x: torch.Tensor, w_q: torch.Tensor,
                              scale_vec: torch.Tensor, col_bias: torch.Tensor,
                              *, inv_delta: float, offset: float,
                              num_steps: float,
                              out_dtype: torch.dtype = torch.float32,
                              return_codes: bool = False):
    """Plain version of :func:`matmul_w8a8_staticq`: the codes, the exact
    int32 product, then fma(acc, scale_vec, col_bias) in f32 (by blocks of
    rows, to bound the f64 temporaries)."""
    xq = quantize_static_q8_torch(x, inv_delta, offset, num_steps)
    sv = scale_vec.to(torch.float32)[None, :]
    cb = col_bias.to(torch.float32)[None, :]
    out = _exact_rows(xq, w_q, lambda _, acc: fma_f32(
        acc.to(torch.float32), sv, cb), out_dtype)
    return (out, xq) if return_codes else out


def matmul_w8a8_staticq(x: torch.Tensor, w_q: torch.Tensor,
                        scale_vec: torch.Tensor, col_bias: torch.Tensor, *,
                        inv_delta: float, offset: float, num_steps: float,
                        out_dtype: torch.dtype = torch.float32,
                        return_codes: bool = False):
    """Static-encoding INT8 matmul: x (M, K) f32/bf16 quantized on the
    frozen [0, num_steps] grid of (Δ = 1/inv_delta, offset) and shifted to
    signed int8, times int8 codes w_q (K, N), then acc * scale_vec (N,) +
    col_bias (N,) -> (M, N) ``out_dtype``. ``inv_delta``, ``offset`` and
    ``num_steps`` are Python floats (the frozen encoding is a deployment
    constant). With ``return_codes`` the activation codes come back too.

    On CUDA tensors it launches kernel KSQ (``csrc/w8a8_staticq.cu``: the
    codes, then the int8 GEMM by one of two routes picked from the shapes:
    above 64 rows with K and N multiples of 16 and at least
    ``STATICQ_TILE_MIN_TILES`` output tiles (:func:`w8a8_staticq_tile_route`)
    the TMA + ``wgmma`` tile (``csrc/wgmma_wo_tile.cuh``, int8 MMAs, no
    split K), else its block tile, splitting K by :func:`decode_splits`);
    ``.routes`` and ``.shapes`` count them. On CPU tensors it takes
    :func:`matmul_w8a8_staticq_torch`. All give the same bits."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match w_q "
                         f"{tuple(w_q.shape)}")
    M, K = x.shape
    N = w_q.shape[1]
    if scale_vec.shape != (N,) or col_bias.shape != (N,):
        raise ValueError(f"scale_vec {tuple(scale_vec.shape)} and col_bias "
                         f"{tuple(col_bias.shape)} must be ({N},)")
    if not on_cuda(x, w_q, scale_vec, col_bias):
        return matmul_w8a8_staticq_torch(
            x, w_q, scale_vec, col_bias, inv_delta=inv_delta, offset=offset,
            num_steps=num_steps, out_dtype=out_dtype,
            return_codes=return_codes)
    if x.dtype not in _GEMM_DTYPES or out_dtype not in _GEMM_DTYPES:
        raise TypeError(f"matmul_w8a8_staticq takes float32 or bfloat16 x "
                        f"and output, got {x.dtype} -> {out_dtype}")
    for t, dt in ((w_q, torch.int8), (scale_vec, torch.float32),
                  (col_bias, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
    inv, shift, hi = _staticq_constants(inv_delta, offset, num_steps)
    # the kernels read 16-byte vectors: contiguous, 16-byte aligned operands
    x, w_q, scale_vec, col_bias = (
        t.contiguous() for t in (x, w_q, scale_vec, col_bias))
    w_q, scale_vec, col_bias = (t if t.data_ptr() % 16 == 0 else t.clone()
                                for t in (w_q, scale_vec, col_bias))
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    tile = w8a8_staticq_tile_route(M, N, K)
    _count(matmul_w8a8_staticq, "tile" if tile else "s8_tile", x, out)
    _build.launch("aimet_staticq_quant", x.data_ptr(), xq.data_ptr(), M, K,
                  inv, shift, hi, int(x.dtype == torch.bfloat16),
                  _build.stream_ptr(x.device))
    (_launch_staticq_tile if tile else _launch_staticq_s8_tile)(
        xq, w_q, scale_vec, col_bias, out)
    return (out, xq) if return_codes else out


matmul_w8a8_staticq.launches = 0
matmul_w8a8_staticq.routes = {"tile": 0, "s8_tile": 0}
matmul_w8a8_staticq.shapes = {}


# the output tiles (128 x 256) from which KSQ's tile beats its block tile,
# measured on the H100 (chip_smoke.new_tile_sweep, PERF.md): mixed at 8
# (slower at M = 192, N = 1024), faster at every count from 12 up, at K
# 4096 and 14336
STATICQ_TILE_MIN_TILES = 12


def w8a8_staticq_tile_route(M: int, N: int, K: int) -> bool:
    """Whether KSQ's GEMM takes its TMA + ``wgmma`` tile: M from
    ``TILE_MIN_M`` up, K and N multiples of 16 (the codes' TMA boxes start
    16-byte aligned: an unaligned box hangs the load) and at least
    ``STATICQ_TILE_MIN_TILES`` output tiles (:func:`tile_count`; below, the
    block tile, which splits K, is faster)."""
    return (M >= TILE_MIN_M and K % 16 == 0 and N % 16 == 0
            and tile_count(M, N, torch.int8) >= STATICQ_TILE_MIN_TILES)


def _launch_staticq_tile(xq, w_q, scale_vec, col_bias, out):
    """KSQ's GEMM on its TMA + ``wgmma`` tile: the codes xq (M, K) int8
    times w_q (K, N) int8, then fma(acc, scale_vec, col_bias), on
    contiguous, aligned CUDA operands."""
    (M, K), N = xq.shape, w_q.shape[1]
    _build.launch("aimet_staticq_tile_gemm", xq.data_ptr(), w_q.data_ptr(),
                  scale_vec.data_ptr(), col_bias.data_ptr(), out.data_ptr(),
                  M, N, K, int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(xq.device))
    return out


def _launch_staticq_s8_tile(xq, w_q, scale_vec, col_bias, out):
    """KSQ's GEMM on its ``mma.sync`` block tile (as
    :func:`_launch_staticq_tile`), splitting K by :func:`decode_splits`
    into a zeroed int32 buffer."""
    (M, K), N = xq.shape, w_q.shape[1]
    steps = -(-K // _S8_STEP_K)
    splits = _used_splits(steps, decode_splits(M, N, steps))
    ws = (torch.zeros((M, N), dtype=torch.int32, device=xq.device)
          if splits > 1 else out)
    _build.launch("aimet_staticq_gemm", xq.data_ptr(), w_q.data_ptr(),
                  scale_vec.data_ptr(), col_bias.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), M, N, K, splits,
                  int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(xq.device))
    return out


# --------------------------------------------------------------------------
# dynamic full INT8 (KW8A8, KQ8)
# --------------------------------------------------------------------------

def int8_matmul_int32_torch(x_q: torch.Tensor, w_q: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of :func:`int8_matmul_int32`: the exact int32 sums."""
    return _exact_rows(x_q, w_q, lambda _, acc: acc, torch.int32)


def matmul_q8_torch(x_q: torch.Tensor, x_scale: torch.Tensor,
                    w_q: torch.Tensor, w_scale: torch.Tensor,
                    col_bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`matmul_q8`: the exact int32 sums, then
    (f32(acc) * sx) * sw, or fma(f32(acc) * sx, sw, col_bias) with a
    column bias (XLA contracts the JAX kernel's ``acc * sx * sw + bias``
    into that FMA on the CPU)."""
    sx = x_scale.to(torch.float32)[:, None]
    sw = w_scale.to(torch.float32)[None, :]
    cb = None if col_bias is None else col_bias.to(torch.float32)[None, :]

    def epilogue(rows, acc):
        a = acc.to(torch.float32) * sx[rows]
        return a * sw if cb is None else fma_f32(a, sw, cb)

    return _exact_rows(x_q, w_q, epilogue, out_dtype)


def matmul_w8a8_torch(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version of :func:`matmul_w8a8` (the JAX package's
    ``matmul_w8a8_xla``, quantizing in f32 as its TPU kernel does)."""
    x_q, x_scale = _quantize_activation_plain(x)
    return matmul_q8_torch(x_q, x_scale, w_q, w_scale,
                           out_dtype=out_dtype or x.dtype)


def _check_q8(x, w_q, w_scale, col_bias=None):
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match w_q "
                         f"{tuple(w_q.shape)}")
    N = w_q.shape[1]
    for t in (w_scale, col_bias):
        if t is not None and t.shape != (N,):
            raise ValueError(f"per-column vectors must be ({N},), got "
                             f"{tuple(t.shape)}")


def _q8_buffers(x, w_q, dtype):
    """(w_q contiguous and aligned, out, ws, splits) for a KQ8 launch; an
    int32 output is its own zeroed split-K buffer."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    w_q = w_q.contiguous()
    w_q = w_q if w_q.data_ptr() % 16 == 0 else w_q.clone()
    (M, K), N = x.shape, w_q.shape[1]
    steps = -(-K // _S8_STEP_K)
    splits = _used_splits(steps, decode_splits(M, N, steps))
    split_int = splits > 1 and dtype == torch.int32
    out = (torch.zeros if split_int else torch.empty)(
        (M, N), dtype=dtype, device=x.device)
    ws = (torch.zeros((M, N), dtype=torch.int32, device=x.device)
          if splits > 1 and not split_int else out)
    return w_q, out, ws, splits


_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

# the output tiles (128 x 256) from which KQ8's tile beats its block tile
# (which splits K), measured on the H100 (chip_smoke.q8_tile_sweep,
# PERF.md): faster from 16 at K 1152, 4096 and 14336; at 12 faster at K =
# 4096 and slower at K = 14336; at 8 slower but at K = 1152, N = 512
Q8_TILE_MIN_TILES = 16


def q8_tile_route(M: int, N: int, K: int) -> bool:
    """Whether KQ8's f32 / bf16 entries take the TMA + ``wgmma`` tile: M
    from ``TILE_MIN_M`` up, K and N multiples of 16 (the codes' TMA boxes
    start 16-byte aligned: an unaligned box hangs the load) and at least
    ``Q8_TILE_MIN_TILES`` output tiles (:func:`tile_count`; below, the
    block tile, which splits K, is faster)."""
    return (M >= TILE_MIN_M and K % 16 == 0 and N % 16 == 0
            and tile_count(M, N, torch.int8) >= Q8_TILE_MIN_TILES)


def _q8_vectors(*vs):
    """KQ8's f32 vectors, contiguous and 16-byte aligned (None stays
    None)."""
    out = []
    for v in vs:
        if v is not None:
            v = v.to(torch.float32).contiguous()
            v = v if v.data_ptr() % 16 == 0 else v.clone()
        out.append(v)
    return out


def _launch_q8(x_q, x_scale, w_q, w_scale, col_bias, dtype):
    if x_q.dtype != torch.int8:
        raise TypeError(f"x_q must be int8, got {x_q.dtype}")
    x_q = x_q.contiguous()
    x_q = x_q if x_q.data_ptr() % 16 == 0 else x_q.clone()
    (M, K), N = x_q.shape, w_q.shape[1]
    if dtype != torch.int32 and q8_tile_route(M, N, K):
        out = torch.empty((M, N), dtype=dtype, device=x_q.device)
        return _launch_q8_tile(x_q, x_scale, w_q, w_scale, col_bias, out)
    return _launch_q8_s8_tile(x_q, x_scale, w_q, w_scale, col_bias, dtype)


def _launch_q8_s8_tile(x_q, x_scale, w_q, w_scale, col_bias, dtype):
    """KQ8's ``mma.sync`` block tile (any entry) on a contiguous, aligned
    x_q, splitting K by :func:`decode_splits`."""
    w_q, out, ws, splits = _q8_buffers(x_q, w_q, dtype)
    sx, sw, cb = (0 if t is None else t.data_ptr()
                  for t in _q8_vectors(x_scale, w_scale, col_bias))
    (M, K), N = x_q.shape, w_q.shape[1]
    _count(matmul_q8, "s8_tile", x_q, out)
    _build.launch("aimet_q8_gemm", x_q.data_ptr(), sx, w_q.data_ptr(), sw,
                  cb, out.data_ptr(), ws.data_ptr(), M, N, K, splits,
                  _OUT_KIND[dtype], _build.stream_ptr(x_q.device))
    return out


def _launch_q8_tile(x_q, x_scale, w_q, w_scale, col_bias, out):
    """KQ8's TMA + ``wgmma`` tile on a contiguous, aligned x_q: the codes
    x_q (M, K) int8 times w_q (K, N) int8, then (acc * sx) * sw or
    fma(acc * sx, sw, col_bias), into ``out`` (f32 or bf16)."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    w_q = w_q.contiguous()
    w_q = w_q if w_q.data_ptr() % 16 == 0 else w_q.clone()
    sx, sw, cb = _q8_vectors(x_scale, w_scale, col_bias)
    (M, K), N = x_q.shape, w_q.shape[1]
    _count(matmul_q8, "tile", x_q, out)
    _build.launch("aimet_q8_tile_gemm", x_q.data_ptr(), sx.data_ptr(),
                  w_q.data_ptr(), sw.data_ptr(),
                  0 if cb is None else cb.data_ptr(), out.data_ptr(), M, N,
                  K, int(out.dtype == torch.bfloat16),
                  _build.stream_ptr(x_q.device))
    return out


def matmul_q8(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
              w_scale: torch.Tensor, col_bias: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 x int8 -> int32 matmul with a per-row x per-column scale
    epilogue: x_q (M, K) int8, x_scale (M,) f32, w_q (K, N) int8, w_scale
    (N,) f32, optional col_bias (N,) f32 -> (M, N) ``out_dtype`` (f32 or
    bf16). On CUDA tensors it launches kernel KQ8 (``csrc/w8a8_gemm.cu``)
    by one of two routes picked from the shapes: above 64 rows with K and
    N multiples of 16 and at least ``Q8_TILE_MIN_TILES`` output tiles
    (:func:`q8_tile_route`) the TMA + ``wgmma`` tile
    (``csrc/wgmma_wo_tile.cuh``, int8 MMAs, no split K), else its block
    tile, splitting K by :func:`decode_splits`; ``.routes`` and ``.shapes``
    count them (the int32 entry's K-major route as ``int32_kmajor``). On
    CPU tensors it takes :func:`matmul_q8_torch`. All give the same
    bits."""
    _check_q8(x_q, w_q, w_scale, col_bias)
    if x_scale.shape != (x_q.shape[0],):
        raise ValueError(f"x_scale must be ({x_q.shape[0]},), got "
                         f"{tuple(x_scale.shape)}")
    if not on_cuda(x_q, x_scale, w_q, w_scale, col_bias):
        return matmul_q8_torch(x_q, x_scale, w_q, w_scale, col_bias,
                               out_dtype)
    if out_dtype not in _GEMM_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    return _launch_q8(x_q, x_scale, w_q, w_scale, col_bias, out_dtype)


matmul_q8.launches = 0
matmul_q8.routes = {"tile": 0, "s8_tile": 0, "int32_kmajor": 0}
matmul_q8.shapes = {}


_Q8_BM, _Q8_BK = 128, 128      # KQ8's K-major route: M tile, K step


def _rows16(t: torch.Tensor) -> bool:
    """A 2-D int8 tensor whose rows are unit-stride and 16-byte aligned."""
    return (t.stride(1) == 1 and t.stride(0) % 16 == 0
            and t.data_ptr() % 16 == 0)


def q8_kmajor_splits(M: int, N: int, K: int) -> int:
    """The K splits of KQ8's K-major route: none unless the 128 x BN output
    tiles (BN 64 for N <= 64, else 128) fill under a quarter of the SMs (a
    small-M call); then enough to fill them, each split at least four
    128-wide K steps. Beyond that the zeroed output and the atomic adds
    cost more than the idle SMs (``chip_smoke.py``'s split sweep, PERF.md
    §6)."""
    tiles = -(-M // _Q8_BM) * -(-N // (64 if N <= 64 else 128))
    steps = -(-K // _Q8_BK)
    if 4 * tiles > _SMS:
        return 1
    return _used_splits(steps, max(1, min(-(-_SMS // tiles), steps // 4)))


def int8_matmul_int32(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums x_q (M, K) int8 @ w_q (K, N) int8. On CUDA
    tensors it launches KQ8's int32 entry (counted in
    ``matmul_q8.launches``): the TMA + wgmma route when ``w_q`` is a
    transposed view of a K-major (N, K) weight (strides (1, ldb)) and both
    operands' rows are 16-byte aligned (no copy is made), else the
    ``mma.sync`` tile on a contiguous N-major weight. On CPU tensors it
    takes :func:`int8_matmul_int32_torch`."""
    _check_q8(x_q, w_q, None)
    if not on_cuda(x_q, w_q):
        return int8_matmul_int32_torch(x_q, w_q)
    for t in (x_q, w_q):
        if t.dtype != torch.int8:
            raise TypeError(f"expected int8 operands, got {t.dtype}")
    wt = w_q.t()                                   # (N, K)
    if not (_rows16(x_q) and _rows16(wt)):
        return _launch_q8(x_q, None, w_q, None, None, torch.int32)
    (M, K), N = x_q.shape, w_q.shape[1]
    splits = q8_kmajor_splits(M, N, K)
    out = (torch.zeros if splits > 1 else torch.empty)(
        (M, N), dtype=torch.int32, device=x_q.device)
    _count(matmul_q8, "int32_kmajor", x_q, out)
    _build.launch("aimet_q8_int32_kmajor", x_q.data_ptr(), x_q.stride(0),
                  wt.data_ptr(), wt.stride(0), out.data_ptr(), M, N, K,
                  splits, _build.stream_ptr(x_q.device))
    return out


def matmul_w8a8_fusedq(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Full INT8 with the per-row dynamic activation quantization in f32:
    x (M, K) f32/bf16, w_q (K, N) int8, w_scale (N,) f32 -> (M, N)
    ``out_dtype`` (default x's dtype). On CUDA tensors it launches K1
    (:func:`quantize_activation_per_row`) then KQ8 (:func:`matmul_q8`, on
    its tile at prefill M), counted once here as KW8A8 and once in each of
    theirs; on CPU tensors it takes :func:`matmul_w8a8_torch`. Both give
    the same bits. (The TPU kernel quantizes each row into VMEM so the
    codes never reach HBM; here they take one extra write and read of M x
    K bytes.)"""
    _check_q8(x, w_q, w_scale)
    out_dtype = out_dtype or x.dtype
    if not on_cuda(x, w_q, w_scale):
        return matmul_w8a8_torch(x, w_q, w_scale, out_dtype)
    x_q, x_scale = quantize_activation_per_row(x)
    matmul_w8a8_fusedq.launches += 1
    return matmul_q8(x_q, x_scale, w_q, w_scale, out_dtype=out_dtype)


matmul_w8a8_fusedq.launches = 0


def matmul_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Full INT8: per-row dynamic INT8 activations (in f32) x int8 weights
    w_q (K, N) with per-column scales -> (M, N) ``out_dtype`` (default x's
    dtype), :func:`matmul_w8a8_fusedq` at every K. (The JAX package routes
    K > 8192 or a given ``block_k`` to a K-split kernel that quantizes a
    bf16 x in bf16; the port quantizes in f32 at every K, and its kernels
    take no block sizes.)"""
    return matmul_w8a8_fusedq(x, w_q, w_scale, out_dtype)
