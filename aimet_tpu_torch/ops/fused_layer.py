"""Fused decode-layer blocks — counterpart of
``aimet_tpu/ops/fused_layer.py``:

- ``fused_wo_mlp``: W_o + residual + RMSNorm + SwiGLU MLP (+ the next
  layer's attention norm and QKV) in one launch. On CUDA tensors it
  launches kernel KFL (``csrc/fused_layer.cu``, a persistent cooperative
  kernel); on CPU tensors it takes the plain version
  ``fused_wo_mlp_torch``, the per-op composition with the kernel's
  rounding points.
- ``fused_decode_layer``: one entire decode layer, the attention (rope,
  INT8-KV append, GQA) in front of the block above. On CUDA tensors it
  launches the same kernel with its attention phase (KDL: the code KSOL of
  ``ops/decode_layer_sol.py`` runs, weight-only, counted on its own); on
  CPU tensors it takes ``fused_decode_layer_torch``.

All weights are split-half INT4 with per-column f32 scales. Gate and up
come in either of the JAX package's two forms (``gate_up_pairs``): two
(D/2, F) arrays, or one (D/2, 2F) array (the serving ``w_gateup``) passed
as both with ``up_block_offset``. The kernel addresses gate and up
through two pointers and one row stride, so no weight column is ever
copied. The block sizes are accepted as the JAX functions take them and
used only to locate up in the concatenated form: the kernel deals its own
work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .._device import on_cuda
from .decode_attention_fused import (attention_kernel_shape_ok,
                                     fused_decode_attention_torch, positions,
                                     scalar_position, score_workspace)
from .int_matmul import (DECODE_WIDTH, decode_plan, matmul_w4_torch,
                         matmul_w4a8_torch)
from .kv_cache import reciprocal

MAX_ROWS = 64          # rows (decode slots) the kernels take in one launch
_WARPS = 9             # warps a block of the kernel (8 consumers, 1 producer)
# A (N_STAMPS,) int64 CUDA tensor, or None: when set, every launch of the
# whole-layer kernel writes block 0's %globaltimer into it (the phase split
# that chip_smoke.py prints): at kernel start (slot 0), after each
# grid-wide barrier, in STAMP_GEMMS after a GEMM phase, in STAMP_ATTENTION
# and STAMP_INT8_ROWS after phase 0 and its output's row quantization,
# in the other slots after an epilogue, and at its end (slot 11). None on
# every main-path launch.
N_STAMPS = 12
STAMP_ATTENTION, STAMP_INT8_ROWS, STAMP_GEMMS = 1, 2, (3, 5, 8, 10)
STAMPS: Optional[torch.Tensor] = None
_PTRS = ("attn_out", "resid", "mlp_gamma", "attn_gamma", "out", "qkv_next",
         "wo", "so", "wg", "sg", "wu", "su", "wd", "sd", "wq", "sq", "ao",
         "y", "xbuf", "xq", "sx", "part", "cnt", "rowpart", "qkv", "cosb",
         "sinb", "kc", "vc", "ks", "vs", "iks", "ivs", "pos", "scores",
         "stamps")
_INTS = ("M", "A", "D", "F", "Nq", "ld_gu", "S", "H", "KH", "HD", "part_n",
         "rowpart_n")


class _Args(ctypes.Structure):
    """``FusedLayerArgs`` of ``csrc/fused_layer.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("eps", ctypes.c_float), ("sqrt_d", ctypes.c_float)])


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The fused kernels' RMSNorm (``fused_layer.py:94-96``):
    ((xf * rsqrt(mean(xf^2) + eps)).astype(dt) * gamma).astype(dt)."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * gamma.to(x.dtype)


def _proj(x, pair, int8_dots: bool) -> torch.Tensor:
    """x @ split-half INT4 weight, f32 result: weight-only, or with x
    quantized per row first (true W4A8, exact int32 sums)."""
    mm = matmul_w4a8_torch if int8_dots else matmul_w4_torch
    return mm(x, pair[0], pair[1], torch.float32)


def gate_up_pairs(gate_pair, up_pair, D: int, *, block_g: int = 1024,
                  up_block_offset: int = 0, n_f: int = 0):
    """Gate and up in either form of the JAX package
    (``fused_layer.py:160-188``) -> ((w_gate, s_gate), (w_up, s_up)), each
    weight a (D/2, F) view of what was passed (no copy), each scale (F,).

    Two (D/2, F) arrays; or, with ``up_block_offset`` > 0, one (D/2, 2F)
    array passed as both, up at column ``up_block_offset * min(block_g, F)``
    (which must be F), with ``n_f = F`` and the scales' halves."""
    wg, sg = gate_pair
    wu, su = up_pair
    F = n_f or wg.shape[1]
    col = up_block_offset * min(block_g, F)
    want_up = (D // 2, 2 * F if up_block_offset else F)
    if up_block_offset and col != F:
        raise ValueError(f"up_block_offset {up_block_offset} x block "
                         f"{min(block_g, F)} does not locate up at column {F}")
    if (tuple(wu.shape) != want_up or wg.dim() != 2 or wg.shape[0] != D // 2
            or wg.shape[1] < F):
        raise ValueError(f"gate {tuple(wg.shape)} / up {tuple(wu.shape)} do "
                         f"not hold F={F} columns of D/2={D // 2} rows "
                         f"(up_block_offset={up_block_offset})")
    for s in (sg, su):
        if tuple(s.shape) != (F,):
            raise ValueError(f"gate / up scales must be ({F},), got "
                             f"{tuple(s.shape)}")
    return (wg[:, :F], sg), (wu[:, col:col + F], su)


def split_gateup(gateup_pair):
    """The serving layout (w_gateup (D/2, 2F), scales (2F,)) -> gate and up
    pairs as views, up at column F."""
    w, s = gateup_pair
    F = w.shape[1] // 2
    return (w[:, :F], s[:F]), (w[:, F:], s[F:])


def fused_wo_mlp_torch(attn_out, resid, wo_pair, gate_pair, up_pair,
                       down_pair, mlp_gamma, *, eps: float = 1e-5,
                       block_a: int = 2048, block_g: int = 1024,
                       block_d: int = 512, block_q: int = 0,
                       up_block_offset: int = 0, n_f: int = 0,
                       next_qkv=None, int8_dots: bool = False):
    """Plain version of :func:`fused_wo_mlp` (``int8_dots`` gives the
    phases of the whole-layer kernel in W4A8 mode)."""
    del block_a, block_d, block_q
    dt = resid.dtype
    gate, up = gate_up_pairs(gate_pair, up_pair, resid.shape[1],
                             block_g=block_g,
                             up_block_offset=up_block_offset, n_f=n_f)
    y = _proj(attn_out.to(dt), wo_pair, int8_dots).to(dt) + resid
    yh = rms_norm(y, mlp_gamma, eps)
    g, u = _proj(yh, gate, int8_dots), _proj(yh, up, int8_dots)
    h = (g * torch.sigmoid(g) * u).to(dt)
    out = _proj(h, down_pair, int8_dots).to(dt) + y
    if next_qkv is None:
        return out
    wq_pair, attn_gamma = next_qkv
    qkv = _proj(rms_norm(out, attn_gamma, eps), wq_pair, int8_dots).to(dt)
    return out, qkv


def check_block_shapes(M, A, D, wo_pair, gate, up, down_pair, next_qkv):
    """Raise unless the weights fit attn_out (M, A) and resid (M, D); gate
    and up as :func:`gate_up_pairs` returns them."""
    F = gate[0].shape[1]
    want = [(wo_pair, (A // 2, D)), (gate, (D // 2, F)), (up, (D // 2, F)),
            (down_pair, (F // 2, D))]
    if next_qkv is not None:
        want.append((next_qkv[0], (D // 2, next_qkv[0][0].shape[1])))
    for (w, s), shape in want:
        if tuple(w.shape) != shape or tuple(s.shape) != (shape[1],):
            raise ValueError(f"weight {tuple(w.shape)} / scale "
                             f"{tuple(s.shape)} where {shape} was expected")
    if A % 2 or D % 2 or F % 2:
        raise ValueError(f"A, D and F must be even, got {A}, {D}, {F}")


def fused_wo_mlp(attn_out, resid, wo_pair, gate_pair, up_pair, down_pair,
                 mlp_gamma, *, eps: float = 1e-5, block_a: int = 2048,
                 block_g: int = 1024, block_d: int = 512, block_q: int = 0,
                 up_block_offset: int = 0, n_f: int = 0, next_qkv=None):
    """out = y + bf16(h @ W_down), y = resid + bf16(attn_out @ W_o),
    h = silu(g) * u with g, u = rmsnorm(y, mlp_gamma) @ W_gate, W_up — all
    weight-only INT4 (split-half packed, per-column scales).

    attn_out (M, A), resid (M, D); wo (A/2, D); gate and up as
    :func:`gate_up_pairs` takes them (two (D/2, F) arrays, or one (D/2, 2F)
    array with ``up_block_offset`` and ``n_f``); down (F/2, D); the result
    has resid's dtype. ``next_qkv = ((wqkv, wqkv_scale), attn_gamma)`` adds
    the next layer's attention norm and QKV projection and returns
    ``(out, qkv)``. The JAX signature: block sizes are accepted and used
    only to locate up.

    On CUDA tensors (bf16, M <= 64) it launches kernel KFL; on CPU
    tensors it takes :func:`fused_wo_mlp_torch`."""
    M, A = attn_out.shape
    D = resid.shape[1]
    gate, up = gate_up_pairs(gate_pair, up_pair, D, block_g=block_g,
                             up_block_offset=up_block_offset, n_f=n_f)
    check_block_shapes(M, A, D, wo_pair, gate, up, down_pair, next_qkv)
    if not on_cuda(attn_out, resid, wo_pair[0], gate[0], up[0],
                   down_pair[0]):
        return fused_wo_mlp_torch(attn_out, resid, wo_pair, gate, up,
                                  down_pair, mlp_gamma, eps=eps,
                                  next_qkv=next_qkv)
    fused_wo_mlp.launches += 1
    out, qkv = launch_layer(
        dict(attn_out=operand(attn_out, resid.dtype)), resid, wo_pair, gate,
        up, down_pair, mlp_gamma, eps, next_qkv, A=A, int8=False)
    return out if next_qkv is None else (out, qkv)


fused_wo_mlp.launches = 0


def decode_layer_shapes(qkv, resid, k_cache, n_heads: int,
                        n_kv_heads: int):
    """(B, S, KH, D) of the caches, flat (B, S, KH*D) or 4-D; raises on
    operands that do not fit each other."""
    H, KH = n_heads, n_kv_heads
    B = qkv.shape[0]
    shape = tuple(k_cache.shape)
    if len(shape) == 3 and KH and shape[2] % KH == 0:
        shape = (*shape[:2], KH, shape[2] // KH)
    if (len(shape) != 4 or shape[0] != B or shape[2] != KH or H % KH
            or resid.shape[0] != B or qkv.shape != (B, (H + 2 * KH)
                                                    * shape[3])):
        raise ValueError(f"shape mismatch: qkv {tuple(qkv.shape)}, resid "
                         f"{tuple(resid.shape)}, cache {tuple(k_cache.shape)},"
                         f" H={H}, KH={KH}")
    return shape


def fused_decode_layer_torch(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                             cache_index, cos, sin, wo_pair, gate_pair,
                             up_pair, down_pair, mlp_gamma, *,
                             eps: float = 1e-5, block_a: int = 2048,
                             block_g: int = 1024, block_d: int = 512,
                             block_q: int = 0, up_block_offset: int = 0,
                             n_f: int = 0, next_qkv=None, has_next=None,
                             n_heads: int, n_kv_heads: int,
                             int8_dots: bool = False):
    """Plain version of :func:`fused_decode_layer` (and, with per-row
    positions and ``int8_dots``, of ``sol_decode_layer``): the plain decode
    attention, then the plain fused block, the composition the JAX tests
    hold the TPU kernel to (``tests/test_fused_layer.py:125-131``)."""
    del block_a, block_d, block_q, has_next
    shape = decode_layer_shapes(qkv, resid, k_cache, n_heads, n_kv_heads)
    ao, _, _ = fused_decode_attention_torch(
        qkv.to(resid.dtype), cos.reshape(-1, shape[3] // 2),
        sin.reshape(-1, shape[3] // 2), k_cache.view(shape),
        v_cache.view(shape), k_scale, v_scale, cache_index, n_heads=n_heads,
        n_kv_heads=n_kv_heads)
    res = fused_wo_mlp_torch(ao, resid, wo_pair, gate_pair, up_pair,
                             down_pair, mlp_gamma, eps=eps, block_g=block_g,
                             up_block_offset=up_block_offset, n_f=n_f,
                             next_qkv=next_qkv, int8_dots=int8_dots)
    if next_qkv is None:
        return res, k_cache, v_cache
    return res[0], res[1], k_cache, v_cache


def fused_decode_layer(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                       cache_index, cos, sin, wo_pair, gate_pair, up_pair,
                       down_pair, mlp_gamma, *, eps: float = 1e-5,
                       block_a: int = 2048, block_g: int = 1024,
                       block_d: int = 512, block_q: int = 0,
                       up_block_offset: int = 0, n_f: int = 0,
                       next_qkv=None, has_next=None, n_heads: int,
                       n_kv_heads: int):
    """One entire decode layer, with the JAX package's signature
    (``fused_layer.py:348-358``).

    qkv (B, (H + 2 KH) D) this layer's QKV projection; resid (B, Dm);
    caches flat (B, S, KH*D) or (B, S, KH, D) int8, appended IN PLACE at
    ``cache_index`` and returned as the tensors passed (same layout, no
    copy); ``cache_index`` one position for every row (a vector raises);
    k_scale/v_scale (B, KH); cos/sin (1 or B, D/2) f32 rope rows. Weights
    as :func:`fused_wo_mlp`; ``next_qkv = ((wqkv, scale), attn_gamma)``
    for every layer but the last. Weight-only INT4 throughout.

    Returns (out, next_qkv, k_cache, v_cache), or (out, k_cache, v_cache)
    without ``next_qkv``. On CUDA tensors (bf16, B <= 64) it launches the
    whole-layer kernel with its attention phase, KDL (``csrc/fused_layer.cu``,
    KSOL's code weight-only; the TPU's grid-pipelined and manual-DMA
    kernels differ only in how Mosaic moves weights, so one kernel serves
    both), and counts ``fused_decode_layer.launches``. No weight is copied:
    gate and up reach the kernel as pointers into the arrays passed, the
    concatenated form with a row stride of 2F. None of the TPU's layout
    gates (D % 128, S % 32, B % 8) apply. On CPU tensors it takes
    :func:`fused_decode_layer_torch`."""
    pos = scalar_position(cache_index)
    B, S, KH, D = decode_layer_shapes(qkv, resid, k_cache, n_heads,
                                      n_kv_heads)
    Dm = resid.shape[1]
    gate, up = gate_up_pairs(gate_pair, up_pair, Dm, block_g=block_g,
                             up_block_offset=up_block_offset, n_f=n_f)
    check_block_shapes(B, n_heads * D, Dm, wo_pair, gate, up, down_pair,
                       next_qkv)
    if not on_cuda(qkv, resid, k_cache, v_cache, wo_pair[0], gate[0]):
        return fused_decode_layer_torch(
            qkv, resid, k_cache, v_cache, k_scale, v_scale, pos, cos, sin,
            wo_pair, gate, up, down_pair, mlp_gamma, eps=eps,
            next_qkv=next_qkv, n_heads=n_heads, n_kv_heads=n_kv_heads)
    kc, vc = (t.view(B, S, KH, D) for t in (k_cache, v_cache))
    fused_decode_layer.launches += 1
    out, qkvn = launch_attention_layer(
        qkv, resid, kc, vc, k_scale, v_scale, pos, cos, sin, wo_pair, gate,
        up, down_pair, mlp_gamma, eps, next_qkv, n_heads=n_heads,
        int8=False)
    if next_qkv is None:
        return out, k_cache, v_cache
    return out, qkvn, k_cache, v_cache


fused_decode_layer.launches = 0


@functools.cache
def _grid(device_index: int, attn: int, int8: int, smem: int) -> int:
    n = ctypes.c_int(0)
    _build.launch("aimet_fused_layer_grid", attn, int8, smem,
                  ctypes.addressof(n))
    return n.value


def operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous, 16-byte aligned tensor of ``dtype`` (the kernel reads
    16-byte vectors); float tensors are cast, integer codes never are."""
    if t.dtype != dtype:
        if torch.int8 in (dtype, t.dtype):
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        t = t.to(dtype)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _gate_up_strides(gate, up) -> int:
    """The row stride gate and up share (their columns may be a range of a
    wider array); raises where the kernel cannot address them as they
    are."""
    wg, wu = gate[0], up[0]
    for w in (wg, wu):
        if w.dtype != torch.int8 or w.stride(1) != 1:
            raise ValueError(f"gate and up must be int8 with unit column "
                             f"stride, got {w.dtype} strides {w.stride()}")
    if wg.stride(0) != wu.stride(0):
        raise ValueError(f"gate and up must share a row stride, got "
                         f"{wg.stride(0)} and {wu.stride(0)}")
    if wg.stride(0) % 16 or wg.data_ptr() % 16 or wu.data_ptr() % 16:
        raise ValueError("gate and up must start 16-byte aligned with a row "
                         "stride a multiple of 16 (the kernel's 16-byte "
                         "copies)")
    return wg.stride(0)


def layer_shapes_ok(A: int, D: int, F: int, Nq: int) -> bool:
    """Whether the whole-layer kernels take these widths: A (the attention
    output), D and F multiples of 32, Nq (the next layer's QKV, 0 for
    none) a multiple of 16 (the decode streaming routine's 16-byte
    copies of split-half rows)."""
    return A % 32 == 0 and D % 32 == 0 and F % 32 == 0 and Nq % 16 == 0


def layer_workspace(M: int, A: int, D: int, F: int, Nq: int,
                    blocks: int) -> Tuple[int, int]:
    """Workspace of one launch of the whole-layer kernel on a grid of
    ``blocks``: (f32 / int32 partial sums, the largest GEMM phase's;
    f32 row partials of RMSNorm's sums of squares, M x the epilogue items
    of a row, 4 x DECODE_WIDTH columns each). The kernel's C entry refuses
    smaller ones."""
    plans = [decode_plan(M, D, A // 2, blocks),
             decode_plan(M, F, D // 2, blocks, halves=2),
             decode_plan(M, D, F // 2, blocks)]
    if Nq:
        plans.append(decode_plan(M, Nq, D // 2, blocks))
    return (max(p.ws_values for p in plans),
            M * -(-D // (4 * DECODE_WIDTH)))


def launch_attention_layer(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                           cache_index, cos, sin, wo_pair, gate, up,
                           down_pair, mlp_gamma, eps: float, next_qkv, *,
                           n_heads: int, int8: bool):
    """Launch the whole-layer kernel with its attention phase once (KSOL and
    KDL; the caller counts): caches (B, S, KH, D) contiguous int8, updated
    in place. Returns (out, next qkv or None)."""
    B, S, KH, D = k_cache.shape
    attention_kernel_shape_ok(n_heads, KH, D)
    for t in (k_cache, v_cache):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError("caches must be contiguous int8 (updated in "
                             "place)")
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    rope = lambda t: t.reshape(-1, D // 2).to(torch.float32).expand(
        B, D // 2).contiguous()
    extra = dict(qkv=operand(qkv, torch.bfloat16), cosb=rope(cos),
                 sinb=rope(sin), kc=k_cache, vc=v_cache, ks=ks, vs=vs,
                 iks=reciprocal(ks), ivs=reciprocal(vs),
                 pos=positions(cache_index, B, qkv.device))
    ws = score_workspace(B, KH, n_heads // KH, D, S, _WARPS, qkv.device)
    if ws is not None:                    # S too long for shared memory
        extra["scores"] = ws
    return launch_layer(
        extra, resid, wo_pair, gate, up, down_pair, mlp_gamma, eps,
        next_qkv, A=n_heads * D, int8=int8,
        attn=dict(S=S, H=n_heads, KH=KH, HD=D,
                  sqrt_d=float(np.float32(np.sqrt(D)))))


def launch_layer(extra: dict, resid, wo_pair, gate, up, down_pair,
                 mlp_gamma, eps: float, next_qkv, *, A: int, int8: bool,
                 attn: Optional[dict] = None) -> Tuple[torch.Tensor, ...]:
    """Launch ``csrc/fused_layer.cu`` once: KFL when ``attn`` is None,
    else the attention-phase kernel (KSOL, KDL) with the attention operands
    and sizes in ``attn``. ``extra`` holds further operands by field name,
    passed as they are (the caches are updated in place). Gate and up are
    (D/2, F) views sharing a row stride, passed by pointer. Returns
    (out (M, D), next qkv (M, Nq) or None)."""
    M, D = resid.shape
    F = gate[0].shape[1]
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"the fused layer kernels take 1..{MAX_ROWS} rows, "
                         f"got {M}")
    if resid.dtype != torch.bfloat16:
        raise TypeError(f"the fused layer kernels take bfloat16 "
                        f"activations, got {resid.dtype}")
    Nq = 0 if next_qkv is None else next_qkv[0][0].shape[1]
    if not layer_shapes_ok(A, D, F, Nq):
        raise ValueError(f"the fused layer kernels take A, D, F multiples "
                         f"of 32 and Nq of 16, got {A}, {D}, {F}, {Nq}")
    dev = resid.device
    bf = torch.bfloat16
    keep = []                             # operands alive until the launch

    def ptr(t, dtype):
        t = operand(t, dtype)
        keep.append(t)
        return t.data_ptr()

    args = _Args()
    for name, t in extra.items():
        setattr(args, name, t.data_ptr())
    args.resid = ptr(resid, bf)
    args.mlp_gamma = ptr(mlp_gamma, bf)
    for (w, s), pw, ps in ((wo_pair, "wo", "so"), (down_pair, "wd", "sd")):
        setattr(args, pw, ptr(w, torch.int8))
        setattr(args, ps, ptr(s, torch.float32))
    args.ld_gu = _gate_up_strides(gate, up)
    args.wg, args.wu = gate[0].data_ptr(), up[0].data_ptr()
    args.sg, args.su = ptr(gate[1], torch.float32), ptr(up[1], torch.float32)
    qkv_next = None
    if next_qkv is not None:
        (wq, sq), attn_gamma = next_qkv
        args.wq, args.sq = ptr(wq, torch.int8), ptr(sq, torch.float32)
        args.attn_gamma = ptr(attn_gamma, bf)
        qkv_next = torch.empty((M, Nq), dtype=bf, device=dev)
        args.qkv_next = ptr(qkv_next, bf)
    out = torch.empty((M, D), dtype=bf, device=dev)
    args.out = ptr(out, bf)

    is_attn = int(attn is not None)
    lib = _build.library()
    smem = lib.aimet_fused_layer_smem(
        is_attn, int(int8), *((attn["H"] // attn["KH"], attn["HD"],
                               0 if "scores" in extra else attn["S"])
                              if attn else (1, 0, 0)))
    grid = _grid(dev.index or 0, is_attn, int(int8), smem)
    args.part_n, args.rowpart_n = layer_workspace(M, A, D, F, Nq, grid)
    args.part = ptr(torch.empty((args.part_n,), dtype=torch.float32,
                                device=dev), torch.float32)
    args.rowpart = ptr(torch.empty((args.rowpart_n,), dtype=torch.float32,
                                   device=dev), torch.float32)
    args.cnt = ptr(torch.empty((3 * M,), dtype=torch.int32, device=dev),
                   torch.int32)
    args.y = ptr(torch.empty((M, D), dtype=bf, device=dev), bf)
    args.xbuf = ptr(torch.empty((M, max(D, F)), dtype=bf, device=dev), bf)
    if int8:
        args.xq = ptr(torch.empty((M, max(A, D, F)), dtype=torch.int8,
                                  device=dev), torch.int8)
        args.sx = ptr(torch.empty((4, M), dtype=torch.float32, device=dev),
                      torch.float32)
    if attn is not None:
        args.ao = ptr(torch.empty((M, A), dtype=bf, device=dev), bf)
        for name in ("S", "H", "KH", "HD"):
            setattr(args, name, attn[name])
        args.sqrt_d = attn["sqrt_d"]
    args.M, args.A, args.D, args.F, args.Nq = M, A, D, F, Nq
    args.eps = eps
    if STAMPS is not None:
        args.stamps = STAMPS.data_ptr()
    _build.launch("aimet_fused_layer", ctypes.addressof(args), is_attn,
                  int(int8), grid, smem, _build.stream_ptr(dev))
    return out, qkv_next
