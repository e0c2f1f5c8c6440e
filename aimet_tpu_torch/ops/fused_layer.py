"""Fused decode-layer block: W_o + residual + RMSNorm + SwiGLU MLP
(+ the next layer's attention norm and QKV) in one launch — counterpart of
``aimet_tpu/ops/fused_layer.py``'s ``fused_wo_mlp``.

On CUDA tensors ``fused_wo_mlp`` launches kernel KFL
(``csrc/fused_layer.cu``, a persistent cooperative kernel); on CPU tensors
it takes the plain version ``fused_wo_mlp_torch``, the per-op composition
with the kernel's rounding points. ``launch_layer`` also serves the
whole-layer kernel KSOL (``ops/decode_layer_sol.py``), which is the same
kernel with an attention phase in front.

All weights are split-half INT4 with per-column f32 scales. Gate and up
live concatenated in one (D/2, 2F) array (the serving ``w_gateup``
layout), so no column slice of a weight is ever copied. Unlike the TPU
kernel, no block sizes are taken: the kernel deals its own work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .._device import on_cuda
from .int_matmul import (_used_splits, matmul_w4_torch, matmul_w4a8_torch)

MAX_ROWS = 64          # rows (decode slots) the kernels take in one launch
_TILE_N = 128
_PTRS = ("attn_out", "resid", "mlp_gamma", "attn_gamma", "out", "qkv_next",
         "wo", "so", "wgu", "sgu", "wd", "sd", "wq", "sq", "ao", "y", "xbuf",
         "xq", "sx", "part", "qkv", "cosb", "sinb", "kc", "vc", "ks", "vs",
         "iks", "ivs", "pos")
_INTS = ("M", "A", "D", "F", "Nq", "split_a", "split_b", "split_c",
         "split_d", "S", "H", "KH", "HD")


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


def fused_wo_mlp_torch(attn_out, resid, wo_pair, gateup_pair, down_pair,
                       mlp_gamma, *, eps: float = 1e-5, next_qkv=None,
                       int8_dots: bool = False):
    """Plain version of :func:`fused_wo_mlp` (``int8_dots`` gives the
    phases of the whole-layer kernel in W4A8 mode)."""
    dt = resid.dtype
    F = gateup_pair[0].shape[1] // 2
    y = _proj(attn_out.to(dt), wo_pair, int8_dots).to(dt) + resid
    gu = _proj(rms_norm(y, mlp_gamma, eps), gateup_pair, int8_dots)
    g, u = gu[:, :F], gu[:, F:]
    h = (g * torch.sigmoid(g) * u).to(dt)
    out = _proj(h, down_pair, int8_dots).to(dt) + y
    if next_qkv is None:
        return out
    wq_pair, attn_gamma = next_qkv
    qkv = _proj(rms_norm(out, attn_gamma, eps), wq_pair, int8_dots).to(dt)
    return out, qkv


def check_block_shapes(M, A, D, F, wo_pair, gateup_pair, down_pair,
                       next_qkv):
    """Raise unless the weights fit attn_out (M, A) and resid (M, D)."""
    want = [(wo_pair, (A // 2, D)), (gateup_pair, (D // 2, 2 * F)),
            (down_pair, (F // 2, D))]
    if next_qkv is not None:
        want.append((next_qkv[0], (D // 2, next_qkv[0][0].shape[1])))
    for (w, s), shape in want:
        if tuple(w.shape) != shape or tuple(s.shape) != (shape[1],):
            raise ValueError(f"weight {tuple(w.shape)} / scale "
                             f"{tuple(s.shape)} where {shape} was expected")
    if A % 2 or D % 2 or F % 2:
        raise ValueError(f"A, D and F must be even, got {A}, {D}, {F}")


def fused_wo_mlp(attn_out, resid, wo_pair, gateup_pair, down_pair, mlp_gamma,
                 *, eps: float = 1e-5, next_qkv=None):
    """out = y + bf16(h @ W_down), y = resid + bf16(attn_out @ W_o),
    h = silu(g) * u with (g, u) = rmsnorm(y, mlp_gamma) @ W_gate|up — all
    weight-only INT4 (split-half packed, per-column scales).

    attn_out (M, A), resid (M, D); wo (A/2, D); gate|up concatenated
    (D/2, 2F) with scales (2F,); down (F/2, D); the result has resid's
    dtype. ``next_qkv = ((wqkv, wqkv_scale), attn_gamma)`` adds the next
    layer's attention norm and QKV projection and returns ``(out, qkv)``.

    On CUDA tensors (bf16, M <= 64) it launches kernel KFL; on CPU
    tensors it takes :func:`fused_wo_mlp_torch`."""
    M, A = attn_out.shape
    D = resid.shape[1]
    F = gateup_pair[0].shape[1] // 2
    check_block_shapes(M, A, D, F, wo_pair, gateup_pair, down_pair, next_qkv)
    if not on_cuda(attn_out, resid, wo_pair[0], gateup_pair[0],
                   down_pair[0]):
        return fused_wo_mlp_torch(attn_out, resid, wo_pair, gateup_pair,
                                  down_pair, mlp_gamma, eps=eps,
                                  next_qkv=next_qkv)
    fused_wo_mlp.launches += 1
    out, qkv = launch_layer(
        dict(attn_out=operand(attn_out, resid.dtype)), resid, wo_pair,
        gateup_pair, down_pair, mlp_gamma, eps, next_qkv, A=A, int8=False)
    return out if next_qkv is None else (out, qkv)


fused_wo_mlp.launches = 0


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


def launch_layer(extra: dict, resid, wo_pair, gateup_pair, down_pair,
                 mlp_gamma, eps: float, next_qkv, *, A: int, int8: bool,
                 attn: Optional[dict] = None) -> Tuple[torch.Tensor, ...]:
    """Launch ``csrc/fused_layer.cu`` once: KFL when ``attn`` is None,
    else KSOL with the attention operands and sizes in ``attn``.
    ``extra`` holds further operands by field name, passed as they are
    (the caches are updated in place). Returns (out (M, D), next qkv
    (M, Nq) or None)."""
    M, D = resid.shape
    F = gateup_pair[0].shape[1] // 2
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"the fused layer kernels take 1..{MAX_ROWS} rows, "
                         f"got {M}")
    if resid.dtype != torch.bfloat16:
        raise TypeError(f"the fused layer kernels take bfloat16 "
                        f"activations, got {resid.dtype}")
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
    for (w, s), pw, ps in ((wo_pair, "wo", "so"), (gateup_pair, "wgu", "sgu"),
                           (down_pair, "wd", "sd")):
        setattr(args, pw, ptr(w, torch.int8))
        setattr(args, ps, ptr(s, torch.float32))
    Nq = 0
    qkv_next = None
    if next_qkv is not None:
        (wq, sq), attn_gamma = next_qkv
        Nq = wq.shape[1]
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
                               attn["S"]) if attn else (1, 0, 0)))
    grid = _grid(dev.index or 0, is_attn, int(int8), smem)
    step = 64 if int8 else 32   # packed rows a K step (gemm_tiles.cuh)
    splits = []
    for K, N in ((A, D), (D, 2 * F), (F, D), (D, max(Nq, 1))):
        steps = -(-(K // 2) // step)
        tiles = -(-N // _TILE_N)
        splits.append(_used_splits(
            steps, max(1, min(grid // tiles, steps // 2))))
    part_n = max(s * N for s, N in zip(splits, (D, 2 * F, D, Nq)))
    args.part = ptr(torch.empty((M * part_n,), dtype=torch.float32,
                                device=dev), torch.float32)
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
    args.split_a, args.split_b, args.split_c, args.split_d = splits
    args.eps = eps
    _build.launch("aimet_fused_layer", ctypes.addressof(args), is_attn,
                  int(int8), grid, smem, _build.stream_ptr(dev))
    return out, qkv_next
