"""One whole decode layer in one launch: attention (rope, INT8-KV append,
GQA) + W_o + residual + RMSNorm + SwiGLU MLP (+ the next layer's attention
norm and QKV) — counterpart of ``aimet_tpu/ops/decode_layer_sol.py``.

On CUDA tensors ``sol_decode_layer`` launches kernel KSOL
(``csrc/fused_layer.cu`` with its attention phase; the attention is K3's
device code, ``csrc/decode_attention.cuh``). On CPU tensors it takes the
plain version ``sol_decode_layer_torch``: the plain decode attention, then
the plain fused block.

``int8_dots=True`` runs every projection in true W4A8: each phase input is
quantized per row in f32, then multiplied on the int8 path with an exact
int32 sum (the numerics of ``ops/int_matmul.matmul_w4a8``).

Unlike the TPU kernel this takes per-row positions as well as a scalar,
flat or 4-D caches are not distinguished (the port keeps (B, S, KH, D)),
and none of the TPU's layout gates (D % 128, S % 32, B % 8) apply.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import on_cuda
from .decode_attention_fused import (attention_kernel_shape_ok,
                                     fused_decode_attention_torch, positions)
from .fused_layer import (check_block_shapes, fused_wo_mlp_torch,
                          launch_layer, operand)
from .kv_cache import reciprocal


def sol_decode_layer_torch(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                           cache_index, cos, sin, wo_pair, gateup_pair,
                           down_pair, mlp_gamma, *, eps: float = 1e-5,
                           next_qkv=None, n_heads: int, n_kv_heads: int,
                           int8_dots: bool = False):
    """Plain version; same arguments and results as
    :func:`sol_decode_layer`."""
    ao, _, _ = fused_decode_attention_torch(
        qkv.to(resid.dtype), cos, sin, k_cache, v_cache, k_scale, v_scale,
        cache_index, n_heads=n_heads, n_kv_heads=n_kv_heads)
    res = fused_wo_mlp_torch(ao, resid, wo_pair, gateup_pair, down_pair,
                             mlp_gamma, eps=eps, next_qkv=next_qkv,
                             int8_dots=int8_dots)
    if next_qkv is None:
        return res, k_cache, v_cache
    return res[0], res[1], k_cache, v_cache


def sol_decode_layer(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                     cache_index, cos, sin, wo_pair, gateup_pair, down_pair,
                     mlp_gamma, *, eps: float = 1e-5, next_qkv=None,
                     n_heads: int, n_kv_heads: int, int8_dots: bool = False):
    """One entire decode layer.

    qkv (B, (H + 2 KH) D) this layer's QKV projection; resid (B, Dm);
    caches (B, S, KH, D) int8, appended IN PLACE at ``cache_index`` (a
    scalar or (B,) positions); k_scale/v_scale (B, KH); cos/sin (B or 1,
    D/2) f32 rope rows. Weights as :func:`~.fused_layer.fused_wo_mlp`
    (gate|up concatenated (Dm/2, 2F)); ``next_qkv = ((wqkv, scale),
    attn_gamma)`` for every layer but the last.

    Returns (out, next_qkv, k_cache, v_cache), or (out, k_cache, v_cache)
    without ``next_qkv``. On CUDA tensors (bf16, B <= 64) it launches
    kernel KSOL; on CPU tensors it takes :func:`sol_decode_layer_torch`."""
    B = qkv.shape[0]
    S, KH, D = k_cache.shape[1:]
    H = n_heads
    Dm = resid.shape[1]
    F = gateup_pair[0].shape[1] // 2
    if (KH != n_kv_heads or H % KH or qkv.shape != (B, (H + 2 * KH) * D)
            or resid.shape[0] != B):
        raise ValueError(f"shape mismatch: qkv {tuple(qkv.shape)}, resid "
                         f"{tuple(resid.shape)}, cache {tuple(k_cache.shape)},"
                         f" H={H}, KH={n_kv_heads}")
    check_block_shapes(B, H * D, Dm, F, wo_pair, gateup_pair, down_pair,
                       next_qkv)
    if not on_cuda(qkv, resid, k_cache, v_cache, wo_pair[0]):
        return sol_decode_layer_torch(
            qkv, resid, k_cache, v_cache, k_scale, v_scale, cache_index, cos,
            sin, wo_pair, gateup_pair, down_pair, mlp_gamma, eps=eps,
            next_qkv=next_qkv, n_heads=n_heads, n_kv_heads=n_kv_heads,
            int8_dots=int8_dots)
    attention_kernel_shape_ok(H, KH, D, S, warps=8)
    for t in (k_cache, v_cache):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError("caches must be contiguous int8 (updated in "
                             "place)")
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    extra = dict(
        qkv=operand(qkv, torch.bfloat16),
        cosb=cos.reshape(-1, D // 2).to(torch.float32).expand(
            B, D // 2).contiguous(),
        sinb=sin.reshape(-1, D // 2).to(torch.float32).expand(
            B, D // 2).contiguous(),
        kc=k_cache, vc=v_cache, ks=ks, vs=vs, iks=reciprocal(ks),
        ivs=reciprocal(vs), pos=positions(cache_index, B, qkv.device))
    sol_decode_layer.launches += 1
    out, qkvn = launch_layer(
        extra, resid, wo_pair, gateup_pair, down_pair, mlp_gamma, eps,
        next_qkv, A=H * D, int8=int8_dots,
        attn=dict(S=S, H=H, KH=KH, HD=D,
                  sqrt_d=float(np.float32(np.sqrt(D)))))
    if next_qkv is None:
        return out, k_cache, v_cache
    return out, qkvn, k_cache, v_cache


sol_decode_layer.launches = 0
