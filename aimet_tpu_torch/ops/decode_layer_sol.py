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

from .._device import on_cuda
from .fused_layer import (check_block_shapes, decode_layer_shapes,
                          fused_decode_layer_torch, launch_attention_layer,
                          split_gateup)


def sol_decode_layer_torch(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                           cache_index, cos, sin, wo_pair, gateup_pair,
                           down_pair, mlp_gamma, *, eps: float = 1e-5,
                           next_qkv=None, n_heads: int, n_kv_heads: int,
                           int8_dots: bool = False):
    """Plain version; same arguments and results as
    :func:`sol_decode_layer`."""
    gate, up = split_gateup(gateup_pair)
    return fused_decode_layer_torch(
        qkv, resid, k_cache, v_cache, k_scale, v_scale, cache_index, cos,
        sin, wo_pair, gate, up, down_pair, mlp_gamma, eps=eps,
        next_qkv=next_qkv, n_heads=n_heads, n_kv_heads=n_kv_heads,
        int8_dots=int8_dots)


def sol_decode_layer(qkv, resid, k_cache, v_cache, k_scale, v_scale,
                     cache_index, cos, sin, wo_pair, gateup_pair, down_pair,
                     mlp_gamma, *, eps: float = 1e-5, next_qkv=None,
                     n_heads: int, n_kv_heads: int, int8_dots: bool = False):
    """One entire decode layer.

    qkv (B, (H + 2 KH) D) this layer's QKV projection; resid (B, Dm);
    caches (B, S, KH, D) int8, appended IN PLACE at ``cache_index`` (a
    scalar or (B,) positions); k_scale/v_scale (B, KH); cos/sin (B or 1,
    D/2) f32 rope rows. Weights as :func:`~.fused_layer.fused_wo_mlp`,
    with gate|up concatenated (Dm/2, 2F) as serving stores them (passed to
    the kernel as two views, up at column F); ``next_qkv = ((wqkv, scale),
    attn_gamma)`` for every layer but the last.

    Returns (out, next_qkv, k_cache, v_cache), or (out, k_cache, v_cache)
    without ``next_qkv``. On CUDA tensors (bf16, B <= 64) it launches
    kernel KSOL; on CPU tensors it takes :func:`sol_decode_layer_torch`."""
    if k_cache.dim() != 4:
        raise ValueError("caches must be (B, S, KH, D)")
    B, _, _, D = decode_layer_shapes(qkv, resid, k_cache, n_heads,
                                     n_kv_heads)
    gate, up = split_gateup(gateup_pair)
    check_block_shapes(B, n_heads * D, resid.shape[1], wo_pair, gate, up,
                       down_pair, next_qkv)
    if not on_cuda(qkv, resid, k_cache, v_cache, wo_pair[0]):
        return sol_decode_layer_torch(
            qkv, resid, k_cache, v_cache, k_scale, v_scale, cache_index, cos,
            sin, wo_pair, gateup_pair, down_pair, mlp_gamma, eps=eps,
            next_qkv=next_qkv, n_heads=n_heads, n_kv_heads=n_kv_heads,
            int8_dots=int8_dots)
    sol_decode_layer.launches += 1
    out, qkvn = launch_attention_layer(
        qkv, resid, k_cache, v_cache, k_scale, v_scale, cache_index, cos,
        sin, wo_pair, gate, up, down_pair, mlp_gamma, eps, next_qkv,
        n_heads=n_heads, int8=int8_dots)
    if next_qkv is None:
        return out, k_cache, v_cache
    return out, qkvn, k_cache, v_cache


sol_decode_layer.launches = 0
