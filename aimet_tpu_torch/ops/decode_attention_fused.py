"""One-token GQA decode attention over the INT8 KV cache, appending the new
row in place — counterpart of ``aimet_tpu/ops/decode_attention_fused.py``.

On a CUDA tensor ``fused_decode_attention`` launches kernel K3
(``csrc/decode_attention.cu``), which splits each row's cache across
blocks (:func:`split_chunk`); on a CPU tensor it takes the plain version
``fused_decode_attention_torch``, which follows the JAX package's XLA decode
path (``serving/quantized_llm._attention_from_qkv``) op for op.

``scores_fit`` and ``score_workspace`` serve the kernels that keep one
block a (row, kv head): KSOL / KDL (``ops/decode_layer_sol.py``,
``ops/fused_layer.py``); ``attention_kernel_shape_ok`` those and K3 and
KGQA (``ops/decode_attention.py``).

Unlike the TPU kernel, positions may differ per row (continuous batching),
and none of the TPU's layout constraints (D % 128, S % 32, batch groups)
apply.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .. import _build
from .._device import on_cuda
from ..models.transformer import apply_rope
from ._common import div_ieee
from .int_matmul import _SMS, _zeroed_counters
from .kv_cache import QuantizedKVCache, append_kv, codes_4d, reciprocal

_MAX_REP = 8
_MAX_D = 128
_SMEM_LIMIT = 227 * 1024
_RECORD_HEAD = 16      # floats of a K3 chunk record before its context


def positions(cache_index, batch: int, device) -> torch.Tensor:
    """A scalar or (B,) position(s) -> (B,) int32 per-row positions. A
    Python int is filled on the device: copying it from pageable host
    memory would wait for the stream before every launch."""
    if isinstance(cache_index, (int, np.integer)):
        return torch.full((batch,), int(cache_index), dtype=torch.int32,
                          device=device)
    return torch.as_tensor(cache_index, device=device).to(
        torch.int32).reshape(-1).expand(batch).contiguous()


def scalar_position(cache_index):
    """One position for every row, as the TPU kernels take it: a CUDA
    tensor stays one, anything else becomes an int; raises on a vector of
    positions."""
    t = (cache_index if isinstance(cache_index, torch.Tensor)
         else torch.as_tensor(np.asarray(cache_index)))
    if t.numel() != 1:
        raise ValueError(f"one position for every row, got positions of "
                         f"shape {tuple(t.shape)}")
    return t.reshape(()) if t.is_cuda else int(t)


def attention_kernel_shape_ok(H: int, KH: int, D: int) -> None:
    """Raise unless the attention device code (``csrc/decode_attention.cuh``)
    takes these heads: rep = H / KH <= 8, D % 4 == 0, D <= 128. It takes
    every cache length (see :func:`score_workspace`)."""
    rep = H // KH
    if rep > _MAX_REP or D % 4 or D > _MAX_D:
        raise ValueError(f"decode attention kernel takes rep <= {_MAX_REP}, "
                         f"D % 4 == 0 and D <= {_MAX_D}; got rep {rep}, "
                         f"D {D}")


def scores_fit(rep: int, D: int, S: int, warps: int) -> bool:
    """Whether the attention scratch of a block of ``warps`` warps (query
    rows, one f32 score row of S per query head, the warps' partial
    contexts) fits in the block's shared memory."""
    smem = 4 * (rep * D + -(-rep * S // 4) * 4 + warps * rep * D)
    return smem <= _SMEM_LIMIT


def score_workspace(B: int, KH: int, rep: int, D: int, S: int, warps: int,
                    device):
    """None while the score rows fit in shared memory; else a
    (B, KH, rep, S) f32 workspace for them (same arithmetic, so the same
    bits as in shared memory)."""
    if scores_fit(rep, D, S, warps):
        return None
    return torch.empty((B, KH, rep, S), dtype=torch.float32, device=device)


def split_chunk(B: int, KH: int, S: int, sms: int = _SMS) -> int:
    """K3's chunk, the cache rows one block takes (the kernel takes any
    multiple of 32 up to 256): 128, the fastest of 32, 64, 128 and 256 at
    B = 16 and 32 with S = 1024 and at B = 16 with S = 16,384 in
    ``chip_smoke.py``'s sweep; 64 where 128 would leave fewer blocks than
    SMs (B = 1 at S = 1024). It depends on the shapes alone: the positions
    stay on the device."""
    return 64 if B * KH * -(-S // 128) < sms else 128


def split_record_floats(rep: int, D: int) -> int:
    """f32 values of one chunk's record in K3's workspace: its max and sum
    for 8 heads, then its unnormalised context (rep, D)."""
    return _RECORD_HEAD + rep * D


def fused_decode_attention_torch(qkv, cos, sin, k_cache, v_cache, k_scale,
                                 v_scale, cache_index, *, n_heads: int,
                                 n_kv_heads: int):
    """Plain version; same arguments and results as
    :func:`fused_decode_attention`."""
    B = qkv.shape[0]
    S, KH, D = k_cache.shape[1:]
    H = n_heads
    rep = H // KH
    pos = positions(cache_index, B, qkv.device).to(torch.int64)
    q = apply_rope(qkv[:, :H * D].reshape(B, 1, H, D), cos[:, None],
                   sin[:, None])
    k = apply_rope(qkv[:, H * D:(H + KH) * D].reshape(B, 1, KH, D),
                   cos[:, None], sin[:, None])
    v = qkv[:, (H + KH) * D:].reshape(B, 1, KH, D)
    cache = append_kv(QuantizedKVCache(k_cache, v_cache, k_scale, v_scale),
                      k, v, pos)
    q5 = q.reshape(B, 1, KH, rep, D)
    q5 = q5 * div_ieee(k_scale[:, None, :, None, None],
                       float(np.sqrt(D))).to(q5.dtype)
    scores = torch.einsum("btkrd,bskd->bkrts", q5,
                          cache.k.to(q5.dtype)).to(torch.float32)
    live = (torch.arange(S, device=qkv.device)[None, :]
            <= pos[:, None])[:, None, None, None, :]          # (B,1,1,1,S)
    scores = scores.masked_fill(~live, -1e30)
    probs = F.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.einsum("bkrts,bskd->btkrd", probs, cache.v.to(qkv.dtype))
    out = out * v_scale[:, None, :, None, None].to(out.dtype)
    return out.reshape(B, H * D), k_cache, v_cache


def fused_decode_attention(qkv, cos, sin, k_cache, v_cache, k_scale, v_scale,
                           cache_index, *, n_heads: int, n_kv_heads: int):
    """One-token GQA decode attention with INT8-KV append.

    qkv: (B, (H + 2 KH) D) this step's fused QKV projection, f32 or bf16.
    cos/sin: (B, D/2) or (1, D/2) f32 rope rows for each row's position.
    k_cache/v_cache: (B, S, KH, D) or flat (B, S, KH*D) int8, updated IN
    PLACE at ``cache_index``.
    k_scale/v_scale: (B, KH) f32 scales fixed at prefill.
    cache_index: (B,) int32 per-row positions, or a scalar for every row. A
    position outside [0, S) writes nothing (see ``csrc/decode_attention.cu``
    for what it attends over).

    Returns (attn_mix (B, H D) in qkv's dtype, k_cache, v_cache).

    K3 runs a block for each chunk of :func:`split_chunk` cache rows of a
    (row, kv head), whatever the positions; blocks past a row's position
    exit, the last one of a (row, kv head) merges the chunks' records (an
    f32 workspace of :func:`split_record_floats` a chunk) in chunk order.
    KV bytes are bit-exact against the plain version, the output within
    2e-2 of its max (int8 tensor-core dots on two-plane int8 queries and
    probabilities, f32 softmax statistics)."""
    B = qkv.shape[0]
    given = k_cache, v_cache
    if k_cache.dim() == 3:                # flat (B, S, KH*D): same bytes
        k_cache, v_cache = codes_4d(QuantizedKVCache(k_cache, v_cache,
                                                     k_scale, v_scale))
    if k_cache.dim() != 4:
        raise ValueError("caches must be (B, S, KH, D) or (B, S, KH*D)")
    S, KH, D = k_cache.shape[1:]
    H = n_heads
    if KH != n_kv_heads or H % KH or qkv.shape != (B, (H + 2 * KH) * D):
        raise ValueError(f"shape mismatch: qkv {tuple(qkv.shape)}, cache "
                         f"{tuple(k_cache.shape)}, H={H}, KH={n_kv_heads}")
    cos = cos.reshape(-1, D // 2)
    sin = sin.reshape(-1, D // 2)
    if not on_cuda(qkv, k_cache, v_cache, k_scale, v_scale):
        out, _, _ = fused_decode_attention_torch(
            qkv, cos, sin, k_cache, v_cache, k_scale, v_scale, cache_index,
            n_heads=n_heads, n_kv_heads=n_kv_heads)
        return (out, *given)
    attention_kernel_shape_ok(H, KH, D)
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    for t in (k_cache, v_cache):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError("caches must be contiguous int8 (updated in "
                             "place)")
    qkv = qkv.contiguous()
    cos = cos.to(torch.float32).expand(B, D // 2).contiguous()
    sin = sin.to(torch.float32).expand(B, D // 2).contiguous()
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    iks, ivs = reciprocal(ks), reciprocal(vs)
    pos = positions(cache_index, B, qkv.device)
    out = torch.empty((B, H * D), dtype=qkv.dtype, device=qkv.device)
    chunk = split_chunk(B, KH, S)
    ws = torch.empty((B * KH * -(-S // chunk)
                      * split_record_floats(H // KH, D),),
                     dtype=torch.float32, device=qkv.device)
    cnt = _zeroed_counters(qkv.device, B * KH)
    fused_decode_attention.launches += 1
    _build.launch(
        "aimet_decode_attention", qkv.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), iks.data_ptr(), ivs.data_ptr(),
        pos.data_ptr(), out.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
        B, S, H, KH, D, chunk, ws.numel(), cnt.numel(),
        float(np.float32(np.sqrt(D))), int(qkv.dtype == torch.bfloat16),
        _build.stream_ptr(qkv.device))
    return (out, *given)


fused_decode_attention.launches = 0
