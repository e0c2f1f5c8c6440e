"""GQA decode attention over the INT8 KV caches, with no append —
counterpart of ``aimet_tpu/ops/decode_attention.py``.

On CUDA tensors ``fused_gqa_decode_attention`` launches kernel KGQA
(``csrc/gqa_attention.cu``: the TPU version's scale folds around its
kernel happen inside); on CPU tensors it takes the plain version
``fused_gqa_decode_attention_torch``, the counterpart of the JAX
package's ``fused_gqa_decode_attention_xla`` (the serving
decode-attention math) with its rounding points: q scaled in q's dtype,
f32 scores and softmax, probs rounded to q's dtype, f32 context times
v_scale.

KGQA splits each (row, kv head)'s cache into chunks of :func:`gqa_chunk`
rows (32 to 256), a block a chunk, in two launches: the scores and each
chunk's softmax statistics, then the probabilities (rounded with the
row's global max and sum) and the context, the chunks' sums added in
chunk order. Unlike the TPU kernel, none of its layout constraints
apply; the card takes rep <= 8, D % 4 == 0, D <= 128 and any cache
length, and raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .. import _build
from .._device import on_cuda
from ._common import div_ieee
from .decode_attention_fused import (attention_kernel_shape_ok,
                                     scalar_position)
from .int_matmul import _SMS, _zeroed_counters

# a chunk's (max, sum) slots in KGQA's workspace: 8 heads each
_STAT_FLOATS = 16
# KGQA's chunks, the smallest first: the largest that still gives every SM
# GQA_MIN_BLOCKS_PER_SM blocks is taken
GQA_CHUNKS = (32, 64, 128, 256)
GQA_MIN_BLOCKS_PER_SM = 2


def gqa_chunk(B: int, KH: int, S: int, sms: int = _SMS) -> int:
    """KGQA's chunk, the cache rows one block takes: the largest of
    ``GQA_CHUNKS`` whose grid (B x KH x ceil(S / chunk) blocks) still puts
    ``GQA_MIN_BLOCKS_PER_SM`` blocks on each SM, else the smallest. It
    depends on the shapes alone, never on the position."""
    fit = [c for c in GQA_CHUNKS
           if B * KH * -(-S // c) >= GQA_MIN_BLOCKS_PER_SM * sms]
    return fit[-1] if fit else GQA_CHUNKS[0]


def gqa_workspace_floats(B: int, KH: int, rep: int, D: int, S: int,
                         chunk: int) -> int:
    """f32 values of KGQA's workspace: the score rows (B, KH, rep, S
    rounded up to 4), each chunk's max and sum (16 floats) and its partial
    context (rep, D)."""
    return B * KH * (rep * -(-S // 4) * 4
                     + -(-S // chunk) * (_STAT_FLOATS + rep * D))


def _check(q, kc, vc, k_scale, v_scale):
    if q.dim() != 4 or kc.dim() != 4:
        raise ValueError(f"q must be (B, KH, rep, D) and the caches "
                         f"(B, S, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(kc.shape)}")
    B, KH, rep, D = q.shape
    if (kc.shape[0] != B or tuple(kc.shape[2:]) != (KH, D)
            or vc.shape != kc.shape or k_scale.shape != (B, KH)
            or v_scale.shape != (B, KH)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, caches "
                         f"{tuple(kc.shape)} / {tuple(vc.shape)}, scales "
                         f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}")


def fused_gqa_decode_attention_torch(q, kc, vc, k_scale, v_scale, pos):
    """Plain version; same arguments and result as
    :func:`fused_gqa_decode_attention`."""
    _check(q, kc, vc, k_scale, v_scale)
    pos = int(scalar_position(pos))
    D = q.shape[3]
    S = kc.shape[1]
    scale = div_ieee(k_scale.to(torch.float32), float(np.sqrt(D)))
    qs = q * scale[:, :, None, None].to(q.dtype)
    # bf16 x int8 products are exact in f32: the sums are f32 sums
    scores = torch.einsum("bkrd,bskd->bkrs", qs.to(torch.float32),
                          kc.to(torch.float32))
    live = torch.arange(S, device=q.device) <= pos
    scores = scores.masked_fill(~live, -1e30)
    probs = F.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrs,bskd->bkrd", probs.to(torch.float32),
                       vc.to(torch.float32))
    return out * v_scale.to(torch.float32)[:, :, None, None]


def fused_gqa_decode_attention(q, kc, vc, k_scale, v_scale, pos):
    """One-token GQA decode attention over the INT8 caches (no append).

    q (B, KH, rep, D) f32 or bf16 (query head kh * rep + r in row
    [kh, r]); kc/vc (B, S, KH, D) int8; k_scale/v_scale (B, KH) f32; pos
    one position for every row (attend to s <= pos; a negative position
    averages all S rows, as the reference's softmax of masked scores does).
    Returns (B, KH, rep, D) f32, v_scale applied.

    On CUDA tensors it launches kernel KGQA (its two launches count as
    one in ``.launches``); on CPU tensors it takes
    :func:`fused_gqa_decode_attention_torch`."""
    _check(q, kc, vc, k_scale, v_scale)
    pos = int(scalar_position(pos))
    if not on_cuda(q, kc, vc, k_scale, v_scale):
        return fused_gqa_decode_attention_torch(q, kc, vc, k_scale, v_scale,
                                                pos)
    B, KH, rep, D = q.shape
    S = kc.shape[1]
    attention_kernel_shape_ok(KH * rep, KH, D)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (kc, vc):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError("caches must be contiguous int8")
    return _launch_gqa(q.contiguous(), kc, vc,
                       k_scale.to(torch.float32).contiguous(),
                       v_scale.to(torch.float32).contiguous(), pos,
                       gqa_chunk(B, KH, S))


def _launch_gqa(q, kc, vc, ks, vs, pos: int, chunk: int):
    """KGQA on checked, contiguous CUDA operands with chunks of ``chunk``
    rows (:func:`gqa_chunk`'s, or another one, as a sweep passes)."""
    B, KH, rep, D = q.shape
    S = kc.shape[1]
    out = torch.empty((B, KH, rep, D), dtype=torch.float32, device=q.device)
    ws = torch.empty((gqa_workspace_floats(B, KH, rep, D, S, chunk),),
                     dtype=torch.float32, device=q.device)
    cnt = _zeroed_counters(q.device, B * KH)
    fused_gqa_decode_attention.launches += 1
    _build.launch(
        "aimet_gqa_attention", q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), min(pos, S), out.data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), B, S, KH, rep, D, chunk, ws.numel(),
        cnt.numel(), float(np.float32(np.sqrt(D))),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    return out


fused_gqa_decode_attention.launches = 0
