"""GQA decode attention over the INT8 KV caches, with no append —
counterpart of ``aimet_tpu/ops/decode_attention.py``.

On CUDA tensors ``fused_gqa_decode_attention`` launches kernel KGQA
(``csrc/gqa_attention.cu``, one launch a call: the TPU version's scale
folds around its kernel happen inside); on CPU tensors it takes the plain
version ``fused_gqa_decode_attention_torch``, the counterpart of the JAX
package's ``fused_gqa_decode_attention_xla`` (the serving
decode-attention math) with its rounding points: q scaled in q's dtype,
f32 scores and softmax, probs rounded to q's dtype, f32 context times
v_scale.

Unlike the TPU kernel, none of its layout constraints apply; the card
takes rep <= 8, D % 4 == 0, D <= 128 and any cache length (score rows too
long for shared memory go to a global workspace), and raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .. import _build
from .._device import on_cuda
from ._common import div_ieee
from .decode_attention_fused import (attention_kernel_shape_ok,
                                     scalar_position, score_workspace)

_WARPS = 16


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

    On CUDA tensors it launches kernel KGQA; on CPU tensors it takes
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
    q = q.contiguous()
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    out = torch.empty((B, KH, rep, D), dtype=torch.float32, device=q.device)
    ws = score_workspace(B, KH, rep, D, S, _WARPS, q.device)
    fused_gqa_decode_attention.launches += 1
    _build.launch(
        "aimet_gqa_attention", q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), min(pos, S), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), B, S, KH, rep, D,
        float(np.float32(np.sqrt(D))), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q.device))
    return out


fused_gqa_decode_attention.launches = 0
