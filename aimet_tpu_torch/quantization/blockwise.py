"""Blockwise quantization and LPBQ (low-power block quantization) —
counterpart of ``aimet_tpu/quantization/blockwise.py``.

Blockwise: one (min, max) per ``block_size`` slice along an axis, kept in
a keepdims block shape that broadcasts against the blocked view of the
tensor. LPBQ: the per-block scales are themselves quantized onto a
per-group integer grid, per_group_scale = max(scale) / 2^bw, int_scale =
clip(round(scale / pgs), 1, 2^bw) (aimet_onnx/lpbq_utils.py:46-133).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .affine import AffineEncoding, compute_encoding_from_min_max
from .grads import quantize_dequantize


def _to_blocks(w: torch.Tensor, block_size: int, axis: int) -> torch.Tensor:
    """Reshape ``axis`` into (n_blocks, block_size) at (axis, axis + 1)."""
    n = w.shape[axis]
    if n % block_size:
        raise ValueError(f"{n} % {block_size} != 0")
    shape = list(w.shape)
    shape[axis:axis + 1] = [n // block_size, block_size]
    return w.reshape(shape)


def blockwise_min_max(w: torch.Tensor, block_size: int, axis: int):
    """Per-block (min, max), in the keepdims block shape."""
    wb = _to_blocks(w, block_size, axis)
    return (wb, wb.amin(dim=axis + 1, keepdim=True),
            wb.amax(dim=axis + 1, keepdim=True))


def blockwise_encoding(w: torch.Tensor, block_size: int, axis: int,
                       bitwidth: int = 4, symmetric: bool = True
                       ) -> AffineEncoding:
    """One (min, max, delta, offset) per block."""
    _, mn, mx = blockwise_min_max(w, block_size, axis)
    return compute_encoding_from_min_max(mn, mx, bitwidth, symmetric)


def blockwise_quantize_dequantize(w: torch.Tensor, block_size: int, axis: int,
                                  bitwidth: int = 4, symmetric: bool = True,
                                  encoding: Optional[AffineEncoding] = None,
                                  learn_range: bool = False) -> torch.Tensor:
    """Fake-quant of w with one grid per block (``encoding`` in the
    blocked keepdims shape; by default the blocks' own min-max), with the
    straight-through and, with ``learn_range``, the range-learning
    gradients of ``grads.quantize_dequantize``."""
    wb = _to_blocks(w, block_size, axis)
    enc = encoding if encoding is not None else blockwise_encoding(
        w, block_size, axis, bitwidth, symmetric)
    out = quantize_dequantize(wb, enc.min, enc.max, bitwidth=bitwidth,
                              symmetric=symmetric, learn_range=learn_range)
    return out.reshape(w.shape)


def lpbq_compress_scales(scale: torch.Tensor, group_size: int, axis: int,
                         scale_bitwidth: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block scales onto a per-group integer grid (lpbq_utils.py:65-133).
    Returns (dequantized scales, integer scales, per-group scale)."""
    sb = _to_blocks(scale, group_size, axis)
    max_scale = sb.amax(dim=axis + 1, keepdim=True)
    per_group = max_scale / (2 ** scale_bitwidth)
    int_scale = torch.clamp(torch.round(sb / per_group), 1,
                            2 ** scale_bitwidth)
    deq = (int_scale * per_group).reshape(scale.shape)
    return deq, int_scale.reshape(scale.shape), per_group


def grouped_block_quantize_dequantize(
        w: torch.Tensor, block_size: int, axis: int, bitwidth: int = 4,
        scale_bitwidth: int = 4, block_group: int = -1,
) -> Tuple[torch.Tensor, AffineEncoding]:
    """GroupedBlockQuantizeDequantize (LPBQ): symmetric per-block
    quantization whose block scales are LPBQ-compressed. ``block_group``:
    blocks sharing one scale group (-1: all blocks along the axis)."""
    enc = blockwise_encoding(w, block_size, axis, bitwidth, symmetric=True)
    scale = enc.delta                       # (..., n_blocks, 1, ...)
    nb = scale.shape[axis]
    group = nb if block_group == -1 else block_group
    deq_scale, _, _ = lpbq_compress_scales(scale.squeeze(axis + 1), group,
                                           axis, scale_bitwidth)
    new_scale = deq_scale.unsqueeze(axis + 1)
    n_pos = enc.num_steps // 2
    enc2 = AffineEncoding(min=enc.offset * new_scale, max=new_scale * n_pos,
                          delta=new_scale, offset=enc.offset,
                          bitwidth=bitwidth, symmetric=True)
    wb = _to_blocks(w, block_size, axis)
    out = quantize_dequantize(wb, enc2.min, enc2.max, bitwidth=bitwidth,
                              symmetric=True).reshape(w.shape)
    return out, enc2
