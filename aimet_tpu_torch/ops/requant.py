"""Fixed-point requantization helpers for integer conv / matmul pipelines —
counterpart of ``aimet_tpu/ops/requant.py`` (the reference's
encoding-rescale and bias-absorption math, EncodingRescale.hpp:53-96 and
spec_functions.cpp:60-170). Given the input, weight and output encodings
of an integer layer

  [(q_in + in_off) * in_scale] @ [q_w * w_scale] + bias
      = (q_out + out_off) * out_scale

they compute the per-channel requant scale ``(in_scale * w_scale) /
out_scale``, the rescaled integer-domain bias, and the mantissa / exponent
split a fixed-point multiplier takes. ``get_scale_factor`` and
``get_rescaled_output_and_bias`` are host math in numpy, as in the JAX
package; the other two take and return tensors on any device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_scale_factor(x: float, mbits: int = 16) -> Tuple[int, int]:
    """(exponent, mantissa) of a positive float x as an mbits-bit
    fixed-point multiplier: x ~= m * 2^(e - mbits) (getScaleFactor,
    EncodingRescale.hpp:74-85)."""
    assert x > 0 and np.isfinite(x)
    e = int(np.floor(np.log2(x))) + 1
    m = int(round(x / 2.0 ** (e - mbits)))
    if m == (1 << mbits):  # rounding overflow
        m >>= 1
        e += 1
    if e < -126 + 1:
        return -9999, m
    return e, m


def requant_scale_and_bias(bias_in, input_scale: float, weight_scale,
                           out_scale: float, out_offset: float = 0.0,
                           with_offset_wrap: bool = False):
    """(requant_scale, bias_q): the per-channel multiplier applied to the
    int32 accumulator and the integer-domain bias added before it
    (getRescaledOutputAndBiasImplCpu, spec_functions.cpp:99+), in f32:

      q_out = requant_scale * (acc + bias_q)   [then + out_offset]"""
    weight_scale = torch.atleast_1d(
        torch.as_tensor(weight_scale, dtype=torch.float32))

    def f32(v):   # a 0-dim f32 operand: IEEE ops on every device
        return torch.tensor(v, dtype=torch.float32,
                            device=weight_scale.device)

    acc_scale = weight_scale * f32(input_scale)                   # (C,)
    requant_scale = acc_scale / f32(out_scale)
    # snap the float bias onto the accumulator grid, then express it in
    # accumulator units
    bias_in = torch.as_tensor(bias_in, device=acc_scale.device)
    bias_sim = torch.round(bias_in / acc_scale) * acc_scale
    bias_q = bias_sim / acc_scale
    if with_offset_wrap:
        bias_q = bias_q - f32(out_offset) / requant_scale
    return requant_scale, bias_q


def get_rescaled_output_and_bias(bias_in: np.ndarray,
                                 weight_scale: np.ndarray,
                                 input_scale: float,
                                 out_encoding_delta: float,
                                 out_encoding_offset: float, bw: int = 8,
                                 with_offset_wrap: bool = False
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``getRescaledOutputAndBias``
    (spec_functions.cpp:99-156) in f64, with its rounding order: per
    channel the bias snaps to the accumulator grid *before* the offset
    wrap, per tensor it rounds *after* subtracting it; then the final
    ``floor(x * 2^(8-bw))`` shift of the 16-bit bias path. Returns f32
    (requant_scale, bias_sim)."""
    if bw not in (8, 16):
        raise ValueError("bw must be 8 or 16 (spec_functions.cpp:107)")
    bias_in = np.asarray(bias_in, np.float64)
    ws = np.atleast_1d(np.asarray(weight_scale, np.float64))
    acc_scale = ws.max() * input_scale
    shift = 2.0 ** (8 - bw)

    def wrap(requant_scale):
        return (out_encoding_offset / requant_scale) if with_offset_wrap \
            else 0.0

    # as in the reference, `count == weightLen` takes the per-channel
    # branch first (spec_functions.cpp:118), so a one-channel layer with a
    # length-1 weight scale rounds per channel
    if bias_in.shape[0] == ws.shape[0]:          # per channel
        acc_curr = ws * input_scale
        requant_scale = acc_curr / out_encoding_delta
        bias_sim = np.round(bias_in / acc_curr) * acc_curr
        norm_ws = ws / ws.max()
        bias_sim = bias_sim / norm_ws / acc_scale - wrap(requant_scale)
        bias_sim = np.floor(bias_sim * shift)
    elif ws.shape[0] == 1:                       # per tensor
        requant_scale = np.full_like(ws, acc_scale / out_encoding_delta)
        bias_sim = np.round(bias_in / acc_scale - wrap(requant_scale[0]))
        bias_sim = np.floor(bias_sim * shift)
    else:
        raise ValueError("weight_scale must be scalar or match bias length")
    return (requant_scale.astype(np.float32), bias_sim.astype(np.float32))


def requantize(acc: torch.Tensor, requant_scale: torch.Tensor,
               bias_q: torch.Tensor, out_offset: float, bitwidth: int = 8,
               signed: bool = False) -> torch.Tensor:
    """The requant pipeline on an int32 accumulator: scale, offset, round
    (half to even), saturate — the next layer's integer activation
    (int32)."""
    ns = 2 ** bitwidth - 1
    q = torch.round((acc.to(torch.float32) + bias_q) * requant_scale
                    - out_offset)
    lo, hi = (-(ns + 1) // 2, ns // 2) if signed else (0, ns)
    return torch.clamp(q, lo, hi).to(torch.int32)
