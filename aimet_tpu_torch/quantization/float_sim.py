"""Simulated float quantization — the part of
``aimet_tpu/quantization/float_sim.py`` that a float quantizer's forward
runs: the FP16 round trip and the FP8 fake cast.

  - FP16: FP32 -> FP16 -> FP32 (DlQuantization/src/Fp16Quantization.cpp,
    trim_functions.hpp:57);
  - FP8: the IEEE-style fake cast of aimet_torch/fp_quantization.py:170-205
    with exponent_bits = 7 - mantissa_bits (E4M3) and a maxval taken from
    the quantizer's calibrated range.

The maxval searches (``init_fp8_maxval_minmax`` / ``_mse``) are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

NUM_MANTISSA_BITS = 3  # fp_quantization.py:46 (E4M3)


def fake_cast_fp16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(x.dtype)


def fake_cast_to_ieee_float(x, maxval, exponent_bits=None,
                            mantissa_bits=NUM_MANTISSA_BITS):
    """fake_cast_to_ieee_float (fp_quantization.py:170-205)."""
    if exponent_bits is None:
        exponent_bits = 7 - mantissa_bits
    maxval = torch.as_tensor(maxval, dtype=x.dtype, device=x.device)
    bias = (2.0 ** exponent_bits - torch.log2(maxval)
            + torch.log2(torch.tensor(2.0 - 2.0 ** (-mantissa_bits),
                                      dtype=x.dtype, device=x.device))
            - 1.0)
    x_clipped = torch.minimum(torch.maximum(x, -maxval), maxval)
    log_scales = torch.floor(torch.log2(x_clipped.abs() + 1e-45)
                             + bias).detach()
    log_scales = torch.clamp(log_scales, min=1.0)
    scales = 2.0 ** (log_scales - mantissa_bits - bias)
    return torch.round(x_clipped / scales) * scales


def quantize_to_fp8(x, maxval, channel_axis: Optional[int] = None,
                    mantissa_bits=NUM_MANTISSA_BITS):
    """fp8_quantizer (fp_quantization.py:130-140); a per-channel (C,)
    maxval broadcasts along ``channel_axis``."""
    if torch.as_tensor(maxval).dim() and channel_axis is not None:
        shape = [1] * x.dim()
        shape[channel_axis] = -1
        maxval = maxval.reshape(shape)
    return fake_cast_to_ieee_float(x, maxval, mantissa_bits=mantissa_bits)
