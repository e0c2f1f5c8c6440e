"""Simulated float quantization — counterpart of
``aimet_tpu/quantization/float_sim.py``: the FP16 round trip and the FP8
fake cast, with its maxval searches.

  - FP16: FP32 -> FP16 -> FP32 (DlQuantization/src/Fp16Quantization.cpp,
    trim_functions.hpp:57);
  - FP8: the IEEE-style fake cast of aimet_torch/fp_quantization.py:170-205
    with exponent_bits = 7 - mantissa_bits (E4M3); its maxval from the
    quantizer's calibrated range, or searched (``init_fp8_maxval_minmax``,
    ``init_fp8_maxval_mse``: fp_quantization.py:51-110).

The fake cast rounds with a plain ``round`` (no straight-through
estimator), so autograd gives x no gradient through it and maxval only
the gradient of the scales, as ``jax.grad`` does in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops._common import linspace_f32

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


def _broadcast_maxval(maxval, x, channel_axis):
    if not torch.as_tensor(maxval).dim() or channel_axis is None:
        return maxval
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    return maxval.reshape(shape)


def _reduce_dims(x, channel_axis):
    return tuple(d for d in range(x.dim()) if d != channel_axis)


def init_fp8_maxval_minmax(x, channel_axis: Optional[int] = None):
    """init_minmax (fp_quantization.py:51-66): max |x|, per channel along
    ``channel_axis``."""
    a = x.abs()
    if channel_axis is None:
        return a.max()
    return a.amax(dim=_reduce_dims(x, channel_axis))


def init_fp8_maxval_mse(x, channel_axis: Optional[int] = None,
                        mantissa_bits=NUM_MANTISSA_BITS):
    """init_mse (fp_quantization.py:78-110): of 111 maxval candidates in
    [0.1 * amax, 1.2 * amax] (``jnp.linspace``'s values), the one of least
    mean squared error, per channel along ``channel_axis`` (the first
    where several tie). One candidate at a time: no (111, *x.shape)
    tensor."""
    amax = init_fp8_maxval_minmax(x, channel_axis)
    fracs = linspace_f32(0.1, 1.2, 111, device=x.device)
    dims = _reduce_dims(x, channel_axis) if channel_axis is not None \
        else tuple(range(x.dim()))
    mses = []
    for f in fracs:
        mv = _broadcast_maxval(f * amax, x, channel_axis)
        xfp = fake_cast_to_ieee_float(x, mv, mantissa_bits=mantissa_bits)
        mses.append(((x - xfp) ** 2).mean(dim=dims))
    best = torch.stack(mses).argmin(dim=0)
    return fracs[best] * amax


def quantize_to_fp8(x, maxval, channel_axis: Optional[int] = None,
                    mantissa_bits=NUM_MANTISSA_BITS):
    """fp8_quantizer (fp_quantization.py:130-140); a per-channel (C,)
    maxval broadcasts along ``channel_axis``."""
    return fake_cast_to_ieee_float(
        x, _broadcast_maxval(maxval, x, channel_axis),
        mantissa_bits=mantissa_bits)
