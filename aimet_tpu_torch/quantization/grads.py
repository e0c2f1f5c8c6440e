"""Fake-quant forward — counterpart of ``aimet_tpu/quantization/grads.py``.

Only the forward of ``quantize_dequantize`` is ported: the grid is derived
from the encoding's (min, max) as the JAX package's ``_grid_params`` does,
and x is rounded onto it. The straight-through and range-learning
gradients (``jax.custom_vjp``) come with quantization-aware training.
"""
from __future__ import annotations

import math

import torch

from ..ops._common import div_ieee
from .affine import num_quant_steps


def _grid_params(enc_min, enc_max, bitwidth, symmetric, strict_symmetric,
                 unsigned_symmetric):
    """delta/offset from (min, max) — ``get_computed_encodings``
    (quantsim_straight_through_grad.py:120-160)."""
    num_steps = num_quant_steps(bitwidth,
                                strict_symmetric=symmetric and strict_symmetric)
    ns = float(num_steps)
    if symmetric and not unsigned_symmetric:
        delta = div_ieee(enc_max, float(math.floor(ns / 2)))
        offset = torch.full_like(delta, -float(math.ceil(ns / 2)))
    else:
        delta = div_ieee(enc_max - enc_min, ns)
        if symmetric:          # unsigned symmetric
            offset = enc_min / delta
        else:
            offset = -torch.clamp(torch.round(-enc_min / delta), 0.0, ns)
    return delta, offset, num_steps


def quantize_dequantize(x: torch.Tensor, enc_min, enc_max, *,
                        bitwidth: int = 8, symmetric: bool = False,
                        strict_symmetric: bool = False,
                        unsigned_symmetric: bool = False) -> torch.Tensor:
    """Fake-quant of x on the grid of (enc_min, enc_max), which broadcast
    against x and are taken in x's dtype, as in the JAX package:
    out = (clip(round(x / delta) - offset, 0, ns) + offset) * delta."""
    enc_min = torch.as_tensor(enc_min, dtype=x.dtype, device=x.device)
    enc_max = torch.as_tensor(enc_max, dtype=x.dtype, device=x.device)
    delta, offset, ns = _grid_params(enc_min, enc_max, bitwidth, symmetric,
                                     strict_symmetric, unsigned_symmetric)
    x_quant = torch.clamp(torch.round(x / delta) - offset, 0.0, float(ns))
    return (x_quant + offset) * delta
