"""Fake-quant with the straight-through and range-learning gradients —
counterpart of ``aimet_tpu/quantization/grads.py``.

  - The forward derives the grid from the encoding's (min, max) as the JAX
    package's ``_grid_params`` does and rounds x onto it.
  - The gradient to x is the straight-through estimator
    (``compute_dloss_by_dx``, aimet_torch/v1/quantsim_straight_through_grad.py:
    91-118): it passes inside the representable range, zero outside.
  - With ``learn_range=True`` (min, max) get the reference's analytic
    gradients (``asymmetric_gradients`` / ``symmetric_gradients``,
    quantsim_straight_through_grad.py:252-348), summed back to the
    encoding's shape; with ``learn_range=False`` they get zeros (a static
    grid: nothing reaches whatever computed min / max).

``_QuantizeDequantize`` (a ``torch.autograd.Function``) carries both; the
backward recomputes the grid and the rounding from x and (min, max)
instead of keeping them, so a training step holds no more than x.
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


def _forward(x, enc_min, enc_max, grid):
    """(out, x_quant, delta, offset, mask): out = (clip(round(x / delta) -
    offset, 0, ns) + offset) * delta, mask = the unclipped codes."""
    delta, offset, ns = _grid_params(enc_min, enc_max, *grid)
    x_round = torch.round(x / delta) - offset
    x_quant = torch.clamp(x_round, 0.0, float(ns))
    mask = (x_round >= 0.0) & (x_round <= float(ns))
    return (x_quant + offset) * delta, x_quant, delta, offset, mask


def _reduce_to_shape(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``x`` over the dims where ``shape`` is 1 or missing
    (un-broadcast)."""
    if tuple(x.shape) == tuple(shape):
        return x
    lead = tuple(range(x.dim() - len(shape)))
    if lead:
        x = x.sum(dim=lead)
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and x.shape[i] != 1)
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x


class _QuantizeDequantize(torch.autograd.Function):
    """The JAX package's ``qdq`` custom VJP (grads.py:62-106)."""

    @staticmethod
    def forward(ctx, x, enc_min, enc_max, grid, learn_range):
        ctx.save_for_backward(x, enc_min, enc_max)
        ctx.grid, ctx.learn_range = grid, learn_range
        return _forward(x, enc_min, enc_max, grid)[0]

    @staticmethod
    def backward(ctx, grad):
        x, enc_min, enc_max = ctx.saved_tensors
        _, x_quant, delta, offset, mask = _forward(x, enc_min, enc_max,
                                                   ctx.grid)
        dx = grad * mask if ctx.needs_input_grad[0] else None
        need_min, need_max = ctx.needs_input_grad[1:3]
        if not (need_min or need_max):
            return dx, None, None, None, None
        if not ctx.learn_range:
            return (dx, torch.zeros_like(enc_min) if need_min else None,
                    torch.zeros_like(enc_max) if need_max else None,
                    None, None)
        bitwidth, symmetric, strict, unsigned = ctx.grid
        ns = float(num_quant_steps(bitwidth,
                                   strict_symmetric=symmetric and strict))
        # min and max may broadcast against each other (a symmetric grid
        # reads only max): the terms are summed to their common shape,
        # then each to its own
        shape = torch.broadcast_shapes(enc_min.shape, enc_max.shape)
        if symmetric and not unsigned:
            # symmetric_gradients (quantsim_straight_through_grad.py:297-329)
            g = (x_quant + offset) * grad - mask * (x / delta) * grad
            dmax = div_ieee(_reduce_to_shape(g, shape),
                            float(math.floor(ns / 2)))
            dmin = -dmax
        else:
            # asymmetric_gradients (quantsim_straight_through_grad.py:252-295)
            grad_scale = (x_quant + offset - x * mask / delta) * grad
            grad_offset = delta * grad * torch.logical_not(mask)
            t1 = div_ieee(_reduce_to_shape(grad_scale, shape), ns)
            rng2 = (enc_max - enc_min) ** 2
            t2 = torch.full_like(rng2, ns) / rng2 \
                * _reduce_to_shape(grad_offset, shape)
            dmin = -t1 + enc_max * t2
            dmax = t1 - enc_min * t2
        return (dx, dmin.sum_to_size(enc_min.shape) if need_min else None,
                dmax.sum_to_size(enc_max.shape) if need_max else None,
                None, None)


def _as(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` in x's dtype and on its device (a tensor keeps its graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=x.dtype, device=x.device)
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def quantize_dequantize(x: torch.Tensor, enc_min, enc_max, *,
                        bitwidth: int = 8, symmetric: bool = False,
                        strict_symmetric: bool = False,
                        unsigned_symmetric: bool = False,
                        learn_range: bool = False) -> torch.Tensor:
    """Differentiable fake-quant of x on the grid of (enc_min, enc_max),
    which broadcast against x and are taken in x's dtype, as in the JAX
    package: out = (clip(round(x / delta) - offset, 0, ns) + offset) *
    delta.

    The gradient to x is the straight-through estimator. ``learn_range``
    False: (min, max) get zero gradients (a static grid); True: the
    reference's analytic range-learning gradients."""
    enc_min, enc_max = _as(enc_min, x), _as(enc_max, x)
    grid = (int(bitwidth), bool(symmetric), bool(strict_symmetric),
            bool(unsigned_symmetric))
    if torch.is_grad_enabled() and (x.requires_grad or enc_min.requires_grad
                                    or enc_max.requires_grad):
        return _QuantizeDequantize.apply(x, enc_min, enc_max, grid,
                                         bool(learn_range))
    return _forward(x, enc_min, enc_max, grid)[0]


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient (RoundStraightThrough,
    quantsim_straight_through_grad.py:350-362)."""
    return x + (torch.round(x) - x).detach()
