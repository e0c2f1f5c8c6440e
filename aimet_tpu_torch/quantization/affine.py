"""Affine quantization grid math — counterpart of
``aimet_tpu/quantization/affine.py``.

Encodings are records {min, max, delta, offset} of tensors sharing one
shape (0-dim per tensor, ``(C,)`` per channel, a keepdims block shape per
block) plus static fields. The integer grid follows the reference:
quantized values live in ``[0, num_steps]`` with a non-positive integer
``offset`` (the zero-point is ``-offset``), so ``dequant(0) == min`` and
``dequant(num_steps) == max``.

Every step is the JAX package's f32 operation in the same order, so the
two packages give the same bits on the same inputs; a division by a Python
number goes through a 0-dim tensor (``div_ieee``), which keeps it an IEEE
division on the card too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops._common import div_ieee

FLOAT32_MAX = float(torch.finfo(torch.float32).max)
FLOAT32_LOWEST = -FLOAT32_MAX


def num_quant_steps(bitwidth: int, *, strict_symmetric: bool = False) -> int:
    """Number of integer steps on the grid: 2^bw - 1 (one fewer when strict)."""
    steps = 2 ** bitwidth - 1
    if strict_symmetric:
        steps -= 1
    return steps


@dataclasses.dataclass
class AffineEncoding:
    """Affine encoding record {min, max, delta, offset} (+ static fields).
    ``offset`` is integer-valued but stored as float, as in the reference."""

    min: torch.Tensor
    max: torch.Tensor
    delta: torch.Tensor
    offset: torch.Tensor
    bitwidth: int = 8
    symmetric: bool = False
    strict_symmetric: bool = False
    unsigned_symmetric: bool = False

    @property
    def num_steps(self) -> int:
        return num_quant_steps(
            self.bitwidth,
            strict_symmetric=self.symmetric and self.strict_symmetric)

    def reshape(self, shape) -> "AffineEncoding":
        return dataclasses.replace(
            self, min=self.min.reshape(shape), max=self.max.reshape(shape),
            delta=self.delta.reshape(shape), offset=self.offset.reshape(shape))

    def broadcast_to(self, tensor_shape,
                     channel_axis: Optional[int]) -> "AffineEncoding":
        """View per-channel encodings as shape (1,..,C,..,1) for broadcasting."""
        if channel_axis is None:
            return self
        shape = tuple(d if ax == channel_axis else 1
                      for ax, d in enumerate(tensor_shape))
        return self.reshape(shape)


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def compute_encoding_from_min_max(min_val, max_val, bitwidth: int,
                                  symmetric: bool,
                                  strict_symmetric: bool = False,
                                  unsigned_symmetric: bool = False
                                  ) -> AffineEncoding:
    """Port of ``getComputedEncodings`` (quantization_utils.cpp:58-140),
    elementwise over any shape."""
    min_val = _f32(min_val)
    max_val = _f32(max_val, min_val.device)
    num_steps = num_quant_steps(bitwidth,
                                strict_symmetric=symmetric and strict_symmetric)
    ns = float(num_steps)

    min_val = torch.where(torch.isinf(min_val), FLOAT32_LOWEST, min_val)
    max_val = torch.where(torch.isinf(max_val), FLOAT32_MAX, max_val)

    # signed-symmetric grid
    amax = torch.maximum(max_val.abs(), min_val.abs())
    n_pos = float(math.floor(num_steps / 2))
    sym_delta = div_ieee(amax, n_pos)
    sym_offset = torch.full_like(sym_delta, -float(math.ceil(num_steps / 2)))
    sym_min = torch.clamp(sym_offset * sym_delta, min=FLOAT32_LOWEST)
    sym_max = torch.clamp(sym_delta * n_pos, max=FLOAT32_MAX)

    # asymmetric / unsigned-symmetric grid
    asym_delta = div_ieee(max_val - min_val, ns)
    safe_delta = torch.where(asym_delta == 0, 1.0, asym_delta)
    straddles = (min_val < 0) & (max_val > 0)
    b_zero = torch.clamp(torch.round(-min_val / safe_delta), 0.0, ns)
    offset_straddle = -b_zero
    offset_edge = torch.round(min_val / safe_delta)
    asym_offset = torch.where(straddles, offset_straddle, offset_edge)
    snapped_min = torch.clamp(asym_delta * asym_offset, FLOAT32_LOWEST,
                              FLOAT32_MAX)
    snapped_max = torch.clamp(max_val - min_val + snapped_min,
                              max=FLOAT32_MAX)
    asym_min = torch.where(straddles, snapped_min, min_val)
    asym_max = torch.where(straddles, snapped_max, max_val)

    if symmetric:
        if unsigned_symmetric:
            use_signed = min_val < 0
        else:
            use_signed = torch.ones_like(min_val, dtype=torch.bool)
        enc_min = torch.where(use_signed, sym_min, asym_min)
        enc_max = torch.where(use_signed, sym_max, asym_max)
        enc_delta = torch.where(use_signed, sym_delta, asym_delta)
        enc_offset = torch.where(use_signed, sym_offset, asym_offset)
    else:
        enc_min, enc_max = asym_min, asym_max
        enc_delta, enc_offset = asym_delta, asym_offset

    return AffineEncoding(min=enc_min, max=enc_max, delta=enc_delta,
                          offset=enc_offset, bitwidth=bitwidth,
                          symmetric=symmetric,
                          strict_symmetric=strict_symmetric,
                          unsigned_symmetric=unsigned_symmetric)


def gate_min_max(min_val, max_val, min_range: float = 0.01):
    """Always include zero; enforce ``max >= min + min_range``
    (TfEncodingAnalyzer.cpp:90-98, MIN_RANGE = 0.01)."""
    min_val, max_val = _f32(min_val), _f32(max_val)
    gated_min = torch.clamp(min_val, max=0.0)
    gated_max = torch.clamp(max_val, min=0.0)
    gated_max = torch.maximum(gated_max, gated_min + min_range)
    return gated_min, gated_max


# ---------------------------------------------------------------------------
# Quantize / dequantize primitives
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, delta: torch.Tensor, offset: torch.Tensor,
             num_steps: int, *,
             stochastic_key: Optional[torch.Generator] = None
             ) -> torch.Tensor:
    """Real values onto the integer grid ``[0, num_steps]``
    (``quantizeValueCpu``, trim_functions.cpp:141-166): round(x/delta -
    offset), clipped. Returns a float tensor of integer values.

    ``stochastic_key``: a ``torch.Generator`` on x's device; rounding is
    then stochastic, floor(x/delta - offset + u) with u uniform in [0, 1),
    so a value rounds up with the probability of its fraction (unbiased;
    the draws are PyTorch's, not JAX's)."""
    x_scaled = x / delta - offset
    if stochastic_key is not None:
        noise = torch.rand(x.shape, generator=stochastic_key, dtype=x.dtype,
                           device=x.device)
        x_rounded = torch.floor(x_scaled + noise)
    else:
        x_rounded = torch.round(x_scaled)
    return torch.clamp(x_rounded, 0.0, float(num_steps))


def dequantize(q: torch.Tensor, delta: torch.Tensor,
               offset: torch.Tensor) -> torch.Tensor:
    """``(q + offset) * delta`` — trim_functions.cpp:168-180."""
    return (q.to(delta.dtype) + offset) * delta


def quantize_dequantize_encoding(
        x: torch.Tensor, encoding: AffineEncoding, *,
        channel_axis: Optional[int] = None,
        stochastic_key: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fake-quant through an :class:`AffineEncoding` (no custom
    gradients); ``stochastic_key`` as in :func:`quantize`."""
    enc = encoding.broadcast_to(x.shape, channel_axis)
    q = quantize(x, enc.delta, enc.offset, encoding.num_steps,
                 stochastic_key=stochastic_key)
    return dequantize(q, enc.delta, enc.offset)


def quantize_to_int(x: torch.Tensor, encoding: AffineEncoding, *,
                    channel_axis: Optional[int] = None, signed: bool = True,
                    dtype=torch.int8) -> torch.Tensor:
    """True integer codes. ``signed=True`` shifts the ``[0, num_steps]``
    grid by ``offset`` so symmetric weights land in
    ``[-2^(bw-1), 2^(bw-1)-1]`` (``shiftToSigned``,
    trim_functions.cpp:118-135)."""
    enc = encoding.broadcast_to(x.shape, channel_axis)
    q = quantize(x, enc.delta, enc.offset, encoding.num_steps)
    if signed:
        q = q + enc.offset
    return q.to(dtype)


def reduce_min_max(x: torch.Tensor, channel_axis: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max over all dims (per tensor) or all but one (per channel)."""
    if channel_axis is None:
        return x.min(), x.max()
    dims = tuple(d for d in range(x.dim()) if d != channel_axis)
    return x.amin(dim=dims), x.amax(dim=dims)
