"""Weight (bitwidth) padding — counterpart of
``aimet_tpu/utils/weight_padding.py``: simulate low-bitwidth weights on
higher bitwidth hardware kernels.

Port of aimet_torch/weight_padding_utils.py:40-140: weights are
quantize-dequantized at the *simulated* (low) bitwidth, then the encoding is
re-expressed on the *target* (high) bitwidth grid with
``delta_target = delta_sim / 2^(target - simulated)`` — the integer codes
land on every 2^(t-s)-th grid point, i.e. their low bits are zero padding
(saves power on int-MAC hardware).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..quantization.affine import (AffineEncoding,
                                   compute_encoding_from_min_max,
                                   num_quant_steps)
from ..quantization.grads import quantize_dequantize
from ..quantsim.qsim import QuantizationSimModel, _broadcast_encoding
from .pytree import set_leaves


@dataclasses.dataclass
class WeightPaddingParams:
    simulated_bw: int
    target_kernel_bw: int


def weight_pad(sim: QuantizationSimModel, params,
               layer_bw: Dict[str, WeightPaddingParams]):
    """Returns padded params (a new dict; ``params`` None: the sim's
    model's); the sim's param encodings are rewritten to the
    target-bitwidth grid and frozen.

    ``layer_bw``: parameter name -> WeightPaddingParams.
    """
    params = sim.params if params is None else params
    updates = {}
    for name, bw in layer_bw.items():
        if bw.target_kernel_bw <= bw.simulated_bw:
            continue
        spec = sim.quantizers.get(name)
        if spec is None or name not in sim.encodings:
            continue
        enc = sim.encodings[name]
        w = params[name]

        # q/dq at the simulated (low) bitwidth on the current range
        low_enc = compute_encoding_from_min_max(
            enc.min, enc.max, bw.simulated_bw, spec.symmetric,
            spec.strict_symmetric, spec.unsigned_symmetric)
        w_q = quantize_dequantize(
            w, _broadcast_encoding(low_enc.min, w.dim(), spec.channel_axis),
            _broadcast_encoding(low_enc.max, w.dim(), spec.channel_axis),
            bitwidth=bw.simulated_bw, symmetric=spec.symmetric,
            strict_symmetric=spec.strict_symmetric,
            unsigned_symmetric=spec.unsigned_symmetric)
        updates[name] = w_q

        # re-express the encoding on the target grid (recompute_encodings).
        # min/max MUST be re-derived from the new delta/offset: the quantized
        # forward recomputes the grid from min/max, and only these values
        # reproduce delta_t exactly (preserving the zero-padded low bits).
        shift = 2.0 ** (bw.target_kernel_bw - bw.simulated_bw)
        delta_t = low_enc.delta / shift
        offset_t = low_enc.offset * shift
        ns_t = num_quant_steps(
            bw.target_kernel_bw,
            strict_symmetric=spec.symmetric and spec.strict_symmetric)
        target_enc = AffineEncoding(
            min=delta_t * offset_t,
            max=delta_t * (offset_t + ns_t),
            delta=delta_t,
            offset=offset_t,
            bitwidth=bw.target_kernel_bw, symmetric=spec.symmetric,
            strict_symmetric=spec.strict_symmetric,
            unsigned_symmetric=spec.unsigned_symmetric)
        sim.set_encoding(name, target_enc, freeze=True)
        sim.quantizers[name] = dataclasses.replace(
            spec, bitwidth=bw.target_kernel_bw)
    return set_leaves(params, updates)
