"""Legacy whole-network quantizer facade — counterpart of
``aimet_tpu/quantsim/legacy.py``.

Compatibility port of the reference's Caffe-era interface
(DlQuantization/src/MainQuantizationClass.cpp, QuantizerFactory.cpp:124,
TfQuantizer/TfEnhancedQuantizer): one object that, in a single call,
calibrates every activation/param of a network and hands back encodings —
no per-op configuration, no wrapper objects. Modern code should use
QuantizationSimModel; this exists so reference users migrating old
pipelines find the same shape of API.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

from .qsim import QuantizationSimModel

_SCHEME_MAP = {          # QuantizationMode names (Quantization.hpp:83-108)
    "tf": "minmax",
    "tf_enhanced": "sqnr",
    "percentile": "percentile",
    "mse": "mse",
    "entropy": "entropy",
}


class MainQuantizer:
    """``MainQuantizationClass`` equivalent: quantize a whole network.

    Usage (mirrors IQuantizer::updateStats/getEncoding flow):
        q = MainQuantizer(model, example_inputs, quant_mode="tf_enhanced")
        encodings = q.quantize_net(params, data_iter, bw=8)
        y = q.forward(params, x)          # fake-quantized inference

    ``params`` None: the model's own; ``device`` as the sim's (``cuda``
    unless ``"cpu"`` is asked for).
    """

    def __init__(self, model, example_inputs, quant_mode: str = "tf",
                 percentile: float = 100.0, device=None):
        scheme = _SCHEME_MAP.get(quant_mode)
        if scheme is None:
            raise ValueError(
                f"unknown quant_mode {quant_mode!r}; one of {sorted(_SCHEME_MAP)}")
        self._scheme = scheme
        self._model = model
        self._example_inputs = example_inputs
        self._percentile = percentile
        self._device = device
        self._sim = None

    def quantize_net(self, params, data_iter: Iterable, bw: int = 8
                     ) -> Dict[str, Dict[str, Any]]:
        """Calibrate everything; returns {tensor_name: {min, max, delta,
        offset, bitwidth}} for all activations and params."""
        self._sim = QuantizationSimModel(
            self._model, self._example_inputs, quant_scheme=self._scheme,
            param_quant_scheme=self._scheme,
            default_output_bw=bw, default_param_bw=bw,
            percentile=self._percentile, device=self._device)
        self._sim.compute_encodings(params, data_iter)
        out = {}
        for name, enc in self._sim.encodings.items():
            out[name] = {
                "min": float(enc.min.min()), "max": float(enc.max.max()),
                "delta": float(enc.delta.max()),
                "offset": float(enc.offset.min()),
                "bitwidth": enc.bitwidth,
            }
        return out

    def forward(self, params, *args):
        """Fake-quantized inference with the calibrated encodings."""
        if self._sim is None:
            raise RuntimeError("call quantize_net first")
        return self._sim.quantized_fn(params, *args)

    @property
    def sim(self) -> QuantizationSimModel:
        """Escape hatch to the modern API."""
        if self._sim is None:
            raise RuntimeError("call quantize_net first")
        return self._sim
