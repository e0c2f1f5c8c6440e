"""QuantAnalyzer — per-quantizer sensitivity analysis and its report;
counterpart of ``aimet_tpu/algorithms/quant_analyzer.py`` (reference:
aimet_torch/v1/quant_analyzer.py:63-763):

  - weakest-link analysis: eval with only the parameter quantizers, then
    only the activation quantizers, enabled;
  - per-quantizer sensitivity: eval with one quantizer disabled at a time;
  - per-layer MSE between the float and the quantized activations;
  - encoding ranges;
  - a self-contained HTML report (the JAX package's format).

Every enable / disable sweep runs the sim's one flagged forward
(``quantized_fn_flagged``): a quantizer's flag selects its fake-quant or
its input on the device, so no sweep re-traces or rebuilds anything.
"""
from __future__ import annotations

import dataclasses
import html
from typing import Callable, Dict, Tuple

import torch

from ..quantsim.qsim import QuantizationSimModel


@dataclasses.dataclass
class QuantAnalyzerResult:
    fp_accuracy: float
    quantized_accuracy: float
    param_only_accuracy: float
    act_only_accuracy: float
    per_quantizer_sensitivity: Dict[str, float]  # eval with that one disabled
    per_layer_mse: Dict[str, float]
    encoding_ranges: Dict[str, Tuple[float, float]]


class QuantAnalyzer:
    """``eval_fn(forward) -> float`` scores a forward ``forward(*inputs)``
    (the caller's data and metric); ``params`` None: the model's own."""

    def __init__(self, sim: QuantizationSimModel, params,
                 eval_fn: Callable[[Callable], float]):
        self.sim = sim
        self.params = params
        self.eval_fn = eval_fn

    def _eval(self, forward):
        return self.eval_fn(forward)

    def analyze(self, mse_batches=None) -> QuantAnalyzerResult:
        sim, params = self.sim, self.params
        fp_acc = self._eval(lambda *a: sim.fp_fn(params, *a))
        q_acc = self._eval(lambda *a: sim.quantized_fn(params, *a))

        apply_fn, names = sim.quantized_fn_flagged()
        kind = {n: sim.quantizers[n].kind for n in names}

        def flag_eval(mask):
            flags = torch.tensor(mask, dtype=torch.bool, device=sim.device)
            return self._eval(lambda *a: apply_fn(params, flags, *a))

        param_only = flag_eval([kind[n] == "param" for n in names])
        act_only = flag_eval([kind[n] != "param" for n in names])

        sensitivity = {}
        for i, name in enumerate(names):
            mask = [True] * len(names)
            mask[i] = False
            sensitivity[name] = flag_eval(mask)

        per_layer_mse: Dict[str, float] = {}
        if mse_batches is not None:
            prods = [op.output.name for op in sim.graph.ops
                     if op.name in sim.quantizers]
            for batch in mse_batches:
                args = batch if isinstance(batch, (tuple, list)) else (batch,)
                fp_caps = sim.collect_activations(params, args, prods, "fp")
                q_caps = sim.collect_activations(params, args, prods,
                                                 "quantized")
                for p in prods:
                    mse = ((fp_caps[p] - q_caps[p]) ** 2).mean().item()
                    per_layer_mse[p] = per_layer_mse.get(p, 0.0) \
                        + mse / len(mse_batches)

        ranges = {name: (enc.min.min().item(), enc.max.max().item())
                  for name, enc in sim.encodings.items()}

        return QuantAnalyzerResult(
            fp_accuracy=fp_acc, quantized_accuracy=q_acc,
            param_only_accuracy=param_only, act_only_accuracy=act_only,
            per_quantizer_sensitivity=sensitivity,
            per_layer_mse=per_layer_mse, encoding_ranges=ranges)

    @staticmethod
    def export_html(result: QuantAnalyzerResult, path: str):
        """The self-contained report (replaces bokeh_plots.py)."""
        rows_sens = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v:.5f}</td></tr>"
            for k, v in sorted(result.per_quantizer_sensitivity.items(),
                               key=lambda kv: kv[1]))
        rows_mse = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v:.3e}</td></tr>"
            for k, v in sorted(result.per_layer_mse.items(),
                               key=lambda kv: -kv[1]))
        rows_rng = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{lo:.4f}</td>"
            f"<td>{hi:.4f}</td></tr>"
            for k, (lo, hi) in result.encoding_ranges.items())
        doc = f"""<!doctype html><html><head><title>QuantAnalyzer</title>
<style>body{{font-family:sans-serif}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 8px}}</style></head><body>
<h1>Quantization analysis</h1>
<p>FP accuracy: {result.fp_accuracy:.5f} |
Quantized: {result.quantized_accuracy:.5f} |
Params-only: {result.param_only_accuracy:.5f} |
Activations-only: {result.act_only_accuracy:.5f}</p>
<h2>Per-quantizer sensitivity (eval with quantizer disabled; low = that
quantizer was helping, high = it was hurting)</h2>
<table><tr><th>quantizer</th><th>eval</th></tr>{rows_sens}</table>
<h2>Per-layer output MSE (quantized vs FP)</h2>
<table><tr><th>tensor</th><th>MSE</th></tr>{rows_mse}</table>
<h2>Encoding ranges</h2>
<table><tr><th>quantizer</th><th>min</th><th>max</th></tr>{rows_rng}</table>
</body></html>"""
        with open(path, "w") as f:
            f.write(doc)
