"""AutoQuant, the automatic PTQ pipeline with early exit — counterpart of
``aimet_tpu/algorithms/auto_quant.py``.

Port of AutoQuantBase (aimet_torch/v1/auto_quant.py:204-1500): applies the
PTQ stack in order of increasing cost — plain quantsim -> BN-fold + CLE ->
AdaRound — evaluating after each stage, stopping as soon as the accuracy
target is met, and returning the best result with a per-stage diagnostics
record (the reference's eval-manager sessions, :848-1030).

The JAX package's ``fn(params, *inputs)`` with ``example_args = (params,
*inputs)`` is here ``(model, example_inputs, params)``, as the port's sim
and ``apply_adaround`` take them; ``params`` is a dict of tensors by
qualified name. Stage outputs are memoized through ``utils.cache.Cache``
when a ``cache_dir`` is given, and AdaRound's per-layer cache sits in the
same directory, so a resumed run recomputes neither.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device
from ..graph.connected_graph import ConnectedGraph
from ..quantsim.config import QuantSimConfig
from ..quantsim.qsim import QuantizationSimModel
from .adaround import AdaroundParameters, apply_adaround
from .cle import equalize_model


@dataclasses.dataclass
class StageResult:
    name: str
    accuracy: float
    applied: bool


@dataclasses.dataclass
class AutoQuantResult:
    best_stage: str
    accuracy: float
    params: object
    sim: QuantizationSimModel
    history: List[StageResult]

    def diagnostics(self) -> str:
        lines = ["AutoQuant stages:"]
        for s in self.history:
            mark = "*" if s.name == self.best_stage else " "
            lines.append(f" {mark} {s.name}: {s.accuracy:.5f}")
        return "\n".join(lines)

    def export_diagnostics(self, path: str) -> str:
        """Render the per-stage eval record as an HTML report — the
        TPU-native stand-in for the reference's bokeh eval-score tables and
        diagnostics flowchart (v1/auto_quant.py:848-1030, 1278)."""
        fp32 = next((s.accuracy for s in self.history if s.name == "fp32"),
                    None)
        accs = [s.accuracy for s in self.history]
        lo = min(accs + ([fp32] if fp32 is not None else []))
        hi = max(accs + ([fp32] if fp32 is not None else []))
        span = max(hi - lo, 1e-12)
        rows, flow = [], []
        for s in self.history:
            pct = 100.0 * (s.accuracy - lo) / span
            best = s.name == self.best_stage
            rows.append(
                f"<tr{' class=best' if best else ''}><td>{s.name}</td>"
                f"<td>{s.accuracy:.5f}</td>"
                f"<td>{'applied' if s.applied else 'baseline'}</td>"
                f"<td><div class=bar style='width:{pct:.1f}%'></div></td>"
                f"</tr>")
            flow.append(
                f"<div class='node{' best' if best else ''}'>{s.name}"
                f"<br><small>{s.accuracy:.4f}</small></div>")
        html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>AutoQuant diagnostics</title><style>
body{{font-family:sans-serif;margin:2em}}
table{{border-collapse:collapse}}td,th{{border:1px solid #ccc;
padding:4px 10px}}tr.best{{background:#e6f4e6;font-weight:bold}}
.bar{{background:#4a90d9;height:12px;min-width:2px}}
td:last-child{{width:240px}}
.flow{{display:flex;align-items:center;gap:0;margin:1.5em 0}}
.node{{border:2px solid #888;border-radius:8px;padding:8px 14px;
text-align:center}}.node.best{{border-color:#2a7;background:#e6f4e6}}
.flow .node+.node{{margin-left:28px;position:relative}}
.flow .node+.node:before{{content:"\\2192";position:absolute;left:-22px;
top:50%;transform:translateY(-50%);font-size:18px}}
</style></head><body>
<h2>AutoQuant diagnostics</h2>
<p>best stage: <b>{self.best_stage}</b> — accuracy
{self.accuracy:.5f}</p>
<div class="flow">{''.join(flow)}</div>
<table><tr><th>stage</th><th>accuracy</th><th>status</th><th></th></tr>
{''.join(rows)}</table>
</body></html>"""
        with open(path, "w") as f:
            f.write(html)
        return path


class AutoQuant:
    """auto_quant = AutoQuant(model, example_inputs, params, data, eval_fn,
    device=...); result = auto_quant.optimize(allowed_accuracy_drop).
    ``eval_fn(forward)`` scores ``forward(*inputs)`` (higher is better);
    ``params`` None: the model's own."""

    def __init__(self, model: torch.nn.Module, example_inputs, params,
                 calib_batches: Sequence,
                 eval_fn: Callable[[Callable], float],
                 config: Optional[QuantSimConfig] = None,
                 quant_scheme: str = "sqnr",
                 default_param_bw: int = 8, default_output_bw: int = 8,
                 adaround_params: Optional[AdaroundParameters] = None,
                 cache_dir: Optional[str] = None,
                 cache_key: str = "autoquant", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.example_inputs = tuple(
            t.to(self.device) if isinstance(t, torch.Tensor) else t
            for t in example_inputs)
        self.params = params if params is not None else {
            k: v.detach() for k, v in self.model.named_parameters()}
        self.calib = list(calib_batches)
        self.eval_fn = eval_fn
        self.config = config
        self.quant_scheme = quant_scheme
        self.param_bw = default_param_bw
        self.output_bw = default_output_bw
        self.adaround_params = adaround_params or AdaroundParameters(
            num_iterations=1000)
        # resumable-pipeline cache (reference: aimet_common/cache.py:58,
        # used by auto_quant's eval sessions and adaround_weight.py:596)
        self.cache_dir = cache_dir
        self.cache_key = cache_key

    def _mark(self, name: str, fn: Callable):
        """Disk-memoize a stage output (Cache.mark semantics); identity
        passthrough when no cache_dir was configured."""
        if self.cache_dir is None:
            return fn()
        from ..utils.cache import Cache

        cache = Cache(self.device)
        with cache.enable(self.cache_dir, self.cache_key):
            return cache.mark(name)(fn)()

    def _make_sim(self, params, encodings=None) -> QuantizationSimModel:
        sim = QuantizationSimModel(
            self.model, self.example_inputs, config=self.config,
            quant_scheme=self.quant_scheme, default_param_bw=self.param_bw,
            default_output_bw=self.output_bw, device=self.device)
        if encodings is not None:
            sim.load_encodings(encodings)
        else:
            sim.compute_encodings(params, iter(self.calib))
        return sim

    def _eval(self, sim, params) -> float:
        return self.eval_fn(lambda *a: sim.quantized_fn(params, *a))

    def _fp_forward(self, *inputs):
        with torch.no_grad():
            return torch.func.functional_call(self.model, self.params,
                                              inputs)

    def _calibrated_eval(self, name: str, params):
        """Calibrate a sim on ``params`` and evaluate it, caching the
        (encodings, accuracy) pair so a resumed run skips both. On a cache
        miss the freshly calibrated sim is returned as-is (it carries the
        analyzer/observer state that stat-dependent APIs like
        ``set_bitwidth`` + ``recompute_encodings`` need); only a cache hit
        rebuilds from the stored encodings."""
        fresh = {}

        def run():
            sim = self._make_sim(params)
            fresh["sim"] = sim
            return sim.export_encodings(), self._eval(sim, params)

        enc, acc = self._mark(name, run)
        sim = fresh.get("sim")
        if sim is None:  # cache hit: resume from the stored encodings
            sim = self._make_sim(params, encodings=enc)
        return sim, acc

    def optimize(self, allowed_accuracy_drop: float = 0.0,
                 fp32_accuracy: Optional[float] = None) -> AutoQuantResult:
        history: List[StageResult] = []
        if fp32_accuracy is None:
            fp32_accuracy = self._mark(
                "fp32_eval", lambda: self.eval_fn(self._fp_forward))
        history.append(StageResult("fp32", fp32_accuracy, False))
        target = fp32_accuracy - allowed_accuracy_drop

        best = ("quantsim", -float("inf"), self.params, None)

        # Stage 1: plain quantsim (auto_quant.py W32 eval + quantsim)
        sim, acc = self._calibrated_eval("quantsim", self.params)
        history.append(StageResult("quantsim", acc, True))
        best = max(best, ("quantsim", acc, self.params, sim),
                   key=lambda t: t[1])
        if acc >= target:
            return self._result(best, history)

        # Stage 2: BN fold + CLE (+ HBF)
        def run_cle():
            graph = ConnectedGraph(self.model, self.example_inputs,
                                   self.params)
            return equalize_model(graph, self.params)

        eq_params = self._mark("cle", run_cle)
        sim2, acc2 = self._calibrated_eval("cle_eval", eq_params)
        history.append(StageResult("cle", acc2, True))
        best = max(best, ("cle", acc2, eq_params, sim2), key=lambda t: t[1])
        if acc2 >= target:
            return self._result(best, history)

        # Stage 3: AdaRound on the better of {original, CLE'd} params
        base_params = best[2]
        sim3 = self._make_sim(base_params)
        ada_params = apply_adaround(sim3, base_params, self.calib,
                                    self.adaround_params,
                                    cache_dir=self.cache_dir,
                                    cache_key=f"{self.cache_key}.ada")
        sim3.compute_encodings(ada_params, iter(self.calib))
        acc3 = self._eval(sim3, ada_params)
        history.append(StageResult("adaround", acc3, True))
        best = max(best, ("adaround", acc3, ada_params, sim3),
                   key=lambda t: t[1])
        return self._result(best, history)

    @staticmethod
    def _result(best, history) -> AutoQuantResult:
        name, acc, params, sim = best
        return AutoQuantResult(best_stage=name, accuracy=acc, params=params,
                               sim=sim, history=history)


class AutoQuantWithAutoMixedPrecision(AutoQuant):
    """AutoQuant + AMP final stage (v1/auto_quant.py:1497): after the PTQ
    pipeline, raise the weakest quantizer groups to the higher-precision
    candidates until the accuracy target is met. The AMP stage's
    ``AmpResult`` stays on ``amp_result`` (None when it did not run), for
    ``reduce_convert_ops``."""

    def __init__(self, *args, amp_candidates=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.amp_result = None
        from .amp import Candidate, fp16_candidate
        # default candidate ladder mirrors the reference's common recipe:
        # (16, float) > (16, int) > the configured INT target
        self.amp_candidates = amp_candidates or [
            fp16_candidate(), Candidate(16, 16),
            Candidate(self.output_bw, self.param_bw)]

    def optimize(self, allowed_accuracy_drop: float = 0.0,
                 fp32_accuracy: Optional[float] = None) -> AutoQuantResult:
        result = super().optimize(allowed_accuracy_drop, fp32_accuracy)
        fp32 = result.history[0].accuracy
        if result.accuracy >= fp32 - allowed_accuracy_drop:
            return result
        # Stage 4: AMP (greedy flips from the high-precision baseline)
        from .amp import choose_mixed_precision
        sim, params = result.sim, result.params
        if not hasattr(sim, "_analyzers"):
            # sim was rebuilt from cached encodings: AMP needs the retained
            # calibration statistics to recompute per-bitwidth encodings
            sim.compute_encodings(params, iter(self.calib))

        def eval_fn(forward):
            return self.eval_fn(forward)

        amp = choose_mixed_precision(sim, params, self.amp_candidates,
                                     eval_fn, allowed_accuracy_drop)
        # kept for reduce_convert_ops (the JAX package drops it)
        self.amp_result = amp
        acc = amp.final_accuracy
        result.history.append(StageResult("amp", acc, True))
        if acc > result.accuracy:
            return AutoQuantResult("amp", acc, params, sim, result.history)
        return result
