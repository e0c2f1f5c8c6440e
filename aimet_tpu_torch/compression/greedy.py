"""Greedy per-layer compression-ratio selection — counterpart of
``aimet_tpu/compression/greedy.py``.

GreedyCompRatioSelectAlgo (aimet_common/comp_ratio_select.py:90-449):
phase 1 sweeps each layer over candidate ratios and records the eval
scores; a monotonic fit (curve_fit.py:47) cleans the curves; phase 2
bisects a global score threshold so that the aggregate cost meets the
target ratio, and reads each layer's ratio off its curve.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..graph.connected_graph import ConnectedGraph, Op
from .cost import layer_cost


@dataclasses.dataclass
class GreedySelectionParameters:
    """aimet_common/defs.py:173."""
    target_comp_ratio: float
    num_comp_ratio_candidates: int = 10
    use_monotonic_fit: bool = True


def monotonic_fit(ratios: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Non-decreasing score against ratio (curve_fit.py:47): isotonic
    regression by pool-adjacent-violators."""
    ys = [float(v) for v in np.asarray(scores, np.float64)]
    ws = [1.0] * len(ys)
    idx = [[k] for k in range(len(ys))]
    k = 0
    while k < len(ys) - 1:
        if ys[k] > ys[k + 1] + 1e-12:
            w = ws[k] + ws[k + 1]
            ys[k] = (ys[k] * ws[k] + ys[k + 1] * ws[k + 1]) / w
            ws[k] = w
            idx[k] = idx[k] + idx[k + 1]
            del ys[k + 1], ws[k + 1], idx[k + 1]
            k = max(0, k - 1)
        else:
            k += 1
    out = np.empty(len(scores))
    for yk, ik in zip(ys, idx):
        out[ik] = yk
    return out


class GreedyCompRatioSelect:
    """``eval_fn(ratio_map) -> score`` (higher is better), ``ratio_map`` a
    {layer name: ratio} of the layers compressed for the evaluation."""

    def __init__(self, graph: ConnectedGraph, layers: Sequence[Op],
                 eval_fn: Callable[[Dict[str, float]], float],
                 params: GreedySelectionParameters,
                 cost_fn: Optional[Callable[[Op, float], float]] = None):
        self.graph = graph
        self.layers = list(layers)
        self.eval_fn = eval_fn
        self.params = params
        # a layer's cost at a ratio (default: proportional MAC)
        self.cost_fn = cost_fn or (lambda op, r: layer_cost(op).mac * r)

    def _candidates(self) -> np.ndarray:
        n = self.params.num_comp_ratio_candidates
        return np.arange(1, n) / n          # 1/n .. (n-1)/n, not 1.0

    def select(self) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
        cands = self._candidates()
        curves: Dict[str, np.ndarray] = {}
        # phase 1: each layer's eval sweep (comp_ratio_select.py:366)
        for op in self.layers:
            scores = np.array([self.eval_fn({op.name: float(r)})
                               for r in cands])
            if self.params.use_monotonic_fit:
                scores = monotonic_fit(cands, scores)
            curves[op.name] = scores

        # phase 2: bisect a global score threshold (:216-449)
        total_orig = sum(layer_cost(op).mac for op in self.layers)
        target = self.params.target_comp_ratio

        def ratios_for_score(score) -> Dict[str, float]:
            out = {}
            for op in self.layers:
                ok = np.nonzero(curves[op.name] >= score)[0]
                out[op.name] = float(cands[ok[0]]) if ok.size else 1.0
            return out

        def agg_ratio(ratios) -> float:
            cost = 0.0
            for op in self.layers:
                r = ratios[op.name]
                cost += self.cost_fn(op, r) if r < 1.0 else \
                    layer_cost(op).mac
            return cost / max(total_orig, 1e-12)

        # a higher threshold asks each layer for a larger ratio (less
        # compression): find the highest one still meeting the target
        lo = min(float(c.min()) for c in curves.values())
        hi = max(float(c.max()) for c in curves.values())
        for _ in range(50):
            mid = (lo + hi) / 2
            if agg_ratio(ratios_for_score(mid)) <= target:
                lo = mid
            else:
                hi = mid
        ratios = ratios_for_score(lo)
        if agg_ratio(ratios) > target:
            # even the lowest threshold misses: the smallest candidates
            ratios = {op.name: float(cands[0]) for op in self.layers}
        return ratios, curves
