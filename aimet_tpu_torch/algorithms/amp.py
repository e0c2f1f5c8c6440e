"""Automatic Mixed Precision (AMP), greedy bitwidth assignment —
counterpart of ``aimet_tpu/algorithms/amp.py``.

Port of the reference's GreedyMixedPrecisionAlgo
(aimet_common/amp/mixed_precision_algo.py:100-800, quantizer_groups.py:46,
user API aimet_torch/mixed_precision.py:132 choose_mixed_precision):

  Phase 1: for each quantizer group, set it alone to each lower-precision
  candidate and record the eval score -> per-group sensitivity list.
  Phase 2: sort (group, candidate) pairs by score descending; flip groups to
  lower precision cumulatively, re-evaluating, building the pareto front of
  (running cost, accuracy); stop when accuracy drops below
  ``allowed_accuracy_drop``.

Quantizer groups here are per-op: the op's output activation quantizer plus
its param quantizers (the reference discovers groups over the
ConnectedGraph the same way).

The port's sim keys its activation and model-input quantizers by graph
node; ``QuantizationSimModel.product_quantizer`` gives the quantizer on a
``Product``, where the JAX sim looks a var up in ``_act_var_q`` /
``_input_var_q``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..quantsim.qsim import QuantizationSimModel


@dataclasses.dataclass(frozen=True)
class Candidate:
    """((act_bw, act_dtype), (param_bw, param_dtype)) — the reference's
    CANDIDATE_WITH_DTYPE (aimet_common/defs.py:309 QuantizationDataType):
    candidates may mix e.g. (8, 'int') activations with (16, 'float'), so
    the standard INT8-vs-FP16 AMP recipe is expressible."""
    act_bw: int
    param_bw: int
    act_dtype: str = "int"
    param_dtype: str = "int"


def fp16_candidate() -> Candidate:
    """The reference's (16, float)/(16, float) AMP candidate."""
    return Candidate(16, 16, "float", "float")


@dataclasses.dataclass
class QuantizerGroup:
    name: str
    act_quantizers: List[str]
    param_quantizers: List[str]

    def bit_cost(self, cand: Candidate) -> float:
        return (len(self.act_quantizers) * cand.act_bw
                + len(self.param_quantizers) * cand.param_bw)


def _feeding_act_quantizer(sim: QuantizationSimModel, op) -> Optional[str]:
    """The activation/input quantizer on the tensor feeding ``op``'s MAC,
    walking upstream through single-input pass-through ops that carry no
    quantizer of their own (the reference's ops_to_skip walk,
    quantizer_groups.py:229-254)."""
    if not op.inputs:
        return None
    prod = op.inputs[0]
    hops = 0
    while hops < 16:
        q = sim.product_quantizer(prod)
        if q is not None:
            return q
        p = prod.producer
        if p is None or len(p.inputs) != 1:
            return None
        if p.name in sim.quantizers:
            return p.name
        prod = p.inputs[0]
        hops += 1
    return None


def find_quantizer_groups(sim: QuantizationSimModel) -> List[QuantizerGroup]:
    """Cross-op quantizer groups (amp/quantizer_groups.py:62-337): each
    activation tensor's quantizer is grouped with the param quantizers of
    every layer it feeds (through pass-through ops), so one candidate flip
    moves the whole (activation, weights) pair entering a MAC — and shared
    activations on branchy graphs are evaluated ONCE, not once per
    consumer."""
    group_of: Dict[str, QuantizerGroup] = {}
    order: List[str] = []
    for name, spec in sim.quantizers.items():
        if spec.kind != "param":
            group_of[name] = QuantizerGroup(name, [name], [])
            order.append(name)

    leftovers: List[QuantizerGroup] = []
    for op in sim.graph.ops:
        params = [p.param_path for p in op.param_products.values()
                  if p.param_path in sim.quantizers]
        if not params:
            continue
        # a dedicated per-op input quantizer IS the feeding quantizer
        feeder = (f"{op.name}_input"
                  if f"{op.name}_input" in sim.quantizers else
                  _feeding_act_quantizer(sim, op))
        if feeder is not None and feeder in group_of:
            group_of[feeder].param_quantizers.extend(params)
        else:
            leftovers.append(QuantizerGroup(f"{op.name}_params", [], params))
    return [group_of[n] for n in order] + leftovers


@dataclasses.dataclass
class AmpResult:
    group_bitwidths: Dict[str, Candidate]
    pareto_front: List[Tuple[float, float]]   # (relative bit cost, accuracy)
    baseline_accuracy: float
    final_accuracy: float
    phase1_scores: Dict[Tuple[str, Candidate], float]


class GreedyMixedPrecision:
    def __init__(self, sim: QuantizationSimModel, params,
                 candidates: Sequence[Candidate],
                 eval_fn: Callable[[Callable], float],
                 allowed_accuracy_drop: float):
        """candidates must be ordered highest precision first; the first is
        the baseline (max precision)."""
        self.sim = sim
        self.params = params
        self.candidates = list(candidates)
        self.eval_fn = eval_fn
        self.allowed_drop = allowed_accuracy_drop
        self.groups = find_quantizer_groups(sim)

    def _set_group(self, group: QuantizerGroup, cand: Candidate):
        for n in group.act_quantizers:
            self.sim.set_quantizer_data_type(n, cand.act_dtype, cand.act_bw)
        for n in group.param_quantizers:
            self.sim.set_quantizer_data_type(n, cand.param_dtype,
                                             cand.param_bw)

    def _eval(self) -> float:
        return self.eval_fn(
            lambda *args: self.sim.quantized_fn(self.params, *args))

    def run(self) -> AmpResult:
        base_cand = self.candidates[0]
        lower = self.candidates[1:]
        for g in self.groups:
            self._set_group(g, base_cand)
        baseline = self._eval()

        # Phase 1: per-group sensitivity (mixed_precision_algo.py:610)
        phase1: Dict[Tuple[str, Candidate], float] = {}
        for g in self.groups:
            for cand in lower:
                self._set_group(g, cand)
                phase1[(g.name, cand)] = self._eval()
                self._set_group(g, base_cand)

        # Phase 2: greedy flips by descending score (:742)
        order = sorted(phase1.items(), key=lambda kv: kv[1], reverse=True)
        group_by_name = {g.name: g for g in self.groups}
        assignment = {g.name: base_cand for g in self.groups}
        max_cost = sum(g.bit_cost(base_cand) for g in self.groups)
        pareto: List[Tuple[float, float]] = [(1.0, baseline)]
        acc = baseline
        for (gname, cand), _ in order:
            g = group_by_name[gname]
            # only move to lower precision than currently assigned
            cur = assignment[gname]
            if g.bit_cost(cand) >= g.bit_cost(cur):
                continue
            self._set_group(g, cand)
            new_acc = self._eval()
            if baseline - new_acc > self.allowed_drop:
                self._set_group(g, cur)  # revert
                continue
            assignment[gname] = cand
            acc = new_acc
            cost = sum(group_by_name[n].bit_cost(c)
                       for n, c in assignment.items()) / max_cost
            pareto.append((cost, acc))

        return AmpResult(assignment, pareto, baseline, acc, phase1)


@dataclasses.dataclass
class ConvertOpResult:
    assignment: Dict[str, Candidate]
    converts_before: int
    converts_after: int
    cost_ratio: float          # final bit cost / max-precision bit cost


def _count_convert_ops(sim: QuantizationSimModel,
                       act_bw: Dict[str, int]) -> int:
    """Count producer->consumer edges whose activation precisions differ.

    On target HW every such boundary is a dtype-convert op
    (amp/convert_ops_reduction.py ReduceConvertOps). Ops without an
    activation quantizer inherit their producer's precision
    (pass-through)."""
    resolved: Dict[str, int] = {}

    def bw_of(op) -> int:
        if op.name in resolved:
            return resolved[op.name]
        resolved[op.name] = -1          # cycle guard
        if op.name in act_bw:
            resolved[op.name] = act_bw[op.name]
        else:
            prods = op.input_ops
            resolved[op.name] = bw_of(prods[0]) if prods else -1
        return resolved[op.name]

    converts = 0
    for op in sim.graph.ops:
        b = bw_of(op)
        for prod in op.input_ops:
            pb = bw_of(prod)
            if pb != -1 and b != -1 and pb != b:
                converts += 1
    return converts


def reduce_convert_ops(sim: QuantizationSimModel, result: AmpResult,
                       candidates: Sequence[Candidate],
                       alpha: float = 0.2) -> ConvertOpResult:
    """Post-AMP pass reducing dtype-convert ops at precision boundaries
    (aimet_common/amp/convert_ops_reduction.py).

    Greedily promotes lower-precision quantizer groups to their
    higher-precision neighbor's candidate when that strictly reduces the
    convert-op count, as long as the total bit cost stays within
    ``(1 + alpha) x`` the post-AMP cost. Promotion moves toward the
    baseline precision, so accuracy can only improve — no re-eval needed.
    Applies the final assignment to ``sim`` and returns it.
    """
    groups = {g.name: g for g in find_quantizer_groups(sim)}
    assignment = dict(result.group_bitwidths)

    def promote_candidate(cur: Candidate, act_key) -> Optional[Candidate]:
        """Candidate at the target act precision WITHOUT demoting params:
        prefer the same param_bw as currently assigned, else the smallest
        param_bw that is still >= current. Precision keys are
        (bitwidth, dtype) so INT and FLOAT act candidates at the same
        bitwidth are distinct boundaries."""
        pool = [c for c in candidates
                if (c.act_bw, c.act_dtype) == act_key
                and c.param_bw >= cur.param_bw]
        if not pool:
            return None
        return min(pool, key=lambda c: c.param_bw)

    def act_bw_map():
        return {n: (c.act_bw, c.act_dtype) for n, c in assignment.items()
                if groups[n].act_quantizers}

    ops_by_name = {op.name: op for op in sim.graph.ops}
    before = _count_convert_ops(sim, act_bw_map())
    base_cost = sum(groups[n].bit_cost(c) for n, c in assignment.items())
    max_cost = base_cost * (1.0 + alpha)

    def quantized_neighbors(bw):
        """Undirected adjacency between act-quantized ops, walking THROUGH
        pass-through ops (supergroup members without their own output
        quantizer inherit precision, so they don't break contiguity)."""
        adj = {n: set() for n in bw}
        for name in bw:
            stack = list(ops_by_name[name].input_ops) \
                if name in ops_by_name else []
            visited = set()
            while stack:
                o = stack.pop()
                if o.name in visited:
                    continue
                visited.add(o.name)
                if o.name in bw:
                    adj[name].add(o.name)
                    adj[o.name].add(name)
                else:
                    stack.extend(o.input_ops)
        return adj

    def regions(bw, adj):
        """Connected components of same-act-bw ops.
        The reference also reasons about contiguous same-precision spans
        rather than single ops (convert_ops_reduction.py)."""
        seen, comps = set(), []
        for name in bw:
            if name in seen:
                continue
            comp, stack = [], [name]
            seen.add(name)
            while stack:
                n = stack.pop()
                comp.append(n)
                for o in adj[n]:
                    if o not in seen and bw[o] == bw[n]:
                        seen.add(o)
                        stack.append(o)
            comps.append(comp)
        return comps

    while True:
        bw = act_bw_map()
        cur = _count_convert_ops(sim, bw)
        if cur == 0:
            break
        best = None   # (new_converts, cost, trial assignment)
        adj = quantized_neighbors(bw)
        for comp in regions(bw, adj):
            b = bw[comp[0]]
            neigh_bws = set()
            for n in comp:
                neigh_bws |= {bw[o] for o in adj[n]}
            for nb in sorted(x for x in neigh_bws if x > b):
                trial = dict(assignment)
                promotable = True
                for n in comp:
                    new_cand = promote_candidate(assignment[n], nb)
                    if new_cand is None:
                        promotable = False
                        break
                    trial[n] = new_cand
                if not promotable:
                    continue
                trial_bw = {n: (c.act_bw, c.act_dtype)
                            for n, c in trial.items()
                            if groups[n].act_quantizers}
                n_conv = _count_convert_ops(sim, trial_bw)
                cost = sum(groups[n].bit_cost(c) for n, c in trial.items())
                if n_conv < cur and cost <= max_cost:
                    key = (n_conv, cost)
                    if best is None or key < best[:2]:
                        best = (n_conv, cost, trial)
        if best is None:
            break
        assignment = best[2]

    for name, cand in assignment.items():
        g = groups[name]
        for n in g.act_quantizers:
            sim.set_quantizer_data_type(n, cand.act_dtype, cand.act_bw)
        for n in g.param_quantizers:
            sim.set_quantizer_data_type(n, cand.param_dtype, cand.param_bw)
    final_cost = sum(groups[n].bit_cost(c) for n, c in assignment.items())
    max_prec_cost = sum(g.bit_cost(candidates[0]) for g in groups.values())
    return ConvertOpResult(assignment, before,
                           _count_convert_ops(sim, act_bw_map()),
                           final_cost / max_prec_cost)


def choose_mixed_precision(sim: QuantizationSimModel, params,
                           candidates: Sequence[Candidate],
                           eval_fn: Callable, allowed_accuracy_drop: float
                           ) -> AmpResult:
    """User API (mixed_precision.py:132). Leaves ``sim`` configured at the
    chosen per-group bitwidths."""
    algo = GreedyMixedPrecision(sim, params, candidates, eval_fn,
                                allowed_accuracy_drop)
    return algo.run()
