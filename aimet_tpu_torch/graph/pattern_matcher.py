"""Generic sub-graph pattern matching over the ConnectedGraph —
counterpart of ``aimet_tpu/graph/pattern_matcher.py``.

Port of the reference's graph searcher (aimet_common/graph_searcher.py
GraphSearcher + graph_pattern_matcher.PatternType): where the reference
slides op-type *sequences* over DFS traversals, patterns here are small
DAGs — named nodes with admissible op-type sets plus directed edges — so
BRANCHING structures (residual blocks, multi-input supergroups) match
directly instead of needing per-branch sequence hacks.

Matching is plain backtracking over candidate ops (model graphs are a few
hundred ops; patterns are a handful of nodes), with producer/consumer
adjacency from the graph's Products.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

from .connected_graph import ConnectedGraph, Op

TypeSpec = Union[str, Iterable[str]]


def _as_set(t: TypeSpec) -> Set[str]:
    return {t} if isinstance(t, str) else set(t)


@dataclasses.dataclass
class SubgraphPattern:
    """nodes: name -> admissible op type(s); edges: (producer, consumer)
    meaning consumer has producer's output among its data inputs."""
    nodes: Dict[str, TypeSpec]
    edges: List[Tuple[str, str]]

    def __post_init__(self):
        names = set(self.nodes)
        for a, b in self.edges:
            if a not in names or b not in names:
                raise ValueError(f"edge ({a}, {b}) references unknown node")


def find_pattern(graph: ConnectedGraph, pattern: SubgraphPattern,
                 *, allow_overlap: bool = False) -> List[Dict[str, Op]]:
    """All matches of ``pattern`` as {node name: Op} dicts.

    A match binds distinct ops; with ``allow_overlap=False`` (default) an
    op participates in at most one returned match (first-found wins, in
    graph order), mirroring the reference's single-claim supergroup
    semantics (quantsim_config.py:74-110)."""
    type_sets = {n: _as_set(t) for n, t in pattern.nodes.items()}
    succ: Dict[str, List[str]] = {n: [] for n in pattern.nodes}
    pred: Dict[str, List[str]] = {n: [] for n in pattern.nodes}
    for a, b in pattern.edges:
        succ[a].append(b)
        pred[b].append(a)

    # match most-constrained-first: nodes ordered so each (after the first)
    # touches an already-placed node when possible
    order: List[str] = []
    placed: Set[str] = set()
    remaining = set(pattern.nodes)
    while remaining:
        cand = [n for n in remaining
                if any(m in placed for m in succ[n] + pred[n])] or \
               sorted(remaining)
        n = sorted(cand)[0]
        order.append(n)
        placed.add(n)
        remaining.discard(n)

    def feeds(a: Op, b: Op) -> bool:
        return any(p.producer is a for p in b.inputs)

    matches: List[Dict[str, Op]] = []
    claimed: Set[int] = set()

    def bt(i: int, binding: Dict[str, Op]):
        if i == len(order):
            matches.append(dict(binding))
            return True
        name = order[i]
        for op in graph.ops:
            if op.type not in type_sets[name]:
                continue
            if not allow_overlap and id(op) in claimed:
                continue
            if any(op is b for b in binding.values()):
                continue
            ok = all(feeds(binding[p], op)
                     for p in pred[name] if p in binding)
            ok = ok and all(feeds(op, binding[s])
                            for s in succ[name] if s in binding)
            if not ok:
                continue
            binding[name] = op
            if bt(i + 1, binding) and not allow_overlap:
                del binding[name]
                return True   # commit this match; restart scan
            binding.pop(name, None)
        return False

    if allow_overlap:
        # exhaustive: enumerate all bindings
        def bt_all(i: int, binding: Dict[str, Op]):
            if i == len(order):
                matches.append(dict(binding))
                return
            name = order[i]
            for op in graph.ops:
                if op.type not in type_sets[name]:
                    continue
                if any(op is b for b in binding.values()):
                    continue
                if not all(feeds(binding[p], op)
                           for p in pred[name] if p in binding):
                    continue
                if not all(feeds(op, binding[s])
                           for s in succ[name] if s in binding):
                    continue
                binding[name] = op
                bt_all(i + 1, binding)
                del binding[name]

        bt_all(0, {})
        return matches

    while bt(0, {}):
        for op in matches[-1].values():
            claimed.add(id(op))
    return matches


def match_chain(graph: ConnectedGraph, types: Sequence[str],
                *, allow_overlap: bool = False) -> List[List[Op]]:
    """Linear-sequence convenience (the reference's common PatternType
    case): returns matches as op lists in pattern order."""
    names = [f"n{i}" for i in range(len(types))]
    pat = SubgraphPattern(nodes=dict(zip(names, types)),
                          edges=list(zip(names, names[1:])))
    return [[m[n] for n in names]
            for m in find_pattern(graph, pat, allow_overlap=allow_overlap)]
