"""Layer cost model (memory / MAC) and the SVD cost functions —
counterpart of ``aimet_tpu/compression/cost.py``.

The reference's cost calculators (aimet_common/cost_calculator.py:71-380):
a layer's memory is its weight count, its MAC the weight count times the
output's spatial size; spatial SVD turns a conv (Noc, Nic, kh, kw) into
(r, Nic, kh, 1) + (Noc, r, 1, kw), weight SVD into (r, Nic, kh, kw) +
(Noc, r, 1, 1). Kernels are the port's: OIHW convs (NCHW outputs), (in,
out) dense kernels, or (out, in) where the graph transposes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from ..algorithms.bn_fold import _conv_axes
from ..graph.connected_graph import ConnectedGraph, Op


@dataclasses.dataclass
class Cost:
    memory: float
    mac: float

    def __add__(self, other):
        return Cost(self.memory + other.memory, self.mac + other.mac)

    def __sub__(self, other):
        return Cost(self.memory - other.memory, self.mac - other.mac)


def _kernel_shape(op: Op) -> Tuple[int, ...]:
    """The kernel's shape; a re-traced compressed graph may hold it as a
    constant of the model rather than a parameter: read the conv's or the
    matmul's weight operand then."""
    if "kernel" in op.param_products:
        return tuple(op.param_products["kernel"].shape)
    node = op.nodes[0]
    w = node.args[1] if op.type != "linear" or len(node.args) < 3 \
        else node.args[2]
    return tuple(w.meta["val"].shape)


def _conv_dims(op: Op):
    """(kh, kw, n_in, n_out, out_h, out_w) of a conv op (OIHW kernel,
    NCHW output)."""
    k = _kernel_shape(op)
    spatial = list(k[2:]) + [1, 1]
    out = list(op.output.shape[2:]) + [1, 1]
    return spatial[0], spatial[1], k[1], k[0], out[0], out[1]


def _dense_dims(op: Op) -> Tuple[int, int]:
    """(n_in, n_out) of a linear op's kernel."""
    k = _kernel_shape(op)
    out_ax, in_ax, _ = _conv_axes(op)
    return k[in_ax], k[out_ax]


def layer_cost(op: Op) -> Cost:
    if op.type in ("conv", "depthwise_conv"):
        kh, kw, n_in, n_out, oh, ow = _conv_dims(op)
        mem = kh * kw * n_in * n_out
        return Cost(mem, mem * oh * ow)
    if op.type == "linear":
        mem = math.prod(_kernel_shape(op))
        return Cost(mem, mem)
    return Cost(0, 0)


def spatial_svd_cost(op: Op, rank: int) -> Cost:
    kh, kw, n_in, n_out, oh, ow = _conv_dims(op)
    mem = n_in * rank * kh + rank * n_out * kw
    # the first conv's output keeps the full width: approximated, as the
    # reference does, with oh * ow for both
    mac = n_in * rank * kh * oh * ow + rank * n_out * kw * oh * ow
    return Cost(mem, mac)


def weight_svd_cost(op: Op, rank: int) -> Cost:
    if op.type == "linear":
        n_in, n_out = _dense_dims(op)
        mem = n_in * rank + rank * n_out
        return Cost(mem, mem)
    kh, kw, n_in, n_out, oh, ow = _conv_dims(op)
    mem = kh * kw * n_in * rank + rank * n_out
    mac = kh * kw * n_in * rank * oh * ow + rank * n_out * oh * ow
    return Cost(mem, mac)


def successive_svd_cost(op: Op, rank_r: int, rank_s: int) -> Cost:
    """TYPE_SUCCESSIVE (SvdAlgorithm.cpp:102-106): (I*s) + (s*r*kh*kw) +
    (r*O), each times the output spatial size."""
    kh, kw, n_in, n_out, oh, ow = _conv_dims(op)
    mem = n_in * rank_s + rank_s * rank_r * kh * kw + rank_r * n_out
    return Cost(mem, mem * oh * ow)


def ranks_for_comp_ratio_ssvd(op: Op, comp_ratio: float) -> Tuple[int, int]:
    """(r, s) for successive SVD at the target MAC ratio: among the valid
    pairs (SvdAlgorithm.cpp:221-240), the one with the largest r * s under
    the budget."""
    kh, kw, n_in, n_out, _, _ = _conv_dims(op)
    budget = comp_ratio * layer_cost(op).mac
    best, best_score = (1, 1), -1
    for r in range(1, n_out + 1):
        max_s = min(n_in, r * kh * kw)
        if successive_svd_cost(op, r, 1).mac > budget:
            continue
        lo, hi = 1, max_s          # largest s under the budget
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if successive_svd_cost(op, r, mid).mac <= budget:
                lo = mid
            else:
                hi = mid - 1
        if r * lo > best_score:
            best, best_score = (r, lo), r * lo
    return best


def max_spatial_svd_rank(op: Op) -> int:
    """min(Nic * kh, Noc * kw) (cost_calculator.py:290-326)."""
    kh, kw, n_in, n_out, _, _ = _conv_dims(op)
    return min(n_in * kh, n_out * kw)


def max_weight_svd_rank(op: Op) -> int:
    if op.type == "linear":
        return min(_dense_dims(op))
    kh, kw, n_in, n_out, _, _ = _conv_dims(op)
    return min(n_in * kh * kw, n_out)


def rank_for_comp_ratio(op: Op, comp_ratio: float, mode: str = "spatial_svd",
                        rounding_multiplicity: int = 1) -> int:
    """The largest rank whose MAC is at most comp_ratio x the layer's
    (comp_ratio_rounder.py:62-120, cost metric MAC)."""
    orig = layer_cost(op).mac
    max_rank = (max_spatial_svd_rank(op) if mode == "spatial_svd"
                else max_weight_svd_rank(op))
    cost_fn = spatial_svd_cost if mode == "spatial_svd" else weight_svd_cost
    best = 1
    for r in range(1, max_rank + 1):
        if cost_fn(op, r).mac <= comp_ratio * orig:
            best = r
        else:
            break
    return max(1, (best // rounding_multiplicity) * rounding_multiplicity)


def model_cost(graph: ConnectedGraph) -> Cost:
    total = Cost(0, 0)
    for op in graph.ops:
        total = total + layer_cost(op)
    return total
