"""Winnow: channel-mask propagation and model reduction — counterpart of
``aimet_tpu/compression/winnow.py``.

The reference's winnow subsystem (aimet_common/winnow/mask.py:123-436
connectivity classes, mask_propagation_winnower.py:46, torch
winnow/winnow.py:48 winnow_model), with removals propagated as index sets
over a breadth-first walk of the product graph, as the JAX package does:

* Direct ops (relu / clip / pools / affine scale) pass the set through
  (DirectInternalConnectivity).
* Elementwise joins (add / sub / mul / ...) take the removal on every
  operand (AddInternalConnectivity).
* A product with several consumers sends it into every one
  (SplitInternalConnectivity).
* Concat maps the set across the segment offsets, both ways
  (ConcatInternalConnectivity).
* conv / linear bound a channel space (NullInternalConnectivity): a
  reader slices its kernel's input axis, a writer its output axis (and
  bias).
* BatchNorm and per-channel affine ops slice their per-channel parameters.

A seed whose propagation meets something that cannot shrink (a model
input or output, a grouped conv, an op without a rule) falls back to a
channel gather at the seed's input (the reference's DownsampleLayer).

The port walks the aten graph's products (fx nodes) where the JAX package
walks jaxpr vars. Kernels are OIHW (output axis 0, input axis 1) and
(in, out) dense kernels; activations NCHW (channel axis 1). The reduced
model is the traced graph evaluated with replacement functions; the
parameters are not changed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch import fx

from ..algorithms.bn_fold import _conv_axes, bn_affine_params
from ..graph.connected_graph import ConnectedGraph, Op
from ..graph.interpreter import evaluate_with_replacements
from .svd import conv2d

# connectivity classes (winnow/mask.py)
DIRECT = {"relu", "clip", "maxpool", "avgpool", "window_sum", "max", "min",
          "sigmoid", "tanh", "gelu", "silu", "softsign", "leaky_relu",
          "identity"}
ELEMWISE = {"add", "sub", "mul", "div", "max", "min"}
LAYERS = {"conv", "linear"}
PARAM_DIRECT = {"batchnorm", "scale", "depthwise_conv"}


class _Blocked(Exception):
    """A removal set cannot propagate past an op."""


@dataclasses.dataclass
class WinnowPlan:
    """The result of mask propagation for one or more seeds."""
    # op name -> [(param role, axis, keep indices)]
    layer_slices: Dict[str, List[Tuple[str, int, np.ndarray]]] = \
        dataclasses.field(default_factory=dict)
    # ops rebuilt (direct / elementwise / affine), op name -> kind
    rebuilt_ops: Dict[str, str] = dataclasses.field(default_factory=dict)
    # affine rebuilds: op name -> (channel axis, keep indices)
    affine_ops: Dict[str, Tuple[int, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    # seed op name -> keep indices of an input gather (the fallback)
    gathers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # seed op name -> why it fell back to a gather
    fallbacks: Dict[str, str] = dataclasses.field(default_factory=dict)


def _feature_axis(op: Op, prod) -> Optional[int]:
    """The channel axis of ``prod`` as layer ``op`` reads or writes it."""
    if op.type in ("conv", "depthwise_conv", "conv_transpose"):
        return 1
    if op.type == "linear":
        if prod is op.output:
            return len(prod.shape) - 1
        # the product may be a pre-reshape alias of the traced lhs: only
        # (N, C) / (N, C, 1...) / (N, 1..., C) shapes map channels 1:1
        _, in_ax, _ = _conv_axes(op)
        n_in = op.param_products["kernel"].shape[in_ax]
        cand = [d for d in range(1, len(prod.shape))
                if prod.shape[d] == n_in]
        others = [d for d in range(1, len(prod.shape))
                  if prod.shape[d] != n_in]
        if cand and all(prod.shape[d] == 1 for d in others):
            return cand[0]
        return None
    return None


def _groups(op: Op) -> int:
    return int(op.nodes[0].args[8]) if op.type in (
        "conv", "depthwise_conv", "conv_transpose") else 1


class _Propagator:
    """Fixpoint removal-set propagation over (product, axis) nodes: each
    accumulates the removals in its own channel frame and a visit passes
    on only the not-yet-seen delta, so seeds whose spaces meet (across a
    concat too) are reconciled in the right frame at every node."""

    def __init__(self, graph: ConnectedGraph):
        self.graph = graph
        self.layer_slices: Dict[str, List[Tuple[str, int, np.ndarray]]] = {}
        self.rebuilt: Dict[str, str] = {}
        # op name -> (axis, accumulated removal set, channel count)
        self.affine: Dict[str, Tuple[int, Set[int], int]] = {}
        self._seen: Dict[Tuple[fx.Node, int], Set[int]] = {}
        self._model_outs = {graph.resolve(n) for n in graph.output_nodes}

    def _keep(self, n: int, remove: Set[int]) -> np.ndarray:
        bad = sorted(c for c in remove if not 0 <= c < n)
        if bad:
            raise ValueError(
                f"channel indices {bad} out of range for size-{n} axis")
        return np.asarray(sorted(set(range(n)) - remove))

    def _add_layer_slice(self, op: Op, role: str, axis: int, n: int,
                         remove: Set[int]):
        self.layer_slices.setdefault(op.name, []).append(
            (role, axis, self._keep(n, remove)))

    # -- per-op transfer --------------------------------------------------
    def _through_op_downstream(self, op: Op, prod, axis: int,
                               remove: Set[int]):
        """``prod`` (an input of ``op``) loses channels: make ``op`` cope."""
        t = op.type
        if t in LAYERS:
            if _feature_axis(op, prod) != axis:
                raise _Blocked(f"{op.name}: channel axis mismatch")
            if t == "conv" and _groups(op) != 1:
                raise _Blocked(f"{op.name}: grouped conv input")
            _, in_ax, _ = _conv_axes(op)
            self._add_layer_slice(op, "kernel", in_ax,
                                  op.param_products["kernel"].shape[in_ax],
                                  remove)
            return                   # a space boundary: stops here
        if t == "depthwise_conv":
            if prod.shape[1] != op.output.shape[1]:
                raise _Blocked(f"{op.name}: depthwise multiplier != 1")
            self._add_layer_slice(op, "kernel", 0,
                                  op.param_products["kernel"].shape[0],
                                  remove)
            if "bias" in op.param_products:
                self._add_layer_slice(op, "bias", 0,
                                      op.param_products["bias"].shape[0],
                                      remove)
            self.rebuilt[op.name] = "depthwise"
            self._visit(op.output, 1, remove)
            return
        if t in ("batchnorm", "scale") and op.param_products:
            for role, pp in op.param_products.items():
                if len(pp.shape) == 1 and pp.shape[0] == prod.shape[axis]:
                    continue          # sliced by the affine rebuild
                if pp.shape not in ((), (1,)):
                    raise _Blocked(f"{op.name}: non-per-channel param")
            self.rebuilt[op.name] = "affine"
            prev_ax, prev, _ = self.affine.get(op.name, (axis, set(), 0))
            if prev and prev_ax != axis:
                raise _Blocked(
                    f"{op.name}: channel removals on conflicting axes "
                    f"{prev_ax} and {axis}")
            self.affine[op.name] = (axis, set(prev) | set(remove),
                                    prod.shape[axis])
            self._visit(op.output, axis, remove)
            return
        if t in ELEMWISE and len(op.inputs) > 1:
            if len(op.output.shape) <= axis \
                    or op.output.shape[axis] != prod.shape[axis]:
                raise _Blocked(f"{op.name}: elementwise reshapes channels")
            self.rebuilt[op.name] = "replay"
            for other in op.inputs:
                if other is prod:
                    continue
                if len(other.shape) != len(op.output.shape) or \
                        other.shape[axis] != op.output.shape[axis]:
                    if len(other.shape) <= axis or other.shape[axis] == 1:
                        continue      # a broadcast operand: unaffected
                    raise _Blocked(f"{op.name}: operand shape mismatch")
                self._visit(other, axis, remove)
            self._visit(op.output, axis, remove)
            return
        if t in DIRECT or t == "custom" \
                or (t == "scale" and not op.param_products) \
                or (t in ELEMWISE and len(op.inputs) == 1):
            if len(op.output.shape) != len(prod.shape) \
                    or op.output.shape[axis] != prod.shape[axis]:
                raise _Blocked(f"{op.name}: not channel-preserving")
            self.rebuilt[op.name] = "replay"
            self._visit(op.output, axis, remove)
            return
        if t == "mean":
            axes = tuple(op.attrs.get("axes", ()))
            if axis in axes:
                raise _Blocked(f"{op.name}: reduces the channel axis")
            self.rebuilt[op.name] = "replay"
            self._visit(op.output, axis - sum(1 for a in axes if a < axis),
                        remove)
            return
        if t == "concat":
            if op.attrs.get("dimension") != axis:
                raise _Blocked(
                    f"{op.name}: concat on axis {op.attrs.get('dimension')} "
                    f"not supported for channel axis {axis}")
            off = 0
            for p in op.inputs:
                if p is prod:
                    break
                off += p.shape[axis]
            self.rebuilt[op.name] = "replay"
            self._visit(op.output, axis, {c + off for c in remove})
            return
        raise _Blocked(f"{op.name}: unsupported consumer type {t!r}")

    def _through_op_upstream(self, op: Op, axis: int, remove: Set[int]):
        """``op``'s output loses channels: shrink what produces them."""
        t = op.type
        if t in LAYERS:
            if _feature_axis(op, op.output) != axis:
                raise _Blocked(f"{op.name}: output channel axis mismatch")
            if t == "conv" and _groups(op) != 1:
                raise _Blocked(f"{op.name}: grouped conv output")
            out_ax, _, _ = _conv_axes(op)
            self._add_layer_slice(op, "kernel", out_ax,
                                  op.param_products["kernel"].shape[out_ax],
                                  remove)
            if "bias" in op.param_products:
                self._add_layer_slice(op, "bias", 0,
                                      op.param_products["bias"].shape[0],
                                      remove)
            return
        if t == "depthwise_conv":
            self._visit(op.inputs[0], 1, remove)
            return
        if t in ("batchnorm", "scale") and op.param_products:
            self._visit(op.inputs[0], axis, remove)
            return
        if t in ELEMWISE and len(op.inputs) > 1:
            self.rebuilt[op.name] = "replay"
            for prod in op.inputs:
                if len(prod.shape) <= axis or prod.shape[axis] == 1:
                    continue          # a broadcast operand
                if prod.shape[axis] != op.output.shape[axis]:
                    raise _Blocked(f"{op.name}: operand shape mismatch")
                self._visit(prod, axis, remove)
            return
        if t in DIRECT or t == "custom" \
                or (t == "scale" and not op.param_products) \
                or (t in ELEMWISE and len(op.inputs) == 1):
            prod = op.inputs[0]
            if len(prod.shape) != len(op.output.shape) \
                    or prod.shape[axis] != op.output.shape[axis]:
                raise _Blocked(f"{op.name}: not channel-preserving")
            self.rebuilt[op.name] = "replay"
            self._visit(prod, axis, remove)
            return
        if t == "mean":
            old_axis = axis
            for a in sorted(op.attrs.get("axes", ())):
                if a <= old_axis:
                    old_axis += 1
            self.rebuilt[op.name] = "replay"
            self._visit(op.inputs[0], old_axis, remove)
            return
        if t == "concat":
            if op.attrs.get("dimension") != axis:
                raise _Blocked(f"{op.name}: concat axis mismatch")
            self.rebuilt[op.name] = "replay"
            off = 0
            for p in op.inputs:
                seg = {c - off for c in remove
                       if off <= c < off + p.shape[axis]}
                if seg:
                    self._visit(p, axis, seg)
                off += p.shape[axis]
            return
        raise _Blocked(f"{op.name}: unsupported producer type {t!r}")

    def _visit(self, prod, axis: int, remove: Set[int]):
        """Channels ``remove`` (in ``prod``'s own frame) vanish from
        ``prod`` along ``axis``: reconcile its producer and every
        consumer."""
        seen = self._seen.setdefault((prod.node, axis), set())
        new = set(remove) - seen
        if not new:
            return
        seen |= new
        if self.graph.resolve(prod.node) in self._model_outs:
            raise _Blocked(f"{prod.name}: model output cannot shrink")
        if prod.kind == "input":
            raise _Blocked(f"{prod.name}: model input cannot shrink")
        if prod.producer is not None:
            self._through_op_upstream(prod.producer, axis, new)
        elif prod.kind != "param":
            raise _Blocked(f"{prod.name}: no producer")
        for consumer in prod.consumers:
            self._through_op_downstream(consumer, prod, axis, new)


def plan_winnow(graph: ConnectedGraph,
                masks: Dict[str, Sequence[int]]) -> WinnowPlan:
    """Propagate each seed op's input-channel removals and return the
    slicing / rebuild plan (mask_propagation_winnower.py:46). ``masks``:
    op name -> input channels to REMOVE from that conv / linear. A seed
    whose propagation is blocked falls back to an input gather."""
    plan = WinnowPlan()
    seeds = []
    for name, remove in masks.items():
        op = graph.get_op(name)
        if op.type not in ("conv", "linear", "depthwise_conv"):
            raise ValueError(f"cannot winnow {name}: type {op.type!r}")
        remove = set(int(c) for c in remove)
        _, in_ax, _ = _conv_axes(op)
        n_in = op.param_products["kernel"].shape[in_ax]
        bad = sorted(c for c in remove if not 0 <= c < n_in)
        if bad:
            raise ValueError(
                f"cannot winnow {name}: channel indices {bad} out of range "
                f"for {n_in} input channels")
        in_fax = _feature_axis(op, op.inputs[0])
        if in_fax is None:
            raise ValueError(
                f"cannot winnow {name}: input channel axis is ambiguous "
                f"(aliased input of shape {op.inputs[0].shape})")
        seeds.append((name, op, remove, in_ax, n_in, in_fax))

    # pass 1: each seed alone; a blocked seed falls back to a gather
    active = []
    for seed in seeds:
        name, op, remove, in_ax, n_in, in_fax = seed
        try:
            _Propagator(graph)._visit(op.inputs[0], in_fax, remove)
        except _Blocked as e:
            plan.fallbacks[name] = str(e)
            plan.gathers[name] = np.asarray(
                sorted(set(range(n_in)) - remove))
            plan.layer_slices.setdefault(name, []).append(
                ("kernel", in_ax, plan.gathers[name]))
            continue
        active.append(seed)

    # pass 2: one fixpoint propagation over every vetted seed
    while True:
        prop = _Propagator(graph)
        blocked = None
        try:
            for name, op, remove, in_ax, n_in, in_fax in active:
                prop._add_layer_slice(op, "kernel", in_ax, n_in, remove)
                prop._visit(op.inputs[0], in_fax, remove)
        except _Blocked as e:   # pragma: no cover - pass 1 vetted them
            blocked = (name, remove, in_ax, n_in, str(e))
        if blocked is None:
            break
        name, remove, in_ax, n_in, msg = blocked
        plan.fallbacks[name] = msg
        plan.gathers[name] = np.asarray(sorted(set(range(n_in)) - remove))
        plan.layer_slices.setdefault(name, []).append(
            ("kernel", in_ax, plan.gathers[name]))
        active = [s for s in active if s[0] != name]

    for opn, slices in prop.layer_slices.items():
        plan.layer_slices.setdefault(opn, []).extend(slices)
    plan.rebuilt_ops.update(prop.rebuilt)
    for opn, (axis, removeset, n) in prop.affine.items():
        plan.affine_ops[opn] = (
            axis, np.asarray(sorted(set(range(n)) - removeset)))
    return plan


# ---------------------------------------------------------------------------
# replacements
# ---------------------------------------------------------------------------
def _dedupe_slices(slices):
    """Repeated (role, axis) slices combined by intersecting the keeps."""
    merged: Dict[Tuple[str, int], np.ndarray] = {}
    for role, axis, keep in slices:
        k = (role, axis)
        merged[k] = np.intersect1d(merged[k], keep) if k in merged else keep
    return [(role, axis, keep) for (role, axis), keep in merged.items()]


def _replay_fn(graph: ConnectedGraph, op: Op) -> Callable:
    """Re-execute the op's own nodes on new input values (their aten ops
    take any channel count); every other operand is read from the graph's
    values."""
    resolve = graph.resolve
    own = set(op.nodes)
    slot = {p.node: i for i, p in enumerate(op.inputs)}

    def fn(*xs, read):
        env = {}

        def arg(a):
            if a in env:
                return env[a]
            r = resolve(a)
            if a not in own and r in slot:
                return xs[slot[r]]
            return read(a)

        for n in op.nodes:
            a, kw = fx.node.map_arg((n.args, n.kwargs), arg)
            env[n] = n.target(*a, **kw)
        return env[op.nodes[-1]]

    fn._nary = True
    return fn


def _affine_fn(graph: ConnectedGraph, params, op: Op, keep: np.ndarray,
               axis: int) -> Callable:
    """A batchnorm / scale op's y = a * x + b (``bn_fold.bn_affine_params``
    probes a and b), sliced to ``keep``."""
    a, b = bn_affine_params(graph, params, op, axis)
    idx = torch.as_tensor(keep, device=a.device)
    shape = [1] * len(op.output.shape)
    shape[axis] = -1
    a_k = a.index_select(0, idx).reshape(shape)
    b_k = b.index_select(0, idx).reshape(shape)

    def fn(x):
        return x * a_k + b_k

    return fn


def layer_apply(op: Op, x: torch.Tensor, w: torch.Tensor, bias,
                groups: Optional[int] = None) -> torch.Tensor:
    """One conv / linear op with explicit weights, by its traced
    attributes (stride, padding, groups; a transposed dense kernel)."""
    if op.type in ("conv", "depthwise_conv"):
        node = op.nodes[0]
        out = conv2d(x, w, op.attrs["window_strides"], op.attrs["padding"],
                     _groups(op) if groups is None else groups,
                     tuple(node.args[5]))
        return out if bias is None else out + bias.reshape(1, -1, 1, 1)
    if op.type == "linear":
        out = x @ (w.t() if op.attrs.get("kernel_transposed") else w)
        return out if bias is None else out + bias
    raise ValueError(op.type)


def _take(t: torch.Tensor, keep, axis: int) -> torch.Tensor:
    return t.index_select(axis, torch.as_tensor(np.asarray(keep),
                                                device=t.device))


def _layer_fn(graph: ConnectedGraph, params, op: Op, slices,
              gather: Optional[np.ndarray]) -> Callable:
    w = params[op.param_products["kernel"].param_path]
    bias = params[op.param_products["bias"].param_path] \
        if "bias" in op.param_products else None
    groups = _groups(op)
    for role, axis, keep in slices:
        if role == "kernel":
            w = _take(w, keep, axis)
            if op.type == "depthwise_conv" and axis == 0:
                groups = len(keep)
        elif role == "bias" and bias is not None:
            bias = _take(bias, keep, axis)
    in_ax = _feature_axis(op, op.inputs[0]) if gather is not None else None

    def fn(x):
        if gather is not None:
            x = _take(x, gather, in_ax)
        return layer_apply(op, x, w, bias, groups)

    return fn


def winnow_model(graph: ConnectedGraph, params,
                 masks: Dict[str, Sequence[int]], out_tree=None):
    """Remove the given input channels from each named op (``masks``: op
    name -> input-channel indices to REMOVE; ``params`` by name). Returns
    (the reduced model ``reduced(params, *args)``, the replacements); the
    plan is ``reduced.plan`` (fallbacks included)."""
    plan = plan_winnow(graph, masks)
    replacements: Dict[str, Callable] = {}
    for opn, slices in plan.layer_slices.items():
        replacements[opn] = _layer_fn(graph, params, graph.get_op(opn),
                                      _dedupe_slices(slices),
                                      plan.gathers.get(opn))
    for opn, kind in plan.rebuilt_ops.items():
        if opn in replacements:
            continue
        op = graph.get_op(opn)
        if kind == "affine":
            axis, keep = plan.affine_ops[opn]
            replacements[opn] = _affine_fn(graph, params, op, keep, axis)
        else:
            replacements[opn] = _replay_fn(graph, op)

    def reduced_model(params, *args):
        return evaluate_with_replacements(graph, params, args, replacements,
                                          out_tree)

    reduced_model.plan = plan
    return reduced_model, replacements


def propagate_channel_mask(graph: ConnectedGraph, op: Op,
                           keep: np.ndarray) -> Optional[Op]:
    """Walk upstream from ``op``'s input through direct ops to the layer
    whose output channels must shrink; that layer, or None (the simple
    single-chain callers)."""
    prev = op.inputs[0].producer
    hops = 0
    while prev is not None and prev.type in DIRECT and hops < 8:
        if len(prev.inputs) != 1:
            return None
        prev = prev.inputs[0].producer
        hops += 1
    if prev is not None and prev.type in ("conv", "depthwise_conv",
                                          "linear"):
        return prev
    return None
