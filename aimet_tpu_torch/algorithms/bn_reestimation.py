"""BN re-estimation — counterpart of
``aimet_tpu/algorithms/bn_reestimation.py`` (reference:
aimet_torch/bn_reestimation.py:132).

After QAT has moved the weights, the stored BN running mean / variance no
longer match the activations the quantized network produces; they are
re-estimated from data: each batchnorm op's *input* is captured through
the (quantized) forward and its per-channel mean and variance replace the
op's ``mean`` / ``var`` parameters.

The JAX package is feature-last and reduces over every axis but the last;
the port's activations are NCHW, so each op's channel axis is read from
the graph: the axis along which its ``mean`` parameter is broadcast
against the op's input.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..graph.connected_graph import PASSTHROUGH, ConnectedGraph, Op, _packet
from ..ops._common import div_ieee
from ..quantsim.qsim import QuantizationSimModel
from ..utils.pytree import set_leaves
from .bn_fold import _bn_role_paths


def bn_channel_axis(graph: ConnectedGraph, op: Op, path: str) -> int:
    """The axis of the op's input along which parameter ``path`` (a (C,)
    vector) is broadcast: the view of it that the op's own nodes read,
    right-aligned against the input's shape."""
    in_ndim = len(op.inputs[0].shape)
    inside = set(op.nodes)
    frontier = [graph.param_nodes[path]]
    seen = set()
    while frontier:
        node = frontier.pop()
        if node in seen:
            continue
        seen.add(node)
        for user in node.users:
            if user in inside:
                shape = tuple(node.meta["val"].shape)
                chan = [i for i, d in enumerate(shape) if d != 1]
                if len(chan) == 1:
                    return in_ndim - len(shape) + chan[0]
            elif user.op == "call_function" and (
                    _packet(user.target) in PASSTHROUGH
                    or graph._param_only.get(user, False)):
                frontier.append(user)
    raise ValueError(f"cannot find the channel axis of {op.name}'s {path}")


def reestimate_bn_stats(sim: QuantizationSimModel, params,
                        data_batches: Sequence, mode: str = "quantized"):
    """Params with each batchnorm's ``mean`` / ``var`` replaced by the
    per-channel statistics of its input over ``data_batches``, run through
    the sim's ``mode`` forward (``quantized`` or ``fp``); ``params`` None:
    the model's own. The caller's tensors are not written."""
    params = sim.params if params is None else params
    graph = sim.graph
    bn_ops = graph.ops_of_type("batchnorm")
    if not bn_ops:
        return params
    prods = [op.inputs[0].name for op in bn_ops]
    axes: Dict[str, int] = {}
    for op in bn_ops:
        roles = _bn_role_paths(op)
        if "mean" in roles and "var" in roles:
            axes[op.name] = bn_channel_axis(graph, op, roles["mean"])

    sums: Dict[str, torch.Tensor] = {}
    sqs: Dict[str, torch.Tensor] = {}
    n_elems: Dict[str, int] = {}
    count = 0
    for batch in data_batches:
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        caps = sim.collect_activations(params, args, prods, mode=mode)
        for op in bn_ops:
            if op.name not in axes:
                continue
            x = caps[op.inputs[0].name]
            dims = tuple(d for d in range(x.dim()) if d != axes[op.name])
            s, q = x.sum(dim=dims), (x * x).sum(dim=dims)
            sums[op.name] = s if op.name not in sums else sums[op.name] + s
            sqs[op.name] = q if op.name not in sqs else sqs[op.name] + q
            n_elems[op.name] = n_elems.get(op.name, 0) \
                + x.numel() // x.shape[axes[op.name]]
        count += 1
    if count == 0:
        raise RuntimeError("no data batches")

    updates = {}
    for op in bn_ops:
        if op.name not in axes:
            continue
        roles = _bn_role_paths(op)
        n = n_elems[op.name]
        mean = div_ieee(sums[op.name], float(n))
        var = div_ieee(sqs[op.name], float(n)) - mean ** 2
        updates[roles["mean"]] = mean.to(torch.float32)
        updates[roles["var"]] = torch.clamp(var, min=1e-12).to(torch.float32)
    return set_leaves(params, updates)
