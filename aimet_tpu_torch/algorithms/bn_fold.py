"""Batch-norm folding, driven by the graph — counterpart of
``aimet_tpu/algorithms/bn_fold.py`` (reference: fold_all_batch_norms,
aimet_torch/batch_norm_fold.py:81; DlEqualization/src/BatchNormFold.cpp).

The BN op's per-channel affine map ``y = a*x + b`` is not written down
from a formula (or its eps): the op's own nodes and the weight
preprocessing they read are replayed (``graph.interpreter.OpReplay``) on a
zeros probe and a ones probe of the op's input shape, as the JAX package
replays the op's jaxpr closure.

Folding conv/linear -> BN: W' = a ⊙ W along the output channels,
b' = a*b + b_bn; the BN becomes the identity (γ' = γ/a, β' = 0, mean' =
0), or a pure shift (β' = b_bn) when the layer has no bias to take it.
The port's ``BatchNorm`` holds ``mean`` and ``var`` as parameters, so the
params dict keeps its keys.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..graph.connected_graph import ConnectedGraph, Op
from ..graph.interpreter import OpReplay
from ..utils.pytree import set_leaves


def bn_affine_params(graph: ConnectedGraph, params, bn_op: Op,
                     channel_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (a, b) such that the BN op computes y = a*x + b."""
    run = OpReplay(graph, bn_op)
    ref = params[next(iter(run.params.values()))]
    shape = bn_op.inputs[0].shape
    with torch.no_grad():
        b_full = run(torch.zeros(shape, dtype=torch.float32,
                                 device=ref.device), params)
        a_full = run(torch.ones(shape, dtype=torch.float32,
                                device=ref.device), params) - b_full
    idx = tuple(slice(None) if ax == channel_axis else 0
                for ax in range(len(shape)))
    return a_full[idx], b_full[idx]


def _conv_axes(op: Op) -> Tuple[int, int, int]:
    """(output-channel axis, input-channel axis) of the op's kernel, and
    the feature axis of its output: conv kernels are OIHW (output NCHW:
    1); a linear kernel is (in, out) as ``Dense`` holds it, or (out, in)
    when the graph transposes it on its way to the product (output: its
    last axis)."""
    if op.type in ("conv", "depthwise_conv"):
        return 0, 1, 1
    if op.type == "linear":
        feat = len(op.output.shape) - 1
        return (0, 1, feat) if op.attrs.get("kernel_transposed") \
            else (1, 0, feat)
    raise ValueError(f"not a foldable layer: {op.type}")


def _bn_role_paths(bn_op: Op) -> Dict[str, str]:
    """The BN's parameters by role, from their leaf names."""
    roles = {}
    for path in bn_op.attrs.get("param_roots", []):
        low = path.rsplit(".", 1)[-1].lower()
        if "mean" in low:
            roles["mean"] = path
        elif "var" in low:
            roles["var"] = path
        elif "scale" in low or "gamma" in low or "weight" in low:
            roles["scale"] = path
        elif "bias" in low or "beta" in low:
            roles["bias"] = path
    return roles


def find_foldable_pairs(graph: ConnectedGraph) -> List[Tuple[Op, Op]]:
    """(layer, bn) pairs where the BN alone consumes the layer's output."""
    pairs = []
    for bn in graph.ops_of_type("batchnorm"):
        prod = bn.inputs[0].producer
        if prod is None or prod.type not in ("conv", "depthwise_conv",
                                             "linear"):
            continue
        if len(prod.output.consumers) != 1:
            continue
        pairs.append((prod, bn))
    return pairs


def fold_all_batch_norms(graph: ConnectedGraph, params,
                         return_bn_info: bool = False):
    """Fold every conv/linear -> BN pair; returns new params (and, with
    ``return_bn_info``, per layer the BN's original (γ, β) and (a, b), which
    CLE's high-bias fold reads)."""
    updates: Dict[str, torch.Tensor] = {}
    bn_info: Dict[str, Dict] = {}
    for layer, bn in find_foldable_pairs(graph):
        out_ax, _, out_feat_ax = _conv_axes(layer)
        a, b = bn_affine_params(graph, params, bn, out_feat_ax)

        kernel_path = layer.param_products["kernel"].param_path
        w = params[kernel_path]
        shape = [1] * w.dim()
        shape[out_ax] = -1
        updates[kernel_path] = w * a.reshape(shape)

        roles = _bn_role_paths(bn)
        if "scale" not in roles or "bias" not in roles:
            raise NotImplementedError(
                f"BN fold requires scale+bias leaves on {bn.name} "
                f"(roots: {bn.attrs.get('param_roots')})")
        gamma, beta = params[roles["scale"]], params[roles["bias"]]
        bias_prod = layer.param_products.get("bias")
        if bias_prod is not None:
            updates[bias_prod.param_path] = a * params[bias_prod.param_path] \
                + b
            # BN -> identity: γ' = γ/a, β' = 0, mean' = 0
            updates[roles["bias"]] = torch.zeros_like(beta)
        else:
            # no layer bias: the BN keeps the shift (y = x + b)
            updates[roles["bias"]] = b
        updates[roles["scale"]] = gamma / a
        if "mean" in roles:
            updates[roles["mean"]] = torch.zeros_like(params[roles["mean"]])
        bn_info[layer.name] = {"bn_op": bn.name, "gamma": gamma,
                               "beta": beta, "a": a, "b": b}

    new_params = set_leaves(params, updates)
    if return_bn_info:
        return new_params, bn_info
    return new_params
