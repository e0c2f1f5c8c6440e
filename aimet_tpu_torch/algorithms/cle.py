"""Cross-Layer Equalization + High-Bias Fold (DFQ) — counterpart of
``aimet_tpu/algorithms/cle.py`` (reference: equalize_model,
aimet_torch/cross_layer_equalization.py:988: BN fold -> cross-layer
scaling -> high-bias fold; formulas of aimet_common/
cross_layer_equalization.py:620-760):

  pair scaling      S_i = max|W1_i| / sqrt(max|W1_i| * max|W2_i|)
  depthwise triple  S12 = r1 / cbrt(r1*r2*r3),  S23 = cbrt(r1*r2*r3) / r3
  high-bias fold    absorb = max(0, beta - 3|gamma|) (ReLU between layers),
                    b1 -= absorb, b2 += (sum_spatial W2) @ absorb

Reductions follow each layer's kernel axes (``bn_fold._conv_axes``: OIHW
convs, (in, out) or (out, in) linear kernels).

One departure from the JAX package: a layer without a bias whose BN was
folded keeps the BN's shift in the BN (y = x + b), and the shift must be
scaled with the layer's outputs. The JAX package scales only a bias
parameter of the layer itself, so on ResNet and MobileNetV2 (no conv
biases) its scaling moves the float outputs (MobileNetV2 at 32 x 32: 0.75
of their max); here the BN's ``bias`` and ``mean`` between the two layers
are divided by S too, and the float outputs stay put (through ReLU; ReLU6
is only approximately scale-invariant, as in the reference).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..graph.connected_graph import ConnectedGraph, Op
from ..utils.pytree import set_leaves
from .bn_fold import _bn_role_paths, _conv_axes, fold_all_batch_norms

_SCALABLE = ("conv", "depthwise_conv", "linear")
# Activations CLE scales through. ``clip`` (relu6) is only approximately
# scale-invariant; including it mirrors the reference's ReLU6 -> ReLU
# replacement before scaling.
_TRANSPARENT = ("relu", "clip")


def _path_to_next(op: Op) -> Tuple[Optional[Op], List[Op]]:
    """Follow single-consumer links through ReLU / folded BN to the next
    conv or linear. Returns (that layer or None, the ops passed)."""
    passed, cur = [], op
    for _ in range(4):
        cons = cur.output.consumers
        if len(cons) != 1:
            return None, passed
        nxt = cons[0]
        if nxt.type in _SCALABLE:
            return nxt, passed
        if nxt.type not in _TRANSPARENT + ("batchnorm",):
            # a folded BN is an identity or a shift: scaling passes it
            return None, passed
        passed.append(nxt)
        cur = nxt
    return None, passed


def _next_scalable(op: Op) -> Tuple[Optional[Op], bool]:
    """The next conv or linear after ``op`` and whether a ReLU-like op
    lies between."""
    nxt, passed = _path_to_next(op)
    return nxt, any(o.type in _TRANSPARENT for o in passed)


def _scale_bn_shift(pv: "_ParamView", layer: Op, s):
    """Divide the shift of each BN between ``layer`` and the next layer
    (its bias and running mean) by the layer's output scale S."""
    for bn in _path_to_next(layer)[1]:
        if bn.type != "batchnorm":
            continue
        roles = _bn_role_paths(bn)
        for role in ("bias", "mean"):
            if role in roles:
                pv.set(roles[role], pv.get(roles[role]) / s)


def find_cls_sets(graph: ConnectedGraph) -> List[Tuple[Op, ...]]:
    """Consecutive layers to scale: pairs (L1, L2) and depthwise triples
    (conv, depthwise_conv, conv) (GraphSearchUtils,
    cross_layer_equalization.py:87)."""
    sets, triple_interior = [], set()
    for op in graph.ops:
        if op.type not in _SCALABLE or op.name in triple_interior:
            continue
        nxt, _ = _next_scalable(op)
        if nxt is None:
            continue
        if op.type == "conv" and nxt.type == "depthwise_conv":
            nxt2, _ = _next_scalable(nxt)
            if nxt2 is not None and nxt2.type in ("conv", "linear"):
                sets.append((op, nxt, nxt2))
                triple_interior.add(nxt.name)
            # a conv -> depthwise pair cannot be scaled: the depthwise
            # kernel's input axis has size 1
            continue
        if nxt.type == "depthwise_conv":
            continue
        sets.append((op, nxt))
    return sets


def _weight_range(w, keep_axis):
    return w.abs().amax(dim=tuple(d for d in range(w.dim())
                                  if d != keep_axis))


def _along(v, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


class _ParamView:
    def __init__(self, params):
        self.params = params
        self.updates: Dict[str, torch.Tensor] = {}

    def get(self, path):
        return self.updates.get(path, self.params[path])

    def set(self, path, val):
        self.updates[path] = val


def _kernel(op: Op) -> str:
    return op.param_products["kernel"].param_path


def _scale_pair(pv: _ParamView, l1: Op, l2: Op):
    """Scale a (layer1, layer2) pair; returns S."""
    out1, _, _ = _conv_axes(l1)
    _, in2, _ = _conv_axes(l2)
    w1, w2 = pv.get(_kernel(l1)), pv.get(_kernel(l2))
    r1, r2 = _weight_range(w1, out1), _weight_range(w2, in2)
    s = torch.nan_to_num(r1 / torch.sqrt(r1 * r2), nan=1.0, posinf=1.0,
                         neginf=1.0)
    s = torch.where(s == 0.0, 1.0, s)
    pv.set(_kernel(l1), w1 / _along(s, w1.dim(), out1))
    pv.set(_kernel(l2), w2 * _along(s, w2.dim(), in2))
    b1 = l1.param_products.get("bias")
    if b1 is not None:
        pv.set(b1.param_path, pv.get(b1.param_path) / s)
    _scale_bn_shift(pv, l1, s)
    return s


def _scale_triple(pv: _ParamView, l1: Op, l2: Op, l3: Op):
    """Depthwise-separable triple (ScaleFactorCalculator.cpp:100-114)."""
    out1, _, _ = _conv_axes(l1)
    out2, _, _ = _conv_axes(l2)
    _, in3, _ = _conv_axes(l3)
    w1, w2, w3 = (pv.get(_kernel(op)) for op in (l1, l2, l3))
    r1, r2 = _weight_range(w1, out1), _weight_range(w2, out2)
    r3 = _weight_range(w3, in3)
    cbrt = torch.pow(r1 * r2 * r3, 1.0 / 3.0)
    s12, s23 = r1 / cbrt, cbrt / r3
    s12 = torch.where(torch.isfinite(s12) & (s12 != 0), s12, 1.0)
    s23 = torch.where(torch.isfinite(s23) & (s23 != 0), s23, 1.0)
    pv.set(_kernel(l1), w1 / _along(s12, w1.dim(), out1))
    pv.set(_kernel(l2), w2 * _along(s12 / s23, w2.dim(), out2))
    pv.set(_kernel(l3), w3 * _along(s23, w3.dim(), in3))
    b1 = l1.param_products.get("bias")
    if b1 is not None:
        pv.set(b1.param_path, pv.get(b1.param_path) / s12)
    b2 = l2.param_products.get("bias")
    if b2 is not None:
        pv.set(b2.param_path, pv.get(b2.param_path) / s23)
    _scale_bn_shift(pv, l1, s12)
    _scale_bn_shift(pv, l2, s23)
    return s12, s23


def scale_cls_sets(graph: ConnectedGraph, params):
    """CrossLayerScaling.scale_model: returns (params, scale_info), where
    scale_info[layer] holds the per-channel scale its outputs were divided
    by and the next layer of its set (the high-bias fold reads them)."""
    pv = _ParamView(params)
    scale_info: Dict[str, Dict] = {}
    for cls_set in find_cls_sets(graph):
        if len(cls_set) == 2:
            s = _scale_pair(pv, *cls_set)
            scale_info[cls_set[0].name] = {"scale": s,
                                           "next": cls_set[1].name}
        else:
            s12, s23 = _scale_triple(pv, *cls_set)
            scale_info[cls_set[0].name] = {"scale": s12,
                                           "next": cls_set[1].name}
            scale_info[cls_set[1].name] = {"scale": s23,
                                           "next": cls_set[2].name}
    return set_leaves(params, pv.updates), scale_info


def high_bias_fold(graph: ConnectedGraph, params, bn_info: Dict[str, Dict],
                   scale_info: Dict[str, Dict]):
    """HighBiasFold (aimet_common/cross_layer_equalization.py:686-760): for
    each scaled layer that had a folded BN, absorb = max(0, β - 3|γ|)
    (β, γ divided by the CLE scale; β alone without a ReLU between),
    b1 -= absorb, b2 += (sum_spatial W2) @ absorb."""
    pv = _ParamView(params)
    for l1_name, info in scale_info.items():
        if l1_name not in bn_info:
            continue
        l1, l2 = graph.get_op(l1_name), graph.get_op(info["next"])
        _, relu_between = _next_scalable(l1)
        s = info["scale"]
        beta = bn_info[l1_name]["beta"] / s
        gamma = bn_info[l1_name]["gamma"] / s
        absorb = torch.clamp(beta - 3.0 * gamma.abs(), min=0.0) \
            if relu_between else beta

        # the previous layer's bias: the conv's, else the BN's
        b1_prod = l1.param_products.get("bias")
        if b1_prod is not None:
            b1_path = b1_prod.param_path
        else:
            b1_path = _bn_role_paths(
                graph.get_op(bn_info[l1_name]["bn_op"])).get("bias")
            if b1_path is None:
                continue
        b2_prod = l2.param_products.get("bias")
        if b2_prod is None:
            continue              # nothing on l2 can take the absorbed part
        pv.set(b1_path, pv.get(b1_path) - absorb)
        out2, in2, _ = _conv_axes(l2)
        w2 = pv.get(_kernel(l2))
        spatial = tuple(d for d in range(w2.dim()) if d not in (out2, in2))
        wmat = w2.sum(dim=spatial) if spatial else w2
        if w2.shape[in2] == 1 or l2.type == "depthwise_conv":
            corr = wmat.squeeze() * absorb
        elif out2 < in2:
            corr = wmat @ absorb          # (out, in)
        else:
            corr = absorb @ wmat          # (in, out)
        pv.set(b2_prod.param_path, pv.get(b2_prod.param_path) + corr)
    return set_leaves(params, pv.updates)


def equalize_model(graph: ConnectedGraph, params):
    """The DFQ pipeline: BN fold -> cross-layer scaling -> high-bias fold
    (equalize_model, aimet_torch/cross_layer_equalization.py:988)."""
    params, bn_info = fold_all_batch_norms(graph, params, return_bn_info=True)
    params, scale_info = scale_cls_sets(graph, params)
    return high_bias_fold(graph, params, bn_info, scale_info)
