"""Bias correction, empirical and analytical (BN-based) — counterpart of
``aimet_tpu/algorithms/bias_correction.py``.

Empirical (aimet_torch/bias_correction.py:153-197): per layer, the mean
per-channel error of the layer's output between the quantized-so-far
model and the float model over the calibration batches is subtracted
from its bias; layer n+1 sees layer n's corrected bias.

Analytical (DlEqualization/src/BiasCorrection.cpp:48-140,
BnBasedBiasCorrection): the expected error is ``epsilon @ E[x]`` with
epsilon = sum_spatial(W_q - W) and E[x] the closed-form mean of the
preceding BN's output N(beta, gamma) through the activation (identity,
relu or relu6: truncated-normal means).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..graph.connected_graph import ConnectedGraph, Op
from ..quantization.grads import quantize_dequantize
from ..quantsim.qsim import QuantizationSimModel, _broadcast_encoding
from ..utils.pytree import set_leaves
from .adaround import _args
from .bn_fold import _bn_role_paths, _conv_axes


def _correctable_layers(graph: ConnectedGraph) -> List[Op]:
    return [op for op in graph.ops
            if op.type in ("conv", "depthwise_conv", "linear")
            and "bias" in op.param_products]


def _channel_mean(x, channel_axis):
    return x.mean(dim=tuple(d for d in range(x.dim()) if d != channel_axis))


def _phi(x):
    return 1.0 / math.sqrt(2 * math.pi) * torch.exp(-0.5 * x * x)


def _normal_cdf(x):
    return torch.special.erfc(-x / math.sqrt(2.0)) / 2.0


def _expectation_through_activation(gamma, beta, activation: str):
    """E[f(X)], X ~ N(beta, gamma) (calcExpectationPerChannel,
    BiasCorrection.cpp:58-80)."""
    if activation == "none":
        return beta
    if activation == "relu6":
        a, b = 0.0, 6.0
        z_ab = _normal_cdf((b - beta) / gamma) - _normal_cdf((a - beta)
                                                            / gamma)
        z = _phi((a - beta) / gamma) - _phi((b - beta) / gamma)
        return (gamma * z + beta * z_ab
                + a * _normal_cdf((a - beta) / gamma)
                + b * (1 - _normal_cdf((b - beta) / gamma)))
    return beta * (1 - _normal_cdf(-beta / gamma)) + gamma * _phi(-beta
                                                                 / gamma)


def _upstream_bn_and_activation(op: Op):
    """Walk the layer's input back through relu / clip to a batchnorm op:
    (bn op or None, activation)."""
    act, cur = "none", op.inputs[0].producer
    for _ in range(4):
        if cur is None:
            break
        if cur.type == "clip":
            act = "relu6"
        elif cur.type == "relu":
            if act != "relu6":
                act = "relu"
        elif cur.type == "batchnorm":
            return cur, act
        else:
            return None, act
        cur = cur.inputs[0].producer
    return None, act


def correct_bias_analytical(sim: QuantizationSimModel, params=None):
    """Data-free bias correction of the layers preceded by a BN (and relu
    or relu6); returns corrected params (call_analytical_py_correct_bias,
    aimet_torch/bias_correction.py:214-258). ``params`` None: the sim's
    model's own."""
    params = sim.params if params is None else params
    graph = sim.graph
    sim.compute_param_encodings(params)
    updates: Dict[str, torch.Tensor] = {}
    for op in _correctable_layers(graph):
        bn, act = _upstream_bn_and_activation(op)
        if bn is None:
            continue
        roles = _bn_role_paths(bn)
        if "scale" not in roles or "bias" not in roles:
            continue
        kpath = op.param_products["kernel"].param_path
        if kpath not in sim.encodings:
            continue
        ex = _expectation_through_activation(params[roles["scale"]].abs(),
                                             params[roles["bias"]], act)
        spec, enc = sim.quantizers[kpath], sim.encodings[kpath]
        w = params[kpath]
        w_q = quantize_dequantize(
            w, _broadcast_encoding(enc.min, w.dim(), spec.channel_axis),
            _broadcast_encoding(enc.max, w.dim(), spec.channel_axis),
            bitwidth=spec.bitwidth, symmetric=spec.symmetric)
        out_ax, in_ax, _ = _conv_axes(op)
        eps = w_q - w
        spatial = tuple(d for d in range(w.dim()) if d not in (out_ax, in_ax))
        eps2 = eps.sum(dim=spatial) if spatial else eps
        if op.type == "depthwise_conv" or w.shape[in_ax] == 1:
            error = eps2.squeeze() * ex
        elif out_ax < in_ax:
            error = eps2 @ ex
        else:
            error = ex @ eps2
        bias_path = op.param_products["bias"].param_path
        updates[bias_path] = params[bias_path] - error
    return set_leaves(params, updates)


def correct_bias(sim: QuantizationSimModel, params, data_batches: List,
                 num_batches: Optional[int] = None):
    """Returns bias-corrected params. ``sim`` must hold its encodings (its
    quantized forward is the quantized model); ``data_batches`` are model
    inputs, replayed once per layer. ``params`` None: the model's own."""
    params = sim.params if params is None else params
    data_batches = list(data_batches)
    if num_batches is not None:
        data_batches = data_batches[:num_batches]
    n = len(data_batches)
    layers = _correctable_layers(sim.graph)

    # the float model's output means, one pass a batch
    names = [op.output.name for op in layers]
    fp_means: Dict[str, torch.Tensor] = {}
    for batch in data_batches:
        caps = sim.collect_activations(params, _args(batch), names, mode="fp")
        for op in layers:
            m = _channel_mean(caps[op.output.name], _conv_axes(op)[2]) / n
            fp_means[op.name] = fp_means[op.name] + m \
                if op.name in fp_means else m

    corrected = params
    for op in layers:
        feat_ax = _conv_axes(op)[2]
        q_mean = 0.0
        for batch in data_batches:
            caps = sim.collect_activations(corrected, _args(batch),
                                           [op.output.name], mode="quantized")
            q_mean = q_mean + _channel_mean(caps[op.output.name], feat_ax) / n
        bias_path = op.param_products["bias"].param_path
        corrected = set_leaves(corrected, {
            bias_path: corrected[bias_path] - (q_mean - fp_means[op.name])})
    return corrected
