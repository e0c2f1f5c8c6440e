"""Channel pruning with least-squares weight reconstruction — counterpart
of ``aimet_tpu/compression/channel_pruning.py``.

The reference's channel pruner (aimet_common/channel_pruner.py:43,
aimet_torch/channel_pruning/weight_reconstruction.py:58-130,
input_match_search.py): for a target layer, keep the input channels of
largest weight magnitude, winnow what produces the others, and refit the
layer's weights by linear least squares on sampled (input, output)
activation pairs.

The least squares are ``lstsq``: the SVD's minimum-norm solution with
singular values below eps * max(M, N) * s_max dropped, the rule of
``jnp.linalg.lstsq``. It takes rank-deficient patches (a dead ReLU
channel, zero padding) where ``torch.linalg.lstsq``'s only CUDA driver
(``gels``) needs full rank, and it runs the same on the CPU and the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..algorithms.bn_fold import _conv_axes
from ..graph.connected_graph import ConnectedGraph, Op
from ..ops.int_conv import _patches


def lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares of a @ x = b through the SVD (the rule
    of ``jnp.linalg.lstsq``: rcond = eps * max(M, N))."""
    m, n = a.shape
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(m, n)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv[:, None] * (u.T @ b))


def select_channels_to_keep(w: torch.Tensor, num_keep: int,
                            in_axis: int) -> np.ndarray:
    """The input channels of largest weight magnitude, in order
    (channel_pruner.py:43: the sum of |w| per input channel)."""
    axes = tuple(d for d in range(w.dim()) if d != in_axis)
    mag = w.detach().abs().sum(dim=axes).cpu().numpy()
    return np.sort(np.argsort(mag)[::-1][:num_keep])


def reconstruct_weights(x_samples, y_samples, op: Op, keep, w, bias):
    """Least-squares refit of the pruned layer's kernel so that the layer
    on ``x[:, keep]`` matches ``y`` (weight_reconstruction.py:58-130).

    ``x_samples``: the layer's input, (N, C, H, W) or (N, C);
    ``y_samples``: its original output, bias included (the bias is taken
    off: the replacement adds it back). The conv patches are (c, kh, kw)
    features in (N, OH, OW) rows; above 4,096 rows a fixed sample of 4,096
    (``np.random.RandomState(0)``, as the JAX package) is fitted. Returns
    the kernel in the layer's layout (OIHW; a dense kernel (k, O), or
    (O, k) where the graph transposes it)."""
    keep_t = torch.as_tensor(np.asarray(keep), device=x_samples.device)
    x_k = x_samples.index_select(1, keep_t)
    if op.type == "linear":
        if bias is not None:
            y_samples = y_samples - bias
        sol = lstsq(x_k, y_samples)
        return sol.t() if op.attrs.get("kernel_transposed") else sol
    if bias is not None:
        y_samples = y_samples - bias.reshape(1, -1, 1, 1)
    kh, kw = w.shape[2], w.shape[3]
    A, _ = _patches(x_k, (kh, kw), tuple(op.attrs["window_strides"]),
                    op.attrs["padding"])
    B = y_samples.permute(0, 2, 3, 1).reshape(-1, y_samples.shape[1])
    if A.shape[0] > 4096:
        # subsample rows for tractability (input_match_search.py:285)
        idx = np.random.RandomState(0).choice(A.shape[0], 4096,
                                              replace=False)
        idx = torch.as_tensor(idx, device=A.device)
        A, B = A.index_select(0, idx), B.index_select(0, idx)
    sol = lstsq(A, B)                                    # (k*kh*kw, O)
    return sol.reshape(len(keep), kh, kw, w.shape[0]).permute(3, 0, 1, 2) \
        .contiguous()


def make_multi_channel_pruned_replacements(
        graph: ConnectedGraph, params, ratio_map: Dict[str, float],
        act_samples=None):
    """Prune several layers' input channels in ONE winnow plan: seeds that
    share a channel space (several convs reading one residual trunk) are
    merged by the mask propagation (``winnow.plan_winnow``), so the
    replacements agree with each other.

    ``params``: by name. ``act_samples``: optional {op name: (x_samples,
    y_samples)} for the least-squares reconstruction. Returns
    (replacements, WinnowPlan)."""
    from .winnow import _feature_axis, _take, layer_apply, winnow_model

    def weights(op):
        w = params[op.param_products["kernel"].param_path]
        b = params[op.param_products["bias"].param_path] \
            if "bias" in op.param_products else None
        return w, b

    masks: Dict[str, list] = {}
    for name, ratio in ratio_map.items():
        op = graph.get_op(name)
        _, in_ax, _ = _conv_axes(op)
        w, _ = weights(op)
        n_in = w.shape[in_ax]
        keep = select_channels_to_keep(w, max(1, int(round(n_in * ratio))),
                                       in_ax)
        masks[name] = sorted(set(range(n_in)) - set(keep.tolist()))

    reduced, replacements = winnow_model(graph, params, masks)
    plan = reduced.plan

    for name in masks:
        if not act_samples or name not in act_samples:
            continue
        op = graph.get_op(name)
        out_ax, in_ax, _ = _conv_axes(op)
        w, bias = weights(op)
        # the seed's final keep may be narrower than asked for after the
        # spaces merged: read it back from the plan
        in_keeps = [k for role, ax, k in plan.layer_slices[name]
                    if role == "kernel" and ax == in_ax]
        keep = in_keeps[0]
        for k in in_keeps[1:]:
            keep = np.intersect1d(keep, k)
        out_keeps = [k for role, ax, k in plan.layer_slices[name]
                     if role == "kernel" and ax == out_ax]
        x_s, y_s = act_samples[name]
        if out_keeps:              # another seed's space prunes the output
            # every delta of the propagation sliced it: the intersection
            # (the JAX package takes the first slice alone, which leaves
            # the layer wider than its consumers once a space took
            # removals in several deltas)
            out_keep = out_keeps[0]
            for k in out_keeps[1:]:
                out_keep = np.intersect1d(out_keep, k)
            y_s = _take(y_s, out_keep, _feature_axis(op, op.output))
            if bias is not None:
                bias = _take(bias, out_keep, 0)
            w = _take(w, out_keep, out_ax)
        w_k = reconstruct_weights(x_s, y_s, op, keep, w, bias)
        gathered = name in plan.gathers
        in_fax = _feature_axis(op, op.inputs[0]) if gathered else None

        def op_fn(x, op=op, w_k=w_k, bias=bias, keep=keep,
                  gathered=gathered, in_fax=in_fax):
            if gathered:
                x = _take(x, keep, in_fax)
            return layer_apply(op, x, w_k, bias)

        replacements[name] = op_fn
    return replacements, plan


def make_channel_pruned_replacements(
        graph: ConnectedGraph, params, op: Op, comp_ratio: float,
        x_samples=None, y_samples=None) -> Dict[str, Callable]:
    """One layer: :func:`make_multi_channel_pruned_replacements`."""
    samples = None
    if x_samples is not None and y_samples is not None:
        samples = {op.name: (x_samples, y_samples)}
    return make_multi_channel_pruned_replacements(
        graph, params, {op.name: comp_ratio}, samples)[0]
