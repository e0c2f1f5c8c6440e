"""GPTQ and GPTVQ — Hessian-compensated post-training weight quantization;
counterpart of ``aimet_tpu/algorithms/gptq.py`` (reference:
aimet_torch/gptvq/gptvq_weight.py:68, gptvq_optimizer.py:61-300).

GPTQ quantizes a layer's weight one input column at a time onto its
(frozen) encoding grid and spreads each column's error over the columns
not yet quantized through the inverse Hessian of the layer's inputs,
H = sum X^T X over calibration batches (the quantized forward's inputs).
GPTVQ does the same with per-block k-means codebooks of ``vector_dim``
columns.

Linear layers take their input rows as they are; conv layers take
im2col patches of their NCHW input, features in (in_ch, kh, kw) order,
against the OIHW weight viewed as (out, in_ch * kh * kw)
(gptvq_optimizer.py:207 ``_convert_weight_to_2d_tensor``).

As in the JAX package the inverse is an explicit ``inv`` (no Cholesky
solve: it rounds differently), the column loop runs column by column in
f32, and GPTVQ's k-means starts from the vectors in norm order (a stable
sort), so it draws nothing at random.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch
from torch.nn import functional as F

from ..graph.connected_graph import PASSTHROUGH, _packet
from ..ops._common import linspace_f32
from ..quantization.grads import quantize_dequantize
from ..quantsim.qsim import QuantizationSimModel
from ..utils.pytree import set_leaves

DAMPENING = 0.01  # DAMPENING_PERCENTAGE (gptvq_optimizer.py)


@dataclasses.dataclass
class GPTVQParameters:
    """gptvq/defs.py equivalent."""
    vector_dim: int = 2
    index_bw: int = 6              # 2^6 = 64 centroids
    cols_per_block: int = 128
    num_kmeans_iterations: int = 10


def _conv_node(op):
    return next(n for n in op.nodes
                if _packet(n.target) is torch.ops.aten.convolution)


def _as_read(graph, op, arg, x: torch.Tensor) -> torch.Tensor:
    """The op's input product x as node argument ``arg`` reads it: the
    pass-through ops between them (views, transposes, pads) replayed."""
    chain, v, target = [], arg, op.inputs[0].node
    while v is not target and graph.resolve(v) is target \
            and _packet(v.target) in PASSTHROUGH:
        chain.append(v)
        v = v.args[0]
    for n in reversed(chain):
        x = n.target(x, *n.args[1:], **n.kwargs)
    return x


def _layer_input_2d(graph, op, x: torch.Tensor) -> torch.Tensor:
    """The layer's input as 2-D rows x in-features, f32: a linear's rows
    as its matmul reads them, a conv's im2col patches (features (in_ch,
    kh, kw)) of its input as the conv node reads it."""
    if op.type == "linear":
        x = _as_read(graph, op, op.attrs["x_node"], x)
        return x.reshape(-1, x.shape[-1]).to(torch.float32)
    node = _conv_node(op)
    x = _as_read(graph, op, node.args[0], x)
    kh, kw = op.param_products["kernel"].shape[2:]
    stride, padding, dilation = node.args[3:6]
    patches = F.unfold(x.to(torch.float32), (kh, kw), dilation=dilation,
                       padding=padding, stride=stride)     # (N, I*kh*kw, L)
    return patches.transpose(1, 2).reshape(-1, patches.shape[1])


def _weight_2d(op, w: torch.Tensor) -> torch.Tensor:
    """(output rows, input columns) f32 view of the layer's weight."""
    if op.type == "linear":
        w2 = w if op.attrs.get("kernel_transposed") else w.t()
    else:                                      # OIHW -> (O, I*kh*kw)
        w2 = w.reshape(w.shape[0], -1)
    return w2.to(torch.float32)


def _weight_from_2d(op, W2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if op.type == "linear":
        out = W2 if op.attrs.get("kernel_transposed") else W2.t()
    else:
        out = W2.reshape(w.shape)
    return out.to(w.dtype).contiguous()


def _collect_hessian(sim: QuantizationSimModel, params, op, data_batches):
    """H = sum X^T X over the calibration batches (the layer's inputs in
    the quantized forward, 2-D / im2col)."""
    in_name = op.inputs[0].name
    H = None
    for batch in data_batches:
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        x = sim.collect_activations(params, args, [in_name],
                                    mode="quantized")[in_name]
        x2 = _layer_input_2d(sim.graph, op, x)
        H = x2.t() @ x2 if H is None else H + x2.t() @ x2
    return H


def _prep_hessian_inverse(H: torch.Tensor):
    """Dead-column handling + dampening + inverse
    (gptvq_optimizer.py:85-105, compute_inverse)."""
    diag = torch.diagonal(H)
    dead = diag == 0
    H = H + torch.diag(dead.to(H.dtype))
    damp = DAMPENING * torch.diagonal(H).mean()
    H = H + damp * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return torch.linalg.inv(H), dead


def _gptq_block(W, Hinv_b, emin, emax, bitwidth, symmetric):
    """Quantize one column block with error compensation (W: (R, B), rows
    the output channels; emin / emax per row (R, 1) or (1, 1)). Returns
    (Q, E): the block's grid values and its scaled errors, which the
    caller spreads over the later blocks with ``E @ Hinv[block, rest]``."""
    W = W.clone()
    Q = torch.zeros_like(W)
    E = torch.zeros_like(W)
    for i in range(W.shape[1]):
        w_i = W[:, i:i + 1]
        q_i = quantize_dequantize(w_i, emin, emax, bitwidth=bitwidth,
                                  symmetric=symmetric)
        err = (w_i - q_i) / Hinv_b[i, i]
        W[:, i + 1:] -= err * Hinv_b[i, i + 1:][None, :]
        Q[:, i:i + 1] = q_i
        E[:, i:i + 1] = err
    return Q, E


@torch.no_grad()
def apply_gptq(sim: QuantizationSimModel, params, data_batches: Sequence,
               block_size: int = 128,
               timings: Optional[Dict[str, float]] = None):
    """Plain GPTQ over every linear and conv layer with a quantized
    kernel; returns new params (the caller's tensors are not written) and
    freezes the encodings used on ``sim``. ``params`` None: the model's
    own. ``timings``: filled with each layer's seconds (its Hessian
    included), by op name."""
    params = sim.params if params is None else params
    if not isinstance(data_batches, (list, tuple)):
        data_batches = list(data_batches)
    graph = sim.graph
    sim.compute_param_encodings(params)

    new_params = params
    for op in graph.ops:
        if op.type not in ("linear", "conv") \
                or "kernel" not in op.param_products:
            continue
        kpath = op.param_products["kernel"].param_path
        if kpath not in sim.quantizers:
            continue
        t0 = time.perf_counter()
        spec = sim.quantizers[kpath]
        sim.compute_param_encodings(new_params, only=[kpath])
        enc = sim.encodings[kpath]
        w = new_params[kpath]
        W = _weight_2d(op, w)
        K = W.shape[1]
        shape = (-1, 1) if spec.channel_axis is not None else (1, 1)
        emin, emax = enc.min.reshape(shape), enc.max.reshape(shape)

        H = _collect_hessian(sim, new_params, op, data_batches)
        Hinv, dead = _prep_hessian_inverse(H)
        W = torch.where(dead[None, :], torch.zeros_like(W), W)

        Q = torch.zeros_like(W)
        for start in range(0, K, block_size):
            end = min(start + block_size, K)
            q_b, E = _gptq_block(W[:, start:end], Hinv[start:end, start:end],
                                 emin, emax, spec.bitwidth, spec.symmetric)
            Q[:, start:end] = q_b
            if end < K:
                # the block's error onto the remaining columns
                W[:, end:] += -(E @ Hinv[start:end, end:])

        new_params = set_leaves(new_params,
                                {kpath: _weight_from_2d(op, Q, w)})
        sim.set_encoding(kpath, enc, freeze=True)
        if timings is not None:
            if Q.is_cuda:
                torch.cuda.synchronize(Q.device)
            timings[op.name] = time.perf_counter() - t0
    return new_params


# ---------------------------------------------------------------------------
# GPTVQ
# ---------------------------------------------------------------------------

def _kmeans_assign(vectors, weights, cent):
    d2 = (weights[:, None, :]
          * (vectors[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    return d2.argmin(dim=1)


def _weighted_kmeans(vectors, weights, k, iters):
    """vectors (n, d), weights (n, d) importance -> (centroids (k, d),
    assignments (n,)). Deterministic: the initial centroids are the
    vectors at k evenly spaced places of their norm order."""
    n = vectors.shape[0]
    order = torch.argsort((vectors * vectors).sum(dim=1), stable=True)
    idx = order[linspace_f32(0.0, float(n - 1), k,
                             device=vectors.device).to(torch.int64)]
    cent = vectors[idx]
    for _ in range(iters):
        a = _kmeans_assign(vectors, weights, cent)
        onehot = F.one_hot(a, k).to(vectors.dtype)          # (n, k)
        wsum = onehot.t() @ (weights * vectors)              # (k, d)
        wtot = onehot.t() @ weights                          # (k, d)
        new = wsum / torch.clamp(wtot, min=1e-12)
        # keep empty clusters where they were
        empty = (onehot.sum(dim=0) == 0)[:, None]
        cent = torch.where(empty, cent, new)
    return cent, _kmeans_assign(vectors, weights, cent)


def _vq_assign(chunk, cent, inv_diag=None):
    """chunk (R, d) -> (nearest centroid values (R, d), their indices)."""
    w = inv_diag if inv_diag is not None else torch.ones_like(chunk)
    a = _kmeans_assign(chunk, w, cent)
    return cent[a], a


@torch.no_grad()
def apply_gptvq(sim: QuantizationSimModel, params, data_batches: Sequence,
                gptvq_params: Optional[GPTVQParameters] = None,
                op_names: Optional[Sequence[str]] = None):
    """GPTVQ weight update over the linear layers (gptvq_weight.py:68-120),
    or only those named in ``op_names``; returns new params (the caller's
    tensors are not written). ``params`` None: the model's own."""
    gp = gptvq_params or GPTVQParameters()
    params = sim.params if params is None else params
    if not isinstance(data_batches, (list, tuple)):
        data_batches = list(data_batches)
    vd = gp.vector_dim
    k = 2 ** gp.index_bw

    new_params = params
    for op in sim.graph.ops:
        if op.type != "linear" or "kernel" not in op.param_products:
            continue
        if op_names is not None and op.name not in op_names:
            continue
        kpath = op.param_products["kernel"].param_path
        if kpath not in sim.quantizers:
            continue
        w = new_params[kpath]
        W = _weight_2d(op, w)                       # (R, K)
        R, K = W.shape
        if K % vd != 0:
            continue

        H = _collect_hessian(sim, new_params, op, data_batches)
        Hinv, dead = _prep_hessian_inverse(H)
        W = torch.where(dead[None, :], torch.zeros_like(W), W)
        hdiag = torch.diagonal(Hinv)

        cols_per_block = min(gp.cols_per_block, K)
        Q = torch.zeros_like(W)
        for start in range(0, K, cols_per_block):
            end = min(start + cols_per_block, K)
            # the codebook from the (error-compensated) current block
            vecs = W[:, start:end].reshape(-1, vd)
            imp = (1.0 / torch.clamp(hdiag[start:end], min=1e-12)).repeat(
                R, 1).reshape(-1, vd)
            cent, _ = _weighted_kmeans(vecs, imp, min(k, vecs.shape[0]),
                                       gp.num_kmeans_iterations)
            # the column-chunk loop with compensation
            for i in range(start, end, vd):
                chunk = W[:, i:i + vd]
                diag = hdiag[i:i + vd][None, :]
                qc, _ = _vq_assign(chunk, cent,
                                   1.0 / diag * torch.ones_like(chunk))
                err = (chunk - qc) / diag
                Q[:, i:i + vd] = qc
                if i + vd < K:
                    W[:, i + vd:] += -(err @ Hinv[i:i + vd, i + vd:])

        new_params = set_leaves(new_params,
                                {kpath: _weight_from_2d(op, Q, w)})
    return new_params
