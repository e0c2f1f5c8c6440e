"""Spatial-SVD and weight-SVD layer factorization — counterpart of
``aimet_tpu/compression/svd.py``.

The reference's SVD compression (DlCompression/src/SvdAlgorithm.cpp,
aimet_common/svd_pruner.py:54-125): a conv (Noc, Nic, kh, kw) factorizes
as
  spatial: (r, Nic, kh, 1) then (Noc, r, 1, kw)   [vertical x horizontal]
  weight:  (r, Nic, kh, kw) then (Noc, r, 1, 1)   [channel bottleneck]
through ``torch.linalg.svd`` on the kernel's canonical (kh, kw, I, O)
matrices, the JAX package's, so the factored kernels agree with its up to
the SVD's signs; the factored layer is an op replacement evaluated in the
traced graph (``graph/interpreter.evaluate_with_replacements``). Kernels
are OIHW, dense kernels (in, out).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.nn import functional as F

from .._device import no_tf32
from ..graph.connected_graph import Op


def _canonical(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> (kh, kw, I, O)."""
    return w.permute(2, 3, 1, 0)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, I, O) -> OIHW."""
    return w.permute(3, 2, 0, 1).contiguous()


def _svd(m: torch.Tensor, rank: int):
    u, s, vt = torch.linalg.svd(m, full_matrices=False)
    r = min(rank, s.shape[0])
    sq = torch.sqrt(s[:r])
    return u[:, :r] * sq[None, :], vt[:r, :] * sq[:, None], r


def spatial_svd_factor(op: Op, w: torch.Tensor, rank: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kernel (O, I, kh, kw) -> w1 (r, I, kh, 1), w2 (O, r, 1, kw)."""
    wc = _canonical(w)
    kh, kw, I, O = wc.shape
    m = wc.permute(2, 0, 1, 3).reshape(I * kh, kw * O)   # [(I, kh), (kw, O)]
    u_r, v_r, r = _svd(m, rank)
    w1 = u_r.reshape(I, kh, r).permute(1, 0, 2).reshape(kh, 1, I, r)
    w2 = v_r.reshape(r, kw, O).permute(1, 0, 2).reshape(1, kw, r, O)
    return _oihw(w1), _oihw(w2)


def weight_svd_factor_linear(w: torch.Tensor, rank: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(I, O) -> (I, r), (r, O)."""
    u_r, v_r, _ = _svd(w, rank)
    return u_r, v_r


def weight_svd_factor_conv(op: Op, w: torch.Tensor, rank: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kernel (O, I, kh, kw) -> w1 (r, I, kh, kw), w2 (O, r, 1, 1)."""
    wc = _canonical(w)
    kh, kw, I, O = wc.shape
    u_r, v_r, r = _svd(wc.reshape(kh * kw * I, O), rank)
    return _oihw(u_r.reshape(kh, kw, I, r)), _oihw(v_r.reshape(1, 1, r, O))


def successive_svd_factor_conv(op: Op, w: torch.Tensor, rank_r: int,
                               rank_s: int):
    """TYPE_SUCCESSIVE (ISVD.hpp:69-71): kernel (O, I, kh, kw) -> w_in
    (s, I, 1, 1) . w_mid (r, s, kh, kw) . w_out (O, r, 1, 1): the weight
    SVD's first factor split again across the input channels."""
    w1, w_out = weight_svd_factor_conv(op, w, rank_r)
    w1c = _canonical(w1)                                  # (kh, kw, I, r)
    kh, kw, I, r = w1c.shape
    u_s, v_s, s = _svd(w1c.permute(2, 0, 1, 3).reshape(I, kh * kw * r),
                       rank_s)
    w_in = _oihw(u_s.reshape(1, 1, I, s))
    w_mid = _oihw(v_s.reshape(s, kh, kw, r).permute(1, 2, 0, 3))
    return w_in, w_mid, w_out


def conv2d(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
           padding=((0, 0), (0, 0)), groups: int = 1,
           dilation=(1, 1)) -> torch.Tensor:
    """An NCHW conv with explicit ((top, bottom), (left, right)) padding,
    in f32 where x is f32 (TF32 off)."""
    (h0, h1), (w0, w1) = padding
    if (h0, w0) != (h1, w1):
        x = F.pad(x, (w0, w1, h0, h1))
        h0 = w0 = 0
    with no_tf32():
        return F.conv2d(x, w, None, tuple(strides), (h0, w0),
                        tuple(dilation), groups)


def _add_bias(y, bias):
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def make_successive_svd_replacement(op: Op, w, bias, rank_r: int,
                                    rank_s: int) -> Callable:
    """Three convs: a 1x1 input projection, the spatial bottleneck conv
    (the layer's stride and padding), a 1x1 output projection."""
    w_in, w_mid, w_out = successive_svd_factor_conv(op, w, rank_r, rank_s)
    strides, pads = op.attrs["window_strides"], op.attrs["padding"]

    def apply_fn(x):
        y = conv2d(conv2d(x, w_in), w_mid, strides, pads)
        return _add_bias(conv2d(y, w_out), bias)

    return apply_fn


def make_spatial_svd_replacement(op: Op, w, bias, rank: int) -> Callable:
    """Two convs: (kh, 1) at the layer's vertical stride and padding, then
    (1, kw) at its horizontal ones."""
    w1, w2 = spatial_svd_factor(op, w, rank)
    sh, sw = (tuple(op.attrs["window_strides"]) + (1, 1))[:2]
    ph, pw = op.attrs["padding"]

    def apply_fn(x):
        y = conv2d(x, w1, (sh, 1), (ph, (0, 0)))
        return _add_bias(conv2d(y, w2, (1, sw), ((0, 0), pw)), bias)

    return apply_fn


def make_weight_svd_replacement(op: Op, w, bias, rank: int) -> Callable:
    if op.type == "linear":
        kt = op.attrs.get("kernel_transposed")
        w1, w2 = weight_svd_factor_linear(w.t() if kt else w, rank)

        def apply_fn(x):
            y = x @ w1 @ w2
            return y if bias is None else y + bias

        return apply_fn

    w1, w2 = weight_svd_factor_conv(op, w, rank)
    strides, pads = op.attrs["window_strides"], op.attrs["padding"]

    def apply_fn(x):
        return _add_bias(conv2d(conv2d(x, w1, strides, pads), w2), bias)

    return apply_fn
