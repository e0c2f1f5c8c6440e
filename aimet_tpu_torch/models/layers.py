"""The flax layers of the JAX package's CNNs as PyTorch modules, NCHW.

``Conv`` keeps flax.linen.Conv's padding rules ("SAME" pads as
``lax.conv_general_dilated`` does: the odd pixel goes low-side-short, so a
stride-2 3x3 conv on an even size pads (0, 1)) with an OIHW ``kernel``;
``BatchNorm`` keeps flax's running-average arithmetic, ``(x - mean) *
(rsqrt(var + eps) * scale) + bias`` with eps 1e-5, holding ``mean`` and
``var`` as (non-trainable) parameters so they trace as the batch_stats
leaves do in the JAX package; ``Dense`` keeps the (in, out) ``kernel``.
The parameter names follow the flax tree, so ``convert.cnn_params_from_flax``
maps one onto the other.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .._device import no_tf32
from ..ops.int_conv import Padding, conv_pads


class Conv(nn.Module):
    """flax.linen.Conv on NCHW input: kernel (out, in/groups, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_size: Tuple[int, int], strides=(1, 1),
                 padding: Padding = "SAME", groups: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.kernel = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def pads(self, h: int, w: int):
        """((top, bottom), (left, right)) padding of an (h, w) input."""
        return conv_pads((h, w), tuple(self.kernel.shape[2:]), self.strides,
                         self.padding, (1, 1))

    def forward(self, x):
        (h0, h1), (w0, w1) = self.pads(*x.shape[2:])
        if (h0, w0) != (h1, w1):
            x = F.pad(x, (w0, w1, h0, h1))
            h0 = w0 = 0
        with no_tf32():
            return F.conv2d(x, self.kernel, self.bias, self.strides,
                            (h0, w0), 1, self.groups)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(use_running_average=True) over channel axis 1."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.mean = nn.Parameter(torch.zeros(ch), requires_grad=False)
        self.var = nn.Parameter(torch.ones(ch), requires_grad=False)

    def forward(self, x):
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        y = (x - self.mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


class Dense(nn.Module):
    """flax.linen.Dense: x @ kernel (in, out) + bias."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel + self.bias


def relu6(x):
    """jnp.minimum(nn.relu(x), 6.0)."""
    return torch.clamp_max(torch.relu(x), 6.0)
