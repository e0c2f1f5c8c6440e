"""Small hand-written test models — counterpart of
``aimet_tpu/models/cnn.py`` (the zoo equivalent of the reference's
torch/test/python/models/test_models.py fixtures), NCHW with the flax
module names (``Conv_0``, ``BatchNorm_0``, ``Dense_0``), so a flax
``{params, batch_stats}`` tree loads through
``convert.cnn_params_from_flax``.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .._device import resolve_device
from .layers import BatchNorm, Conv, Dense


class TinyMLP(nn.Module):
    """Dense-relu-Dense-relu-Dense."""

    def __init__(self, in_features: int = 16, features: int = 32,
                 num_classes: int = 10):
        super().__init__()
        self.Dense_0 = Dense(in_features, features)
        self.Dense_1 = Dense(features, features)
        self.Dense_2 = Dense(features, num_classes)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        return self.Dense_2(torch.relu(self.Dense_1(x)))


class TinyCNN(nn.Module):
    """conv-bn-relu-pool x2 -> dense, the reference's mnist model
    (test/python/models/mnist_torch_model.py), on ``hw`` x ``hw`` inputs;
    features flattened in NHWC order, as flax flattens them."""

    def __init__(self, in_ch: int = 1, num_classes: int = 10, hw: int = 8):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 8, (3, 3))
        self.BatchNorm_0 = BatchNorm(8)
        self.Conv_1 = Conv(8, 16, (3, 3), use_bias=True)
        self.Dense_0 = Dense(16 * (hw // 4) ** 2, num_classes)

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.BatchNorm_0(self.Conv_0(x))), 2, 2)
        x = F.avg_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        # a copy in NHWC order: the trace may see the conv's output in
        # channels-last strides (one input channel), the forward not
        x = x.permute(0, 2, 3, 1).clone(memory_format=torch.contiguous_format)
        return self.Dense_0(x.view(x.shape[0], -1))


class ConvBnRelu(nn.Module):
    """One conv-bn-relu block (fold / CLE unit tests)."""

    def __init__(self, in_ch: int = 3, features: int = 8,
                 use_bias: bool = True):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, (3, 3), use_bias=use_bias)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class ResidualBlockNet(nn.Module):
    """Two dense layers with a skip connection (Add supergroup tests)."""

    def __init__(self, in_features: int = 16, features: int = 16):
        super().__init__()
        self.Dense_0 = Dense(in_features, features)
        self.Dense_1 = Dense(features, features)
        self.Dense_2 = Dense(features, 4)

    def forward(self, x):
        h = self.Dense_0(x)
        out = torch.relu(h + torch.relu(self.Dense_1(h)))
        return self.Dense_2(out)


def init_model(model: nn.Module, input_shape, seed: int = 0, device=None):
    """``(model, example input)``: the model on ``device`` (default
    ``cuda``) with flax's initial values drawn from a generator seeded
    with ``seed`` (kernels LeCun normal, truncated at two standard
    deviations as flax's ``lecun_normal``; biases, BatchNorm shifts and
    means zero; BatchNorm scales and variances one), and an input of ones
    of ``input_shape`` (NCHW)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                # fan in: (in, out) dense kernels, (out, in/g, kh, kw) convs
                fan_in = p.shape[0] if p.dim() == 2 else \
                    math.prod(p.shape[1:])
                # flax's truncated normal keeps the variance 1 / fan_in
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                p.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                    generator=gen))
            elif leaf in ("scale", "var"):
                p.fill_(1.0)
            else:
                p.zero_()
    model = model.to(dev)
    return model, torch.ones(tuple(input_shape), device=dev)
