"""ResNet family in PyTorch (NCHW) — counterpart of
``aimet_tpu/models/resnet.py``, with its module names (``Conv_0``,
``Bottleneck_3.BatchNorm_1``, ``Dense_0``, ...) so a flax ``{params,
batch_stats}`` tree loads through ``convert.cnn_params_from_flax``.
BatchNorm runs on its running statistics (eps 1e-5, as flax)."""
from __future__ import annotations

from functools import partial
from typing import Sequence, Type

import torch
from torch import nn
from torch.nn import functional as F

from .layers import BatchNorm, Conv, Dense


class _Block(nn.Module):
    """Shared constructor: ``convs`` as (in, out, kernel, strides) in flax
    order; a projection ``Conv_{n}`` / ``BatchNorm_{n}`` follows when the
    residual's shape changes."""

    def __init__(self, convs, in_ch: int, out_ch: int, strides):
        super().__init__()
        self.project = tuple(strides) != (1, 1) or in_ch != out_ch
        if self.project:
            convs = convs + [(in_ch, out_ch, (1, 1), strides)]
        for i, (ci, co, k, s) in enumerate(convs):
            setattr(self, f"Conv_{i}", Conv(ci, co, k, s))
            setattr(self, f"BatchNorm_{i}", BatchNorm(co))
        self.n_main = len(convs) - int(self.project)

    def forward(self, x):
        y = x
        for i in range(self.n_main):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(y))
            if i < self.n_main - 1:
                y = torch.relu(y)
        residual = x
        if self.project:
            n = self.n_main
            residual = getattr(self, f"BatchNorm_{n}")(
                getattr(self, f"Conv_{n}")(x))
        return torch.relu(y + residual)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides=(1, 1)):
        super().__init__([(in_ch, filters, (3, 3), strides),
                          (filters, filters, (3, 3), (1, 1))],
                         in_ch, filters, strides)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides=(1, 1)):
        super().__init__([(in_ch, filters, (1, 1), (1, 1)),
                          (filters, filters, (3, 3), strides),
                          (filters, filters * 4, (1, 1), (1, 1))],
                         in_ch, filters * 4, strides)


class ResNet(nn.Module):
    """x (B, 3, H, W) -> logits (B, num_classes)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: Type[_Block],
                 num_classes: int = 1000, num_filters: int = 64,
                 in_ch: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_ch, num_filters, (7, 7), (2, 2),
                           padding=[(3, 3), (3, 3)])
        self.BatchNorm_0 = BatchNorm(num_filters)
        self.blocks = []
        ch, n = num_filters, 0
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"{block_cls.__name__}_{n}"
                filters = num_filters * 2 ** i
                setattr(self, name, block_cls(ch, filters, strides))
                self.blocks.append(name)
                ch, n = filters * block_cls.expansion, n + 1
        self.Dense_0 = Dense(ch, num_classes)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
