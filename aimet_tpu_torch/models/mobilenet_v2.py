"""MobileNet-v2 in PyTorch (NCHW) — counterpart of
``aimet_tpu/models/mobilenet_v2.py`` with its module names; the only family
with depthwise convs."""
from __future__ import annotations

from torch import nn

from .layers import BatchNorm, Conv, Dense, relu6

# t (expand), c (channels), n (repeats), s (stride)
_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, strides, expand_ratio: int):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_residual = tuple(strides) == (1, 1) and in_ch == out_ch
        convs = []
        if expand_ratio != 1:
            convs.append(Conv(in_ch, hidden, (1, 1)))
        convs.append(Conv(hidden, hidden, (3, 3), strides, groups=hidden))
        convs.append(Conv(hidden, out_ch, (1, 1)))
        self.n = len(convs)
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
            setattr(self, f"BatchNorm_{i}", BatchNorm(conv.kernel.shape[0]))

    def forward(self, x):
        y = x
        for i in range(self.n):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(y))
            if i < self.n - 1:
                y = relu6(y)
        return x + y if self.use_residual else y


class MobileNetV2(nn.Module):
    """x (B, 3, H, W) -> logits (B, num_classes)."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 in_ch: int = 3):
        super().__init__()
        ch = _make_divisible(32 * width_mult)
        self.Conv_0 = Conv(in_ch, ch, (3, 3), (2, 2))
        self.BatchNorm_0 = BatchNorm(ch)
        self.blocks = []
        for t, c, n, s in _CFG:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                name = f"InvertedResidual_{len(self.blocks)}"
                setattr(self, name, InvertedResidual(
                    ch, out_ch, (s, s) if i == 0 else (1, 1), t))
                self.blocks.append(name)
                ch = out_ch
        last = _make_divisible(1280 * max(1.0, width_mult))
        self.Conv_1 = Conv(ch, last, (1, 1))
        self.BatchNorm_1 = BatchNorm(last)
        self.Dense_0 = Dense(last, num_classes)

    def forward(self, x):
        x = relu6(self.BatchNorm_0(self.Conv_0(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = relu6(self.BatchNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))
