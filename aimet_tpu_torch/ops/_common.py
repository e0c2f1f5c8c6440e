"""Numerics shared by the ops' plain versions."""
from __future__ import annotations

import torch


def div_ieee(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as an IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can differ in the last bit; dividing by a 0-dim tensor on the
    same device does not, and matches the kernels and the JAX package."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)
