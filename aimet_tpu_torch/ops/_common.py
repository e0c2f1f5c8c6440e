"""Numerics shared by the ops' plain versions."""
from __future__ import annotations

import torch


def div_ieee(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as an IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can differ in the last bit; dividing by a 0-dim tensor on the
    same device does not, and matches the kernels and the JAX package."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 values rounded once to f32, as a fused
    multiply-add (``fmaf``) rounds it, on every device. The product is
    exact in f64; the f64 sum's rounding error (TwoSum) settles the rare
    ties at which rounding twice (to f64, then to f32) would be wrong."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.to(torch.float32)
    d = s - r.to(torch.float64)
    toward = torch.where(d > 0, torch.inf, -torch.inf).to(torch.float32)
    nb = torch.nextafter(r, toward)
    beyond_tie = (d != 0) & (2 * d == nb.to(torch.float64) - r.to(
        torch.float64)) & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(beyond_tie, nb, r)
