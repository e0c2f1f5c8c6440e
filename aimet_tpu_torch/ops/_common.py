"""Numerics shared by the ops' plain versions."""
from __future__ import annotations

import torch


def div_ieee(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as an IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can differ in the last bit; dividing by a 0-dim tensor on the
    same device does not, and matches the kernels and the JAX package.
    The divisor is filled on the device: no copy from host memory, which
    would wait for the stream and cannot be captured in a CUDA graph."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def update_rows(dst: torch.Tensor, src: torch.Tensor, index) -> None:
    """``dst[:, i:i + T] = src`` in place, as ``lax.dynamic_update_slice``
    along dim 1 places it: a negative index counts from the end, then the
    index is clamped so the T rows fit. A tensor index is clamped on its
    device, never read back to the host."""
    S, T = dst.shape[1], src.shape[1]
    if isinstance(index, torch.Tensor):
        i = index.to(dst.device, torch.int64).reshape(())
        rows = (torch.where(i < 0, i + S, i).clamp(0, S - T)
                + torch.arange(T, device=dst.device))
        dst.index_copy_(1, rows, src)
    else:
        i = int(index)
        i = min(max(i + S if i < 0 else i, 0), S - T)
        dst[:, i:i + T] = src


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


def linspace_f32(start: float, stop: float, num: int,
                 device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 with the JAX package's
    bits on the CPU: XLA compiles it as fma(i, stop * c, start * (1 - i *
    c)) with c = f32(1 / (num - 1)), the last value ``stop`` exactly
    (``torch.linspace`` rounds some values differently)."""
    f32 = torch.float32
    if num < 2:
        return torch.full((num,), start, dtype=f32, device=device)
    div = num - 1
    c = torch.full((), 1.0 / div, dtype=f32, device=device)
    i = torch.arange(div, dtype=f32, device=device)
    s = torch.full((div,), start, dtype=f32, device=device)
    e = torch.full((), stop, dtype=f32, device=device)
    out = fma_f32(i, (e * c).expand(div), s * (1 - i * c))
    return torch.cat([out, e.reshape(1)])
