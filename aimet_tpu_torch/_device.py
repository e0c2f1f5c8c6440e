"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without
CUDA and without an explicit ``device="cpu"`` they raise: the port never
carries on quietly on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for but missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on a CUDA device, False when all
    lie on the CPU; raises on a mix."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


@contextlib.contextmanager
def no_tf32():
    """Run f32 convolutions in f32. PyTorch lets cuDNN take TF32 for them by
    default (``torch.backends.cudnn.allow_tf32``, about three decimal
    digits); the JAX package's f32 models convolve in f32, so the port's
    conv paths (the CNN models' forward, the graph interpreter, the
    weight-only int conv) turn it off while they run. Float matmuls stay
    f32 by PyTorch's own default."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
