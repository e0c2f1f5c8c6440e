"""Carry weights across from the JAX package, through numpy.

``params_from_flax`` maps a flax ``variables["params"]`` tree (numpy
arrays) onto the float ``Transformer``'s state dict; the module names are
the flax names, so this is a flatten. ``quantized_from_jax`` takes a JAX
quantized weight tree (numpy) to the port's tree: packed bytes and scales
pass through unchanged, since both packages share the storage contract.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._device import DeviceLike, resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: reinterpret
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_flax(params_np, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> flat state dict with ``.``-joined
    flax names, e.g. ``layer_0.attn.wq.kernel``."""
    out = {}
    for name, v in params_np.items():
        key = prefix + name
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(params_from_flax(v, key + "."))
        else:
            out[key] = _tensor(v)
    return out


def quantized_from_jax(qw_np, device: DeviceLike = None) -> Dict[str, Any]:
    """JAX quantized weight tree (numpy leaves) -> the port's tree on
    ``device`` (default ``cuda``); bytes unchanged."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        return _tensor(t).to(dev)

    return conv(qw_np)
