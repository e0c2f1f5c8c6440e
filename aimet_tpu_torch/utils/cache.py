"""Pickle-based stage cache for resumable pipelines — counterpart of
``aimet_tpu/utils/cache.py`` (reference: aimet_common/cache.py:58-220,
``Cache.mark``).

Expensive pipeline stages (calibration sweeps, equalization, eval
sessions) are memoized to disk under a mark name and a cache key, so an
interrupted AutoQuant run resumes instead of recomputing. Tensors are
pickled on the CPU as tensors (bf16 included: no trip through numpy) and
loaded back onto the cache's device.
"""
from __future__ import annotations

import functools
import os
import pickle
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .._device import DeviceLike, resolve_device


def _to_serializable(obj):
    return pytree.tree_map(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, obj)


def _to_device(obj, device: torch.device):
    return pytree.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, obj)


class Cache:
    """Usage:
        cache = Cache(device="cpu")
        with cache.enable(dir, key):
            @cache.mark("calibration")
            def calibrate(...): ...
    or decorate once and control it through ``enable()``. A hit loads the
    stored tensors onto ``device`` (default ``cuda``)."""

    def __init__(self, device: DeviceLike = None):
        self._device = device
        self._dir: Optional[str] = None
        self._key: Optional[str] = None

    class _EnableCtx:
        def __init__(self, cache, directory, key):
            self.cache, self.dir, self.key = cache, directory, key

        def __enter__(self):
            os.makedirs(self.dir, exist_ok=True)
            self.cache._dir = self.dir
            self.cache._key = self.key
            return self.cache

        def __exit__(self, *exc):
            self.cache._dir = None
            self.cache._key = None

    def enable(self, directory: str, key: str):
        return self._EnableCtx(self, directory, key)

    def mark(self, name: str):
        def decorator(fn: Callable):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if self._dir is None:
                    return fn(*args, **kwargs)
                path = os.path.join(self._dir, f"{self._key}.{name}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        return _to_device(pickle.load(f),
                                          resolve_device(self._device))
                out = fn(*args, **kwargs)
                with open(path, "wb") as f:
                    pickle.dump(_to_serializable(out), f)
                return out
            return wrapper
        return decorator
