"""INT8 KV cache: per-(row, kv head) symmetric scales fixed at prefill,
decode appends quantized into that grid. Counterpart of
``aimet_tpu/ops/kv_cache.py``; the cache bytes are identical.

Unlike the functional JAX version, every write here updates the cache's
tensors IN PLACE and returns the same cache object. A cache's codes are
(B, S, KH, D) or the flat (B, S, KH*D) views of :func:`flatten_kv_caches`;
every function here takes either. No write reads the device on the host:
positions held in tensors stay on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ._common import div_ieee, update_rows


@dataclasses.dataclass
class QuantizedKVCache:
    k: torch.Tensor        # (B, S, KH, D) or flat (B, S, KH*D) int8
    v: torch.Tensor        # the same
    k_scale: torch.Tensor  # (B, KH) float32
    v_scale: torch.Tensor  # (B, KH) float32


def codes_4d(cache: QuantizedKVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's K and V codes as (B, S, KH, D) views of their storage
    (KH from the scales)."""
    B, S = cache.k.shape[:2]
    KH = cache.k_scale.shape[1]
    return cache.k.view(B, S, KH, -1), cache.v.view(B, S, KH, -1)


def as_4d(cache: QuantizedKVCache) -> QuantizedKVCache:
    """The same cache with (B, S, KH, D) views of its codes: a write
    through either is seen by the other."""
    return QuantizedKVCache(*codes_4d(cache), cache.k_scale, cache.v_scale)


def flatten_kv_caches(caches: List[QuantizedKVCache]
                      ) -> List[QuantizedKVCache]:
    """(B, S, KH, D) -> (B, S, KH*D) views of the same storage, as the JAX
    package's decode carry holds them (the scales are shared too)."""
    return [QuantizedKVCache(c.k.view(*c.k.shape[:2], -1),
                             c.v.view(*c.v.shape[:2], -1),
                             c.k_scale, c.v_scale) for c in caches]


def init_quantized_kv_cache(batch: int, max_len: int, n_kv_heads: int,
                            head_dim: int,
                            device: DeviceLike = None) -> QuantizedKVCache:
    """An empty cache: zero codes, unit scales. On ``cuda`` unless
    ``device`` says otherwise (``_device.resolve_device``: raises without
    CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    shape = (batch, max_len, n_kv_heads, head_dim)
    return QuantizedKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.ones((batch, n_kv_heads), dtype=torch.float32,
                           device=device),
        v_scale=torch.ones((batch, n_kv_heads), dtype=torch.float32,
                           device=device),
    )


def reciprocal(scale: torch.Tensor) -> torch.Tensor:
    """1 / scale in f32 by IEEE division (shared with the decode-attention
    wrapper, which hands these reciprocals to its kernel)."""
    s = scale.to(torch.float32)
    return torch.ones_like(s) / s


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, T, KH, D), scale (B, KH) -> int8 codes. Multiplies by the IEEE
    reciprocal of the scale (not a division), as the decode-attention
    kernel does, so both write identical cache rows."""
    r = reciprocal(scale)[:, None, :, None]
    return torch.round(x.to(torch.float32) * r).clamp(-127, 127).to(
        torch.int8)


def prefill_kv(cache: QuantizedKVCache, k: torch.Tensor, v: torch.Tensor,
               start: int = 0, lengths=None) -> QuantizedKVCache:
    """Write the prefill K/V at rows [start, start+T) and fix the per-head
    scales from their absmax, in place.

    ``lengths`` (B,) restricts the absmax to each row's first ``lengths``
    positions, so right-padded prompts in one admission wave do not set
    each other's scales."""
    ka, va = k.abs(), v.abs()
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=k.device)
        valid = (torch.arange(k.shape[1], device=k.device)[None, :]
                 < lengths[:, None])[:, :, None, None]
        ka = torch.where(valid, ka, torch.zeros((), dtype=ka.dtype,
                                                device=ka.device))
        va = torch.where(valid, va, torch.zeros((), dtype=va.dtype,
                                                device=va.device))
    k_scale = div_ieee(
        ka.amax(dim=(1, 3)).to(torch.float32).clamp_min(1e-8), 127.0)
    v_scale = div_ieee(
        va.amax(dim=(1, 3)).to(torch.float32).clamp_min(1e-8), 127.0)
    T = k.shape[1]
    ck, cv = codes_4d(cache)
    ck[:, start:start + T] = _quant(k, k_scale)
    cv[:, start:start + T] = _quant(v, v_scale)
    cache.k_scale.copy_(k_scale)
    cache.v_scale.copy_(v_scale)
    return cache


def append_kv(cache: QuantizedKVCache, k: torch.Tensor, v: torch.Tensor,
              index: Union[int, torch.Tensor]) -> QuantizedKVCache:
    """Decode-step write of T rows (k, v (B, T, KH, D)) with the established
    scales, in place.

    ``index``: a scalar (every row at the same position; clamped so the T
    new rows fit, as ``dynamic_update_slice`` does) or a (B,) tensor of
    per-slot positions (rows whose positions fall outside [0, S) are
    dropped). A position in a tensor is clamped and scattered on its
    device: nothing is read back to the host."""
    kq = _quant(k, cache.k_scale)
    vq = _quant(v, cache.v_scale)
    ck, cv = codes_4d(cache)
    B, S = ck.shape[:2]
    T = k.shape[1]
    if not isinstance(index, torch.Tensor):
        index = (int(index) if np.ndim(index) == 0
                 else torch.from_numpy(np.asarray(index)))
    if not isinstance(index, torch.Tensor) or index.dim() == 0:
        update_rows(ck, kq, index)
        update_rows(cv, vq, index)
        return cache
    dev = ck.device
    t = torch.arange(T, device=dev)
    index = index.to(dev, torch.int64)
    # per-slot rows: a dropped (b, t) writes instead what the slot's first
    # kept t writes, so duplicate targets carry equal values; a slot with
    # no row inside the cache rewrites its row 0 with its own bytes
    idx = index[:, None] + t[None, :]                             # (B, T)
    ok = (idx >= 0) & (idx < S)
    kept = ok.any(1)
    src = torch.where(ok, t[None, :], ok.to(torch.int8).argmax(1)[:, None])
    dest = torch.where(kept[:, None], idx.gather(1, src), 0)
    b = torch.arange(B, device=dev)[:, None].expand(B, T)
    for c, q in ((ck, kq), (cv, vq)):
        vals = q[b, src]
        vals = torch.where(kept[:, None, None, None], vals, c[b, dest])
        c[b, dest] = vals
    return cache


def dequantize_kv(cache: QuantizedKVCache, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    ck, cv = codes_4d(cache)
    k = ck.to(dtype) * cache.k_scale[:, None, :, None].to(dtype)
    v = cv.to(dtype) * cache.v_scale[:, None, :, None].to(dtype)
    return k, v
