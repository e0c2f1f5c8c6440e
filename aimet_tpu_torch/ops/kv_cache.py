"""INT8 KV cache: per-(row, kv head) symmetric scales fixed at prefill,
decode appends quantized into that grid. Counterpart of
``aimet_tpu/ops/kv_cache.py``; the cache bytes are identical.

Unlike the functional JAX version, every write here updates the cache's
tensors IN PLACE and returns the same cache object.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from .._device import DeviceLike, resolve_device
from ._common import div_ieee


@dataclasses.dataclass
class QuantizedKVCache:
    k: torch.Tensor        # (B, S, KH, D) int8
    v: torch.Tensor        # (B, S, KH, D) int8
    k_scale: torch.Tensor  # (B, KH) float32
    v_scale: torch.Tensor  # (B, KH) float32


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
    cache.k[:, start:start + T] = _quant(k, k_scale)
    cache.v[:, start:start + T] = _quant(v, v_scale)
    cache.k_scale.copy_(k_scale)
    cache.v_scale.copy_(v_scale)
    return cache


def append_kv(cache: QuantizedKVCache, k: torch.Tensor, v: torch.Tensor,
              index: Union[int, torch.Tensor]) -> QuantizedKVCache:
    """Decode-step write with the established scales, in place.

    ``index``: a scalar (every row at the same position; clamped so the T
    new rows fit, as ``dynamic_update_slice`` does) or a (B,) tensor of
    per-slot positions (rows whose positions fall outside the cache are
    dropped, as the JAX scatter drops them)."""
    kq = _quant(k, cache.k_scale)
    vq = _quant(v, cache.v_scale)
    B, S = cache.k.shape[:2]
    T = k.shape[1]
    index = torch.as_tensor(index)
    if index.dim() == 0:
        i = min(max(int(index), 0), S - T)
        cache.k[:, i:i + T] = kq
        cache.v[:, i:i + T] = vq
        return cache
    idx = index.to(cache.k.device, torch.int64)[:, None] + torch.arange(
        T, device=cache.k.device)[None, :]                        # (B, T)
    ok = (idx >= 0) & (idx < S)
    b = torch.arange(B, device=cache.k.device)[:, None].expand(B, T)
    cache.k[b[ok], idx[ok]] = kq[ok]
    cache.v[b[ok], idx[ok]] = vq[ok]
    return cache


def dequantize_kv(cache: QuantizedKVCache, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = cache.k.to(dtype) * cache.k_scale[:, None, :, None].to(dtype)
    v = cache.v.to(dtype) * cache.v_scale[:, None, :, None].to(dtype)
    return k, v
