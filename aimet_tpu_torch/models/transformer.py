"""Llama-style decoder-only transformer in PyTorch — counterpart of
``aimet_tpu/models/transformer.py``.

``TransformerConfig`` and the rope helpers carry the serving path. The
float ``Transformer`` keeps the flax module's parameter names and layouts
(``layer_0.attn.wq.kernel`` is (in, out)), so a flax parameter tree maps
onto its state dict one to one (``aimet_tpu_torch.convert``). It is what
``quantize_transformer_weights`` consumes. Given float KV caches
(``init_kv_caches``) and a ``cache_index`` it writes them in place and
attends over every cached position up to its own, as the flax module does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .._device import DeviceLike, resolve_device
from ..ops._common import update_rows


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    head_dim_override: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @classmethod
    def tiny(cls, vocab_size=256):
        return cls(vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype=torch.float32)

    @classmethod
    def small(cls, vocab_size=32000):
        """~160M params."""
        return cls(vocab_size=vocab_size, d_model=768, n_layers=12,
                   n_heads=12, n_kv_heads=4, d_ff=2048)

    @classmethod
    def llama3_8b(cls):
        return cls(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336)


_INV_FREQ = {}


def inv_freq(cfg: TransformerConfig, device: torch.device) -> torch.Tensor:
    """The f32 rope frequencies on ``device``, made once, for the serving
    path: a copy from host memory in every decode step would wait for the
    stream, and cannot be captured in a CUDA graph."""
    key = (cfg.head_dim, cfg.rope_theta, torch.device(device))
    inv = _INV_FREQ.get(key)
    if inv is None:
        dim = cfg.head_dim
        inv = torch.tensor(1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2)
                                                     / dim)),
                           dtype=torch.float32, device=device)
        _INV_FREQ[key] = inv
    return inv


def rope_freqs(cfg: TransformerConfig, positions: torch.Tensor, inv=None):
    """(T,) or (B, T) int positions -> f32 cos/sin (..., T, head_dim//2).
    ``inv``: the frequencies (``inv_freq``) where the caller keeps them;
    else they are made here."""
    dim = cfg.head_dim
    positions = torch.as_tensor(positions)
    if inv is None:
        inv = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2) / dim))
        inv = torch.tensor(inv, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split ("rotate half") rope. x (B, T, H, D); cos/sin (T, D/2) or
    per-row (B, T, D/2). A bf16 x times f32 cos gives f32, as in JAX."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.to(torch.float32).square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.scale


class Dense(nn.Module):
    """Bias-free linear layer with a flax-layout (in, out) ``kernel``,
    computed in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        nn.init.normal_(self.kernel, std=1.0 / math.sqrt(d_in))

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.randn(vocab, dim))

    def forward(self, tokens):
        return self.embedding[tokens].to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = Dense(cfg.d_model, H * D, cfg.dtype)
        self.wk = Dense(cfg.d_model, KH * D, cfg.dtype)
        self.wv = Dense(cfg.d_model, KH * D, cfg.dtype)
        self.wo = Dense(H * D, cfg.d_model, cfg.dtype)

    def forward(self, x, cos, sin, mask, kv_cache=None, cache_index=None):
        """Without ``kv_cache`` the attention output; with a (k, v) pair of
        (B, S, KH, D) float caches, the new K/V written into them at
        ``cache_index`` (in place) and (output, (k, v)) over the whole
        cache."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = apply_rope(self.wq(x).view(B, T, H, D), cos, sin)
        k = apply_rope(self.wk(x).view(B, T, KH, D), cos, sin)
        v = self.wv(x).view(B, T, KH, D)
        if kv_cache is not None:
            ck, cv = kv_cache
            update_rows(ck, k.to(ck.dtype), cache_index)
            update_rows(cv, v.to(cv.dtype), cache_index)
            k, v = ck, cv
        rep = H // KH
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)
                  ) / np.sqrt(D)
        scores = scores.masked_fill(~mask, -1e30)
        probs = F.softmax(scores, dim=-1).to(cfg.dtype)
        out = (probs @ v.to(cfg.dtype)).transpose(1, 2).reshape(B, T, H * D)
        if kv_cache is None:
            return self.wo(out)
        return self.wo(out), kv_cache


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.w_gate = Dense(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.w_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.w_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.mlp = MLP(cfg)

    def forward(self, x, cos, sin, mask, kv_cache=None, cache_index=None):
        """x, or (x, (k, v)) when given a KV cache (see ``Attention``)."""
        h = self.attn(self.attn_norm(x), cos, sin, mask, kv_cache,
                      cache_index)
        if kv_cache is not None:
            h, kv_cache = h
        x = x + h
        x = x + self.mlp(self.mlp_norm(x))
        return x if kv_cache is None else (x, kv_cache)


class Transformer(nn.Module):
    """Float model: tokens (B, T) -> logits (B, T, vocab) f32. Module names
    follow the flax model: ``embed``, ``layer_{i}``, ``final_norm``,
    ``lm_head``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32)

    def forward(self, tokens, kv_caches=None, cache_index=None):
        """Without ``kv_caches``: causal over the T tokens; returns the
        logits. With ``kv_caches`` (per layer a (k, v) pair of (B, S, KH, D)
        float caches, ``init_kv_caches``) and ``cache_index`` (the first
        position written, an int or a 0-dim tensor): the new K/V are
        written in place, each token attends to every cache position up to
        its own; returns (logits, caches)."""
        cfg = self.cfg
        T = tokens.shape[1]
        dev = tokens.device
        x = self.embed(tokens)
        if kv_caches is None:
            positions = torch.arange(T, device=dev)
            mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                         device=dev))[None, None]
            cos, sin = rope_freqs(cfg, positions)
            for i in range(cfg.n_layers):
                x = getattr(self, f"layer_{i}")(x, cos, sin, mask)
            return self.lm_head(self.final_norm(x))
        S = kv_caches[0][0].shape[1]
        start = (cache_index.to(dev).reshape(())
                 if isinstance(cache_index, torch.Tensor)
                 else int(cache_index))
        positions = start + torch.arange(T, device=dev)
        mask = (torch.arange(S, device=dev)[None, :]
                <= positions[:, None])[None, None]
        cos, sin = rope_freqs(cfg, positions)
        new_caches = []
        for i in range(cfg.n_layers):
            x, c = getattr(self, f"layer_{i}")(x, cos, sin, mask,
                                               kv_caches[i], cache_index)
            new_caches.append(c)
        return self.lm_head(self.final_norm(x)), new_caches


def init_kv_caches(cfg: TransformerConfig, batch: int, max_len: int,
                   dtype=None, device: DeviceLike = None):
    """Zero float KV caches for ``Transformer.forward``: per layer a (k, v)
    pair of (batch, max_len, KH, head_dim) in ``dtype`` (default
    ``cfg.dtype``), on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]
