"""True-quant LLM inference: integer weights, INT8 KV cache — counterpart
of ``aimet_tpu/serving/quantized_llm.py``.

Modes (the weight storage and the matmul every projection goes through):

- ``w8``: int8 (K, N) codes, weight-only (``matmul_w8``, kernel KW8);
- ``w4``: split-half packed INT4, weight-only (``matmul_w4``, KW4);
- ``w4a8``: packed INT4 with per-row INT8 activations (``matmul_w4a8``,
  K1 + K2).

Prefill attention is plain tensor ops over the INT8 cache, as in the JAX
package; so is attention without caches (causal over the tokens) and a
decode of several tokens a row, which runs per op. A decode of one token
a row mirrors the JAX package's dispatch (``quantized_llm.py:370-451``),
decided from shapes and arguments before any launch:

- INT4 modes with at most 64 rows on a model with d_model and d_ff of at
  least 1024, at widths the kernels take (``layer_shapes_ok``: multiples
  of 32), take the whole-layer kernels: at a scalar ``cache_index`` one
  ``sol_decode_layer`` per layer (KSOL; true W4A8 in ``w4a8`` mode), with
  per-slot positions in ``w4`` mode ``fused_decode_attention`` (K3) +
  ``fused_wo_mlp`` (KFL) with the next layer's QKV; layer 0's QKV and the
  ``lm_head`` go through the mode's matmul;
- everything else (``w8``; ``w4a8`` with per-slot positions, which keeps
  true W4A8 since KFL is weight-only; smaller models or batches) runs per
  op: the mode's matmul per projection and K3 per layer.

The size gate is the JAX package's (``_fused_decode_blocks``: below that
width one launch per layer buys nothing); the 64 rows are what one
kernel launch takes. The TPU's other gates (backend, S % 32, B % 8,
head_dim % 128) do not apply. On the card, ``w4``, ``w8`` and the
whole-layer kernels take bf16 activations (``cfg.dtype``). The KV caches,
(B, S, KH, D) or the flat (B, S, KH*D) views of
``ops.kv_cache.flatten_kv_caches``, are updated in place. No path reads
the device back to the host, so a decode step can be captured in a CUDA
graph (``serving/batcher.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.nn import functional as F

from .._device import DeviceLike, resolve_device
from ..models.transformer import (TransformerConfig, apply_rope, inv_freq,
                                  rope_freqs)
from ..ops._common import div_ieee
from ..ops.decode_attention_fused import fused_decode_attention, positions
from ..ops.decode_layer_sol import sol_decode_layer
from ..ops.fused_layer import MAX_ROWS, fused_wo_mlp, layer_shapes_ok
from ..ops.int_matmul import (matmul_w4, matmul_w4a8, matmul_w8,
                              quantize_weight_int4,
                              quantize_weight_per_channel)
from ..ops.kv_cache import (QuantizedKVCache, append_kv, as_4d,
                            init_quantized_kv_cache, prefill_kv)

MODES = ("w8", "w4", "w4a8")
_MATMUL = {"w8": matmul_w8, "w4": matmul_w4, "w4a8": matmul_w4a8}


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


@torch.no_grad()
def quantize_transformer_weights(params, cfg: TransformerConfig,
                                 mode: str = "w8") -> Dict[str, Any]:
    """Float weights -> the integer weight tree (per-channel symmetric
    codes + f32 scales, float norms and embedding), with the JAX package's
    structure: ``wq|wk|wv`` fused into ``wqkv`` and ``w_gate|w_up`` into
    ``w_gateup``. ``w8``: int8 (K, N) codes; ``w4``/``w4a8``: split-half
    packed INT4 (K/2, N).

    ``params`` is the float ``Transformer``'s state dict (flax names) or the
    module itself."""
    check_mode(mode)
    quant = (quantize_weight_per_channel if mode == "w8"
             else quantize_weight_int4)
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    p = {k: v.detach() for k, v in params.items()}
    out = {"layers": [], "embed": p["embed.embedding"],
           "final_norm": p["final_norm.scale"],
           "lm_head": pad_vocab_for_decode(quant(p["lm_head.kernel"]))}
    for i in range(cfg.n_layers):
        pre = f"layer_{i}."
        kern = lambda name: p[pre + name + ".kernel"]
        out["layers"].append({
            "attn_norm": p[pre + "attn_norm.scale"],
            "mlp_norm": p[pre + "mlp_norm.scale"],
            "wqkv": quant(torch.cat(
                [kern("attn.wq"), kern("attn.wk"), kern("attn.wv")], dim=1)),
            "wo": quant(kern("attn.wo")),
            "w_gateup": quant(torch.cat(
                [kern("mlp.w_gate"), kern("mlp.w_up")], dim=1)),
            "w_down": quant(kern("mlp.w_down")),
        })
    return out


def pad_vocab_for_decode(lm_head_pair, multiple: int = 4096):
    """Zero-pad the lm_head's output dim to a multiple of ``multiple`` (a
    storage contract shared with the JAX package). Padded columns have
    scale 0, so their logits are 0; the forward slices them off."""
    wq, scale = lm_head_pair
    pad = (-wq.shape[1]) % multiple
    if pad == 0:
        return lm_head_pair
    return F.pad(wq, (0, pad)), F.pad(scale, (0, pad))


@torch.no_grad()
def random_quantized_weights(cfg: TransformerConfig, mode: str = "w4",
                             seed: int = 0,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """A random transformer drawn directly in quantized storage on
    ``device`` (default ``cuda``), with the structure of
    :func:`quantize_transformer_weights`: uniform random int8 bytes (int8
    codes in ``w8`` mode; in the INT4 modes every byte is a valid packed
    pair) and scales U(0.5, 1.5) * 0.02/sqrt(K), as the JAX package
    draws them."""
    check_mode(mode)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = mode != "w8"

    def rand_q(k_dim, n_dim):
        rows = k_dim // 2 if packed else k_dim
        q = torch.randint(-128, 128, (rows, n_dim), dtype=torch.int8,
                          generator=gen, device=dev)
        scale = (torch.rand((n_dim,), generator=gen, device=dev) + 0.5) \
            * (0.02 / np.sqrt(k_dim))
        return q, scale

    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "embed": torch.randn((cfg.vocab_size, D), generator=gen, device=dev,
                             dtype=torch.bfloat16) * 0.02,
        "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev),
        "lm_head": pad_vocab_for_decode(rand_q(D, cfg.vocab_size)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        out["layers"].append({
            "attn_norm": torch.ones((D,), dtype=cfg.dtype, device=dev),
            "mlp_norm": torch.ones((D,), dtype=cfg.dtype, device=dev),
            "wqkv": rand_q(D, (H + 2 * KH) * hd),
            "wo": rand_q(H * hd, D),
            "w_gateup": rand_q(D, 2 * cfg.d_ff),
            "w_down": rand_q(cfg.d_ff, D),
        })
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def quantized_weight_bytes(qw) -> int:
    """Total bytes of the quantized weight tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(qw))


def tree_to(tree, device):
    """The weight tree with every tensor moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def _rms_norm(x, scale, eps):
    var = x.to(torch.float32).square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def _proj(x, wq_scale, mode):
    """x (B, T, D) @ quantized weight -> (B, T, out), through the mode's
    matmul (the JAX package's ``_qmm``)."""
    wq, scale = wq_scale
    b, t, d = x.shape
    return _MATMUL[mode](x.reshape(b * t, d), wq, scale).reshape(b, t, -1)


def _rope(cfg, positions):
    """cos / sin of ``positions`` from frequencies kept on their device."""
    return rope_freqs(cfg, positions, inv_freq(cfg, positions.device))


def _split_qkv(cfg, qkv, cos, sin):
    """qkv (B, T, (H + 2 KH) D) -> roped q (B, T, H, D), roped k and v
    (B, T, KH, D)."""
    B, T, _ = qkv.shape
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope(qkv[..., :H * D].reshape(B, T, H, D), cos, sin)
    k = apply_rope(qkv[..., H * D:(H + KH) * D].reshape(B, T, KH, D), cos,
                   sin)
    v = qkv[..., (H + KH) * D:].reshape(B, T, KH, D)
    return q, k, v


def _causal_attention(cfg, qkv, cos, sin):
    """Attention without a cache, causal over the T tokens, in plain tensor
    ops (the JAX package's XLA path for ``caches=None``)."""
    B, T, _ = qkv.shape
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _split_qkv(cfg, qkv, cos, sin)
    k = k.repeat_interleave(H // KH, dim=2).to(torch.float32)
    v = v.repeat_interleave(H // KH, dim=2)
    scores = div_ieee(torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                                   k), float(np.sqrt(D)))
    mask = torch.ones((T, T), dtype=torch.bool, device=qkv.device).tril()
    probs = F.softmax(scores.masked_fill(~mask, -1e30), dim=-1).to(qkv.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(qkv.dtype))
    return out.reshape(B, T, H * D)


def _cache_attention(cfg, q, cache, mask, dtype):
    """Attention of roped q (B, T, H, D) over the INT8 cache in plain tensor
    ops (the JAX package's ``_attention_from_qkv``): the per-(row, kv head)
    K scales fold into q, the V scales into the output. ``mask`` (B or 1,
    1, T, S) says which cache rows each token sees."""
    B, T = q.shape[:2]
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q5 = q.reshape(B, T, KH, H // KH, D)
    q5 = q5 * div_ieee(cache.k_scale[:, None, :, None, None],
                       float(np.sqrt(D))).to(q5.dtype)
    scores = torch.einsum("btkrd,bskd->bkrts", q5,
                          cache.k.to(q5.dtype)).to(torch.float32)
    scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = F.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkrts,bskd->btkrd", probs, cache.v.to(dtype))
    out = out * cache.v_scale[:, None, :, None, None].to(out.dtype)
    return out.reshape(B, T, H * D)


def _prefill_attention(cfg, qkv, cos, sin, mask, cache, prompt_lengths):
    """Prefill attention in plain tensor ops (the JAX package leaves it to
    XLA): quantize K/V into the cache (in place), attend over the INT8
    cache."""
    q, k, v = _split_qkv(cfg, qkv, cos, sin)
    prefill_kv(cache, k, v, 0, lengths=prompt_lengths)
    return _cache_attention(cfg, q, cache, mask, qkv.dtype)


def _append_attention(cfg, qkv, cos, sin, mask, cache, cache_index):
    """Decode of T tokens a row in plain tensor ops: K/V appended at
    ``cache_index`` (in place), attention over the INT8 cache."""
    q, k, v = _split_qkv(cfg, qkv, cos, sin)
    append_kv(cache, k, v, cache_index)
    return _cache_attention(cfg, q, cache, mask, qkv.dtype)


def _fused_decode_ok(cfg: TransformerConfig, rows: int, mode: str) -> bool:
    """Whether a decode step takes the whole-layer kernels (see the module
    docstring)."""
    H, KH, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (mode in ("w4", "w4a8") and rows <= MAX_ROWS
            and cfg.d_model >= 1024 and cfg.d_ff >= 1024
            and layer_shapes_ok(H * HD, cfg.d_model, cfg.d_ff,
                                (H + 2 * KH) * HD))


def _fused_decode_layers(qw, cfg, x, caches, pos, cos, sin, mode,
                         scalar: bool):
    """The decode layers through the whole-layer kernels: x (B, D) ->
    (B, D). ``scalar``: one KSOL per layer; else K3 + KFL per layer."""
    H, KH, eps = cfg.n_heads, cfg.n_kv_heads, cfg.norm_eps
    layers = qw["layers"]
    qkv = _proj(_rms_norm(x[:, None], layers[0]["attn_norm"], eps),
                layers[0]["wqkv"], mode)[:, 0]
    for i, (layer, c) in enumerate(zip(layers, caches)):
        nxt = (None if i + 1 == len(layers)
               else (layers[i + 1]["wqkv"], layers[i + 1]["attn_norm"]))
        block = (layer["wo"], layer["w_gateup"], layer["w_down"],
                 layer["mlp_norm"])
        if scalar:
            res = sol_decode_layer(
                qkv, x, c.k, c.v, c.k_scale, c.v_scale, pos, cos, sin,
                *block, eps=eps, next_qkv=nxt, n_heads=H,
                n_kv_heads=KH, int8_dots=mode == "w4a8")
        else:
            attn, _, _ = fused_decode_attention(
                qkv, cos, sin, c.k, c.v, c.k_scale, c.v_scale, pos,
                n_heads=H, n_kv_heads=KH)
            # gate and up stay one array: up at block 1 of width d_ff
            wgu, sgu = layer["w_gateup"]
            F = cfg.d_ff
            res = fused_wo_mlp(attn, x, layer["wo"], (wgu, sgu[:F]),
                               (wgu, sgu[F:]), layer["w_down"],
                               layer["mlp_norm"], eps=eps, block_g=F,
                               up_block_offset=1, n_f=F, next_qkv=nxt)
            res = (res,) if nxt is None else res
        x, qkv = res[0], (res[1] if nxt is not None else None)
    return x


def _per_op_layers(qw, cfg, x, attention, mode):
    """The layers one op at a time: x (B, T, D) -> (B, T, D);
    ``attention(i, qkv)`` gives layer i's attention output (B, T, H*D)."""
    for i, layer in enumerate(qw["layers"]):
        qkv = _proj(_rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                    layer["wqkv"], mode)
        x = x + _proj(attention(i, qkv), layer["wo"], mode)
        gu = _proj(_rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                   layer["w_gateup"], mode)
        x = x + _proj(F.silu(gu[..., :cfg.d_ff]) * gu[..., cfg.d_ff:],
                      layer["w_down"], mode)
    return x


def _decode_positions(cache_index, T: int, device):
    """Positions of T decode tokens from ``cache_index`` (a scalar: (T,);
    (B,) per-slot positions: (B, T)) without reading the device."""
    t = torch.arange(T, device=device)
    if not isinstance(cache_index, torch.Tensor):
        if np.ndim(cache_index) == 0:
            return int(cache_index) + t
        cache_index = torch.from_numpy(np.asarray(cache_index))
    ci = cache_index.to(device, torch.int64)
    return ci.reshape(()) + t if ci.dim() == 0 else ci[:, None] + t


@torch.no_grad()
def quantized_forward(qw, cfg: TransformerConfig, tokens: torch.Tensor,
                      caches: Optional[List[QuantizedKVCache]] = None,
                      cache_index=0, prefill: bool = True, mode: str = "w8",
                      prompt_lengths=None):
    """Returns (logits (B, T, vocab) f32, caches or None).

    Without ``caches`` the T tokens attend causally to each other (tensor
    ops, as XLA runs it in the JAX package) and no cache is written.
    Prefill (``prefill=True``) writes rows [0, T) of ``caches``, with
    ``prompt_lengths`` (B,) keeping right-padding out of the KV scales.
    Decode (``prefill=False``) takes T tokens a row at ``cache_index``: an
    int or 0-dim tensor for every row, or a (B,) tensor of per-slot
    positions; one token a row takes the dispatch in the module docstring,
    more run per op with attention over the INT8 cache in tensor ops. The
    caches, (B, S, KH, D) or flat (B, S, KH*D), are updated in place and
    returned as given."""
    check_mode(mode)
    B, T = tokens.shape
    dev = tokens.device
    x = qw["embed"][tokens].to(cfg.dtype)
    if caches is None:
        cos, sin = _rope(cfg, torch.arange(T, device=dev))
        x = _per_op_layers(
            qw, cfg, x, lambda i, qkv: _causal_attention(cfg, qkv, cos, sin),
            mode)
    else:
        cs = [as_4d(c) for c in caches]
        S = cs[0].k.shape[1]
        if prefill:
            positions = torch.arange(T, device=dev)
            mask = (torch.arange(S, device=dev)[None, :]
                    <= positions[:, None])[None, None]
            cos, sin = _rope(cfg, positions)
            x = _per_op_layers(qw, cfg, x, lambda i, qkv: _prefill_attention(
                cfg, qkv, cos, sin, mask, cs[i], prompt_lengths), mode)
        elif T == 1:
            x = _decode_one(qw, cfg, x, cs, cache_index, mode)
        else:
            positions = _decode_positions(cache_index, T, dev)
            span = torch.arange(S, device=dev) <= positions[..., None]
            mask = span[None, None] if span.dim() == 2 else span[:, None]
            cos, sin = _rope(cfg, positions)
            x = _per_op_layers(qw, cfg, x, lambda i, qkv: _append_attention(
                cfg, qkv, cos, sin, mask, cs[i], cache_index), mode)
    x = _rms_norm(x, qw["final_norm"], cfg.norm_eps)
    logits = _proj(x, qw["lm_head"], mode).reshape(B * T, -1)
    logits = logits[:, :cfg.vocab_size]       # drop the vocab padding
    return logits.reshape(B, T, -1).to(torch.float32), caches


def _decode_one(qw, cfg, x, caches, cache_index, mode):
    """One decode token a row: x (B, 1, D) -> (B, 1, D), through the
    whole-layer kernels or per op with K3 (see the module docstring). The
    dispatch is decided from shapes before any launch; a Python int
    position is filled on the device."""
    B = x.shape[0]
    scalar = np.ndim(cache_index) == 0
    pos = positions(cache_index, B, x.device)
    cos, sin = _rope(cfg, pos)                            # (B, D/2)
    if _fused_decode_ok(cfg, B, mode) and (scalar or mode == "w4"):
        return _fused_decode_layers(qw, cfg, x[:, 0], caches, pos, cos, sin,
                                    mode, scalar)[:, None]

    def attention(i, qkv):
        c = caches[i]
        attn, _, _ = fused_decode_attention(
            qkv.reshape(B, -1), cos, sin, c.k, c.v, c.k_scale, c.v_scale,
            pos, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
        return attn.reshape(B, 1, -1)
    return _per_op_layers(qw, cfg, x, attention, mode)


class QuantizedLLM:
    """User-facing serving model: prefill + greedy decode with INT8 KV.

    ``params``: the float ``Transformer`` (or its state dict) to quantize.
    ``device``: ``cuda`` unless the caller passes ``"cpu"``; without CUDA
    and without an explicit CPU device this raises."""

    def __init__(self, params, cfg: TransformerConfig, mode: str = "w8",
                 max_len: int = 256, device: DeviceLike = None, _qw=None):
        check_mode(mode)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.max_len = max_len
        qw = (_qw if _qw is not None
              else quantize_transformer_weights(params, cfg, mode))
        self.qw = tree_to(qw, self.device)

    @classmethod
    def from_quantized(cls, qw, cfg: TransformerConfig, mode: str = "w8",
                       max_len: int = 256,
                       device: DeviceLike = None) -> "QuantizedLLM":
        """Build directly from a quantized weight tree."""
        return cls(None, cfg, mode, max_len, device, _qw=qw)

    def new_caches(self, batch: int) -> List[QuantizedKVCache]:
        return [init_quantized_kv_cache(batch, self.max_len,
                                        self.cfg.n_kv_heads,
                                        self.cfg.head_dim, self.device)
                for _ in range(self.cfg.n_layers)]

    def prefill(self, tokens, caches, prompt_lengths=None):
        return quantized_forward(self.qw, self.cfg, tokens, caches, 0,
                                 prefill=True, mode=self.mode,
                                 prompt_lengths=prompt_lengths)

    def decode(self, tokens, caches, positions):
        return quantized_forward(self.qw, self.cfg, tokens, caches,
                                 positions, prefill=False, mode=self.mode)

    @torch.no_grad()
    def generate(self, tokens, num_steps: int) -> torch.Tensor:
        """Greedy generation: (B, T) tokens -> (B, T + num_steps)."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        B, T = tokens.shape
        caches = self.new_caches(B)
        logits, caches = self.prefill(tokens, caches)
        next_tok = logits[:, -1].argmax(-1)[:, None]
        out = [tokens, next_tok]
        for pos in range(T, T + num_steps - 1):
            logits, caches = self.decode(next_tok, caches, pos)
            next_tok = logits[:, -1].argmax(-1)[:, None]
            out.append(next_tok)
        return torch.cat(out, dim=1)
