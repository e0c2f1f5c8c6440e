"""aimet_tpu_torch.ops.decode_attention_fused (plain version on the CPU)
against the JAX package's XLA decode path
``_attention_from_qkv(..., project_out=False)`` on the same numpy inputs.

Tolerances: cache bytes bit-exact; attn_mix max error relative to its max
< 2e-2 in bf16 (the bound of tests/test_decode_attention_fused.py) and
< 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.transformer import TransformerConfig as JCfg
from aimet_tpu.models.transformer import rope_freqs
from aimet_tpu.ops.kv_cache import init_quantized_kv_cache, prefill_kv
from aimet_tpu.serving.quantized_llm import _attention_from_qkv
from aimet_tpu_torch.ops.decode_attention_fused import (
    attention_kernel_shape_ok, fused_decode_attention,
    fused_decode_attention_torch, score_workspace, scores_fit)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [
    # b, s, h, kh, d, positions
    (4, 32, 4, 2, 32, 7),                 # rep 2, scalar position
    (3, 16, 4, 4, 16, [3, 9, 0]),         # rep 1, per-slot positions
    (2, 24, 8, 2, 32, [23, 11]),          # rep 4, append at the last slot
    (2, 16, 8, 2, 16, 15),                # rep 4, scalar at the last slot
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,positions", CASES)
def test_plain_matches_xla_decode_path(b, s, h, kh, d, positions, dtype):
    rs = np.random.RandomState(b * 100 + s)
    cfg = JCfg(vocab_size=64, d_model=h * d, n_layers=1, n_heads=h,
               n_kv_heads=kh, d_ff=4 * h * d)
    cache = init_quantized_kv_cache(b, s, kh, d)
    n_pre = 5
    kp = rs.randn(b, n_pre, kh, d).astype(np.float32)
    vp = rs.randn(b, n_pre, kh, d).astype(np.float32)
    cache = prefill_kv(cache, jnp.asarray(kp), jnp.asarray(vp), 0)
    qkv32 = rs.randn(b, (h + 2 * kh) * d).astype(np.float32)
    qkv_j = jnp.asarray(qkv32).astype(getattr(jnp, dtype))
    pos = np.asarray(positions, np.int32)
    if pos.ndim == 0:
        cos, sin = rope_freqs(cfg, jnp.asarray([int(pos)]))     # (1, D/2)
        mask = (jnp.arange(s)[None, :] <= int(pos))[None, None]
        jidx = jnp.int32(int(pos))
    else:
        cos, sin = rope_freqs(cfg, jnp.asarray(pos)[:, None])   # (B,1,D/2)
        mask = (jnp.arange(s)[None, None, :]
                <= jnp.asarray(pos)[:, None, None])[:, None]
        jidx = jnp.asarray(pos)
    ref, ref_cache = jax.jit(
        lambda *a: _attention_from_qkv(cfg, None, *a, "w4a8", prefill=False,
                                       project_out=False))(
        qkv_j[:, None, :], cos, sin, mask, cache, jidx)

    kc, vc = _t(cache.k), _t(cache.v)
    qkv_t = _t(np.asarray(qkv_j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ao, k_new, v_new = fused_decode_attention(
        qkv_t, _t(cos).reshape(-1, d // 2), _t(sin).reshape(-1, d // 2),
        kc, vc, _t(cache.k_scale), _t(cache.v_scale), torch.as_tensor(pos),
        n_heads=h, n_kv_heads=kh)
    assert k_new is kc and v_new is vc            # updated in place
    np.testing.assert_array_equal(kc.numpy(), np.asarray(ref_cache.k))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(ref_cache.v))
    assert ao.dtype == qkv_t.dtype and ao.shape == (b, h * d)
    got = ao.to(torch.float32).numpy()
    want = np.asarray(ref[:, 0].astype(jnp.float32))
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-9)
    assert err < (2e-2 if dtype == "bfloat16" else 1e-5), err


def test_position_outside_cache_writes_nothing():
    b, s, kh, d = 2, 8, 1, 4
    kc = torch.zeros((b, s, kh, d), dtype=torch.int8)
    vc = torch.zeros_like(kc)
    qkv = torch.randn(b, (1 + 2 * kh) * d)
    cos, sin = torch.ones(1, d // 2), torch.zeros(1, d // 2)
    ao, _, _ = fused_decode_attention_torch(
        qkv, cos, sin, kc, vc, torch.ones(b, kh), torch.ones(b, kh),
        torch.tensor([s, -1], dtype=torch.int32), n_heads=1, n_kv_heads=kh)
    assert not kc.any() and not vc.any()
    assert torch.isfinite(ao).all()



def test_attention_kernels_take_any_cache_length():
    """At Llama-3-8B heads (32 / 8, D 128) the kernels take S = 16,384: the
    score rows outgrow shared memory past 12,352 (16 warps) and 13,376 (8
    warps) and go to a workspace; the head limits still raise."""
    attention_kernel_shape_ok(32, 8, 128)
    assert scores_fit(4, 128, 12352, 16) and not scores_fit(4, 128, 12353, 16)
    assert scores_fit(4, 128, 13376, 8) and not scores_fit(4, 128, 13377, 8)
    assert score_workspace(2, 8, 4, 128, 1024, 16, "cpu") is None
    ws = score_workspace(2, 8, 4, 128, 16384, 16, "cpu")
    assert ws.shape == (2, 8, 4, 16384) and ws.dtype == torch.float32
    for h, kh, d in ((72, 8, 128), (32, 8, 256), (32, 8, 130)):
        with pytest.raises(ValueError):
            attention_kernel_shape_ok(h, kh, d)
