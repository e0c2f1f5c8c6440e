"""aimet_tpu_torch.ops.decode_attention_fused (plain version on the CPU)
against the JAX package's XLA decode path
``_attention_from_qkv(..., project_out=False)`` on the same numpy inputs.

Tolerances: cache bytes bit-exact; attn_mix max error relative to its max
< 2e-2 in bf16 (the bound of tests/test_decode_attention_fused.py) and
< 1e-5 in f32.

Kernel K3 itself runs only on the card (tests/test_torch_cuda_kernels.py);
here its split of the cache across blocks (``split_chunk``) is checked for
coverage, and a model of its arithmetic (two-plane int8 queries and
probabilities, exact integer dots, chunks merged in order) is held to the
plain version: within 1e-3 of the max in f32.
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
from aimet_tpu_torch.models.transformer import apply_rope
from aimet_tpu_torch.ops.decode_attention_fused import (
    attention_kernel_shape_ok, fused_decode_attention,
    fused_decode_attention_torch, score_workspace, scores_fit, split_chunk,
    split_record_floats)


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


def _live_chunks(S, chunk, pos):
    """(first row, live rows) of the chunks whose blocks do not exit, as
    csrc/split_attention.cuh cuts a row at position ``pos``."""
    n = S if pos < 0 else min(pos + 1, S)
    return [(c * chunk, min(chunk, n - c * chunk))
            for c in range(-(-n // chunk))]


@pytest.mark.parametrize("b,s", [(16, 1024), (32, 1024), (1, 1024),
                                 (16, 16384), (1, 16384), (3, 100)])
def test_split_chunks_cover_every_live_row_once(b, s):
    """K3's grid is sized from B, KH and S alone: every live row of every
    position kind lies in exactly one live chunk, no live chunk is empty,
    only the last is partial and it holds the appended row; chunks of 128
    rows, or 64 where 128 would give fewer blocks than 132 SMs."""
    kh = 8
    chunk = split_chunk(b, kh, s)
    assert chunk == (64 if b * kh * -(-s // 128) < 132 else 128)
    nchunks = -(-s // chunk)
    for pos in (-1, 0, 1, chunk - 1, chunk, s // 2, s - 1, s, s + 7):
        n = s if pos < 0 else min(pos + 1, s)
        live = _live_chunks(s, chunk, pos)
        assert [r for r0, k in live for r in range(r0, r0 + k)] \
            == list(range(n))
        assert len(live) <= nchunks and all(k >= 1 for _, k in live)
        assert all(k == chunk for _, k in live[:-1])
        if 0 <= pos < s:
            assert live[-1][0] <= pos < live[-1][0] + live[-1][1]
    assert split_record_floats(4, 128) == 16 + 4 * 128


def _planes(x, scale):
    """x ~ scale * (x1 + x2 / 256), two int8 planes (round half to even,
    clamped to +-127), as the kernel cuts queries and probabilities."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    x1 = torch.round(x / safe).clamp(-127, 127)
    x2 = torch.round((x - x1 * safe) / safe * 256).clamp(-127, 127)
    zero = scale <= 0
    return (x1.masked_fill(zero, 0).to(torch.int64),
            x2.masked_fill(zero, 0).to(torch.int64))


def _split_model(qkv, cos, sin, kc, vc, ks, vs, pos, h, kh, chunk):
    """K3's arithmetic in float64 / int64 on caches that already hold the
    appended rows: per (row, kv head) chunk, two-plane int8 queries,
    exact integer scores and context, two-plane probabilities; chunks
    merged in order."""
    b, s, _, d = kc.shape
    rep = h // kh
    q = apply_rope(qkv[:, :h * d].float().reshape(b, 1, h, d), cos[:, None],
                   sin[:, None]).reshape(b, kh, rep, d)
    q = q * (ks / np.float32(np.sqrt(d)))[:, :, None, None]
    sq = q.abs().amax(-1) / 127                                  # (b,kh,rep)
    q1, q2 = _planes(q, sq[..., None])
    out = torch.zeros(b, kh, rep, d, dtype=torch.float64)
    for i in range(b):
        for j in range(kh):
            recs = []
            for r0, k in _live_chunks(s, chunk, int(pos[i])):
                kk = kc[i, r0:r0 + k, j].to(torch.int64)         # (k, d)
                vv = vc[i, r0:r0 + k, j].to(torch.int64)
                sc = sq[i, j][:, None].double() * (
                    (q1[i, j] @ kk.T) + (q2[i, j] @ kk.T) / 256)  # (rep, k)
                if pos[i] < 0:
                    sc = torch.full_like(sc, -1e30)
                m = sc.amax(-1, keepdim=True)
                p1, p2 = _planes(torch.exp(sc - m) * 127,
                                 torch.ones_like(m))
                pt = (p1 + p2 / 256) / 127
                ctx = ((p1 @ vv) + (p2 @ vv) / 256) / 127
                recs.append((m[:, 0], pt.sum(-1), ctx))
            m = torch.stack([r[0] for r in recs]).amax(0)
            w = [torch.exp(r[0] - m) for r in recs]
            tot = sum(wc * r[1] for wc, r in zip(w, recs))
            acc = sum(wc[:, None] * r[2] for wc, r in zip(w, recs))
            out[i, j] = acc / tot[:, None] * vs[i, j]
    return out.reshape(b, h * d)


@pytest.mark.parametrize("b,s,h,kh,d,chunk,positions", [
    (2, 100, 4, 4, 64, 32, [99, 40]),        # rep 1, a partial chunk
    (3, 160, 16, 4, 32, 64, [159, 0, 77]),   # rep 4
    (2, 96, 16, 2, 128, 32, [-1, 200]),      # rep 8: masked, outside
])
def test_split_arithmetic_matches_plain(b, s, h, kh, d, chunk, positions):
    """The split kernel's arithmetic (modelled in float64) against the plain
    version in f32: within 1e-3 of the max (the kernel's budget is 2e-2)."""
    rs = np.random.RandomState(s + d)
    kc = torch.from_numpy(rs.randint(-127, 128, (b, s, kh, d)).astype(
        np.int8))
    vc = torch.from_numpy(rs.randint(-127, 128, (b, s, kh, d)).astype(
        np.int8))
    ks = torch.from_numpy(rs.rand(b, kh).astype(np.float32) * 0.05 + 0.01)
    vs = torch.from_numpy(rs.rand(b, kh).astype(np.float32) * 0.05 + 0.01)
    qkv = torch.from_numpy(rs.randn(b, (h + 2 * kh) * d).astype(np.float32))
    pos = torch.tensor(positions, dtype=torch.int32)
    ang = pos.float()[:, None] * torch.from_numpy(
        rs.rand(d // 2).astype(np.float32))
    cos, sin = torch.cos(ang), torch.sin(ang)
    ref, kc, vc = fused_decode_attention_torch(
        qkv, cos, sin, kc, vc, ks, vs, pos, n_heads=h, n_kv_heads=kh)
    got = _split_model(qkv, cos, sin, kc, vc, ks, vs, pos, h, kh, chunk)
    err = (got - ref.double()).abs().max() / ref.double().abs().max()
    assert err < 1e-3, err
