"""aimet_tpu_torch.ops.decode_attention.fused_gqa_decode_attention (the
plain version the CPU takes) against aimet_tpu.ops.decode_attention's
``fused_gqa_decode_attention`` (Pallas, interpret mode) and
``fused_gqa_decode_attention_xla`` on the same numpy inputs.

Tolerances: f32 q at rtol 1e-5 / atol 1e-6, as
tests/test_decode_attention.py:27. A bf16 q rounds the probs to bf16; the
two sides' f32 softmaxes (exp, sum order) differ in the last bits, which
can move a prob's bf16 rounding by one bf16 ulp. The bound is that, for
every prob at once: |d out| <= v_scale * sum_s ulp_bf16(p_s) |v_s| (plus
the f32 tolerance).

Kernel KGQA runs only on the card (tests/test_torch_cuda_kernels.py);
here its chunk choice is checked for coverage, and a model of its split
arithmetic (per-chunk max and sum, the row's max and sum over the chunks,
probabilities rounded with those, chunk sums added in order) is held to
the plain version with the same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops.decode_attention import (fused_gqa_decode_attention as
                                            j_gqa,
                                            fused_gqa_decode_attention_xla)
from aimet_tpu_torch.ops.decode_attention import (
    GQA_CHUNKS, GQA_MIN_BLOCKS_PER_SM, fused_gqa_decode_attention,
    fused_gqa_decode_attention_torch, gqa_chunk, gqa_workspace_floats)

B, S, KH, REP, D = 4, 24, 2, 4, 16


def _case(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return dict(
        q=rs.randn(B, KH, REP, D).astype(np.float32),
        kc=rs.randint(-127, 128, (B, S, KH, D)).astype(np.int8),
        vc=rs.randint(-127, 128, (B, S, KH, D)).astype(np.int8),
        ks=(np.abs(rs.randn(B, KH)) * 0.01).astype(np.float32),
        vs=(np.abs(rs.randn(B, KH)) * 0.01).astype(np.float32))


def _jax(fn, c, pos, dtype):
    return np.asarray(fn(jnp.asarray(c["q"]).astype(dtype),
                         jnp.asarray(c["kc"]), jnp.asarray(c["vc"]),
                         jnp.asarray(c["ks"]), jnp.asarray(c["vs"]), pos))


def _port(c, pos, dtype):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return fused_gqa_decode_attention(t["q"].to(dtype), t["kc"], t["vc"],
                                      t["ks"], t["vs"], pos)


POSITIONS = [0, 10, 23, -3, 24, 100]


@pytest.mark.parametrize("pos", POSITIONS)
def test_f32_matches_jax(pos):
    c = _case(pos % 7)
    got = _port(c, pos, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (B, KH, REP, D)
    for fn in (j_gqa, fused_gqa_decode_attention_xla):
        np.testing.assert_allclose(got.numpy(), _jax(fn, c, pos, jnp.float32),
                                   rtol=1e-5, atol=1e-6)


def _prob_flip_bound(c, pos):
    """v_scale * sum_s ulp_bf16(p_s) |v[s]|, with the reference's probs."""
    qs = c["q"] * (c["ks"] / np.float32(np.sqrt(D)))[:, :, None, None]
    scores = np.einsum("bkrd,bskd->bkrs", qs, c["kc"].astype(np.float32))
    scores = np.where(np.arange(S) <= pos, scores, -1e30)
    p = np.asarray(jax.nn.softmax(jnp.asarray(scores), axis=-1))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(p, 1e-30))) - 7)
    ulp = np.where(p > 0, ulp, 0.0)
    return np.einsum("bkrs,bskd->bkrd", ulp,
                     np.abs(c["vc"].astype(np.float64))) \
        * c["vs"][:, :, None, None]


@pytest.mark.parametrize("pos", POSITIONS)
def test_bf16_matches_jax(pos):
    c = _case(pos % 5 + 11)
    got = _port(c, pos, torch.bfloat16).numpy()
    bound = _prob_flip_bound(c, pos) + 1e-6 + 1e-5 * np.abs(got)
    for fn in (j_gqa, fused_gqa_decode_attention_xla):
        want = _jax(fn, c, pos, jnp.bfloat16)
        assert (np.abs(got - want) <= bound).all(), \
            np.max(np.abs(got - want) / bound)


def test_negative_position_averages_every_row():
    """All S rows masked: the softmax of equal scores is uniform."""
    c = _case(3)
    got = _port(c, -1, torch.float32)
    want = (c["vc"].astype(np.float64).mean(1)[:, :, None]
            * c["vs"][:, :, None, None])
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(
        want, got.shape), rtol=1e-5, atol=1e-6)


def test_vector_position_raises():
    c = _case(4)
    with pytest.raises(ValueError, match="one position"):
        _port(c, torch.full((B,), 5), torch.float32)


def test_matches_serving_decode_attention():
    """The plain version IS the serving decode-attention math: the
    cross-check of tests/test_decode_attention.py:30-53 (JAX's einsum
    formulation of quantized_llm._attention) on the port's plain
    version."""
    b, s, kh, rep, d, pos = 2, 12, 2, 2, 8, 7
    rs = np.random.RandomState(0)
    q = jnp.asarray(rs.randn(b, 1, kh, rep, d).astype(np.float32))
    kc = jnp.asarray(rs.randint(-127, 128, (b, s, kh, d)), jnp.int8)
    vc = jnp.asarray(rs.randint(-127, 128, (b, s, kh, d)), jnp.int8)
    ks = jnp.asarray(np.abs(rs.randn(b, kh)).astype(np.float32) * 0.01)
    vs = jnp.asarray(np.abs(rs.randn(b, kh)).astype(np.float32) * 0.01)
    q5 = q * (ks[:, None, :, None, None] / np.sqrt(d)).astype(q.dtype)
    scores = jnp.einsum("btkrd,bskd->bkrts", q5, kc.astype(q.dtype),
                        preferred_element_type=jnp.float32)
    mask = (jnp.arange(s)[None, :] <= pos)[None, None, :, :]
    scores = jnp.where(mask[:, :, None], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    serving = jnp.einsum("bkrts,bskd->btkrd", probs, vc.astype(q.dtype))
    serving = serving * vs[:, None, :, None, None]
    t = lambda a: torch.from_numpy(np.array(a))
    ours = fused_gqa_decode_attention_torch(t(q[:, 0]), t(kc), t(vc), t(ks),
                                            t(vs), pos)
    np.testing.assert_allclose(ours.numpy(), np.asarray(serving[:, 0]),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("b,s", [(16, 1024), (32, 1024), (1, 1024),
                                 (16, 16384), (1, 1), (16, 4097), (3, 100)])
def test_gqa_chunks_cover_every_live_row_once(b, s):
    """KGQA's chunk comes from B, KH and S alone: the largest of
    GQA_CHUNKS (multiples of 32 up to 256, as its C entry takes) whose
    grid puts GQA_MIN_BLOCKS_PER_SM blocks on each of 132 SMs, else the
    smallest; every live row of every position kind lies in exactly one
    live chunk, only the last partial; the workspace holds the score rows
    padded to whole float4s, and each chunk's statistics and sums."""
    kh, rep, d = 8, 4, 128
    chunk = gqa_chunk(b, kh, s)
    fit = [c for c in GQA_CHUNKS
           if b * kh * -(-s // c) >= GQA_MIN_BLOCKS_PER_SM * 132]
    assert chunk == (fit[-1] if fit else GQA_CHUNKS[0])
    assert all(c % 32 == 0 and 32 <= c <= 256 for c in GQA_CHUNKS)
    for pos in (-1, 0, 1, chunk - 1, chunk, s // 2, s - 1, s, s + 7):
        n = s if pos < 0 else min(pos + 1, s)
        live = [(c0, min(chunk, n - c0)) for c0 in range(0, n, chunk)]
        assert [r for r0, k in live for r in range(r0, r0 + k)] \
            == list(range(n))
        assert all(k == chunk for _, k in live[:-1]) and live[-1][1] >= 1
    assert gqa_workspace_floats(b, kh, rep, d, s, chunk) == b * kh * (
        rep * -(-s // 4) * 4 + -(-s // chunk) * (16 + rep * d))


def _split_model(q, kc, vc, ks, vs, pos, chunk):
    """KGQA's split arithmetic in f32 on the CPU: each chunk's max m_c and
    sum l_c of exp(s - m_c); the row's m = max m_c and l = sum_c exp(m_c -
    m) l_c; p = exp(s - m) / l rounded to q's dtype; the chunks' sums of
    p v added in chunk order, times v_scale."""
    d = q.shape[-1]
    s_len = kc.shape[1]
    factor = (ks / torch.tensor(np.float32(np.sqrt(d)))).to(q.dtype)
    qs = (q * factor[:, :, None, None]).float()
    n = s_len if pos < 0 else min(pos + 1, s_len)
    sc = torch.einsum("bkrd,bskd->bkrs", qs, kc[:, :n].float())
    if pos < 0:
        sc = torch.full_like(sc, -1e30)
    cuts = [slice(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]
    mc = [sc[..., c].amax(-1) for c in cuts]
    lc = [torch.exp(sc[..., c] - m[..., None]).sum(-1) for c, m in
          zip(cuts, mc)]
    m = torch.stack(mc).amax(0)
    l = sum(torch.exp(a - m) * b for a, b in zip(mc, lc))
    p = (torch.exp(sc - m[..., None]) / l[..., None]).to(q.dtype).float()
    out = sum(torch.einsum("bkrs,bskd->bkrd", p[..., c], vc[:, c].float())
              for c in cuts)
    return out * vs[:, :, None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gqa_split_arithmetic_matches_plain(dtype):
    """The split arithmetic (modelled in f32) against the plain version
    across chunk edges: f32 q within 1e-5 of the max, bf16 q within one
    bf16 ulp a prob plus 1e-4 of the max."""
    b, s, kh, rep, d, chunk = 2, 100, 2, 4, 16, 32
    rs = np.random.RandomState(7)
    q = torch.from_numpy(rs.randn(b, kh, rep, d).astype(np.float32)
                         ).to(dtype)
    kc = torch.from_numpy(rs.randint(-127, 128, (b, s, kh, d)).astype(
        np.int8))
    vc = torch.from_numpy(rs.randint(-127, 128, (b, s, kh, d)).astype(
        np.int8))
    ks = torch.from_numpy(rs.rand(b, kh).astype(np.float32) * 0.5 + 0.1)
    vs = torch.from_numpy(rs.rand(b, kh).astype(np.float32) * 0.05 + 0.01)
    for pos in (-1, 0, chunk - 1, chunk, 3 * chunk + 1, s - 1, s + 5):
        got = _split_model(q, kc, vc, ks, vs, pos, chunk)
        want = fused_gqa_decode_attention_torch(q, kc, vc, ks, vs, pos)
        tol = 1e-5 if dtype == torch.float32 else 1e-4
        bound = tol * want.abs().max()
        if dtype == torch.bfloat16:
            sc = torch.einsum("bkrd,bskd->bkrs", (q * (ks / d ** 0.5)[
                :, :, None, None].to(dtype)).float(), kc.float())
            sc = sc.masked_fill(~(torch.arange(s) <= pos), -1e30)
            p = torch.softmax(sc, -1)
            ulp = torch.where(p > 0, torch.exp2(torch.floor(torch.log2(
                p.clamp_min(1e-30))) - 7), torch.zeros_like(p))
            bound = bound + torch.einsum("bkrs,bskd->bkrd", ulp,
                                         vc.abs().float()) \
                * vs[:, :, None, None]
        assert ((got - want).abs() <= bound).all(), pos
