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
    fused_gqa_decode_attention, fused_gqa_decode_attention_torch)

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
