"""aimet_tpu_torch.ops.fused_layer.fused_wo_mlp (the plain version the CPU
takes) against aimet_tpu.ops.fused_layer.fused_wo_mlp (Pallas, interpret
mode) on the same numpy inputs, with gate|up concatenated as serving
stores them (``up_block_offset``) and as separate arrays.

Tolerances, as tests/test_fused_layer.py: f32 at rtol = atol = 2e-5 (the
same rounding points; the TPU kernel's biased-nibble sums differ in the
last bits); bf16 within 5e-2 of the max.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.ops.fused_layer import fused_wo_mlp as j_fused
from aimet_tpu.ops.int_matmul import quantize_weight_int4
from aimet_tpu_torch.ops.fused_layer import (fused_wo_mlp, fused_wo_mlp_torch,
                                             rms_norm)
from aimet_tpu_torch.ops.int_matmul import matmul_w4a8_torch

BLOCKS = dict(block_a=128, block_g=128, block_d=128)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32 if dtype else None))
    return t.to(dtype) if dtype else t


def _case(m, A, D, F, nq, seed, dtype=jnp.float32):
    rs = np.random.RandomState(seed)

    def q4(k, n):
        return tuple(np.array(a) for a in quantize_weight_int4(jnp.asarray(
            rs.randn(k, n).astype(np.float32) * (1.5 / np.sqrt(k)))))

    wo, wg, wu, wd = q4(A, D), q4(D, F), q4(D, F), q4(F, D)
    wgu = (np.concatenate([wg[0], wu[0]], 1), np.concatenate([wg[1], wu[1]]))
    return dict(
        ao=jnp.asarray(rs.randn(m, A).astype(np.float32) * 0.5).astype(dtype),
        resid=jnp.asarray(rs.randn(m, D).astype(np.float32) * 0.5
                          ).astype(dtype),
        gamma=jnp.asarray(rs.rand(D).astype(np.float32) + 0.5),
        agamma=jnp.asarray(rs.rand(D).astype(np.float32) + 0.5),
        wo=wo, wg=wg, wu=wu, wgu=wgu, wd=wd, wq=q4(D, nq) if nq else None)


def _port(c, dtype, next_qkv):
    pair = lambda p: (torch.from_numpy(p[0]), torch.from_numpy(p[1]))
    nxt = ((pair(c["wq"]), _t(c["agamma"])) if next_qkv else None)
    return fused_wo_mlp(_t(c["ao"], dtype), _t(c["resid"], dtype),
                        pair(c["wo"]), pair(c["wgu"]), pair(c["wd"]),
                        _t(c["gamma"]), eps=1e-5, next_qkv=nxt)


@pytest.mark.parametrize("m", [1, 8, 16, 33])
def test_fused_wo_mlp_f32_concatenated_gate_up(m):
    A, D, F = 256, 256, 512
    c = _case(m, A, D, F, 0, m)
    wgu = tuple(jnp.asarray(a) for a in c["wgu"])
    want = j_fused(c["ao"], c["resid"], c["wo"], (wgu[0], wgu[1][:F]),
                   (wgu[0], wgu[1][F:]), c["wd"], c["gamma"], eps=1e-5,
                   up_block_offset=F // 128, n_f=F, **BLOCKS)
    got = _port(c, None, False)
    assert got.dtype == torch.float32 and got.shape == (m, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_fused_wo_mlp_f32_next_qkv_separate_gate_up():
    m, A, D, F, nq = 16, 256, 256, 512, 384
    c = _case(m, A, D, F, nq, 7)
    out, qkv = j_fused(c["ao"], c["resid"], c["wo"], c["wg"], c["wu"],
                       c["wd"], c["gamma"], eps=1e-5, block_q=128,
                       next_qkv=(c["wq"], c["agamma"]), **BLOCKS)
    got_out, got_qkv = _port(c, None, True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got_qkv.numpy(), np.asarray(qkv), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("next_qkv", [False, True])
def test_fused_wo_mlp_bf16_rect(next_qkv):
    m, A, D, F, nq = 16, 384, 256, 640, 256
    c = _case(m, A, D, F, nq, 11, dtype=jnp.bfloat16)
    kw = dict(eps=1e-5, **BLOCKS)
    if next_qkv:
        kw.update(block_q=128, next_qkv=(c["wq"], c["agamma"]))
    want = j_fused(c["ao"], c["resid"], c["wo"], c["wg"], c["wu"], c["wd"],
                   c["gamma"], **kw)
    got = _port(c, torch.bfloat16, next_qkv)
    want, got = (want, got) if next_qkv else ((want,), (got,))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err < 5e-2, err


def test_fused_wo_mlp_int8_dots_is_the_w4a8_composition():
    """int8_dots: every projection quantizes its input per row and runs the
    exact W4A8 matmul (the whole-layer kernel's phases in w4a8 mode)."""
    m, A, D, F = 4, 128, 128, 256
    c = _case(m, A, D, F, 0, 3)
    pair = lambda p: (torch.from_numpy(p[0]), torch.from_numpy(p[1]))
    ao, resid, gamma = _t(c["ao"]), _t(c["resid"]), _t(c["gamma"])
    mm = lambda x, p: matmul_w4a8_torch(x, *pair(p), torch.float32)
    y = mm(ao, c["wo"]) + resid
    gu = mm(rms_norm(y, gamma, 1e-5), c["wgu"])
    h = gu[:, :F] * torch.sigmoid(gu[:, :F]) * gu[:, F:]
    want = mm(h, c["wd"]) + y
    got = fused_wo_mlp_torch(ao, resid, pair(c["wo"]), pair(c["wgu"]),
                             pair(c["wd"]), gamma, int8_dots=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
