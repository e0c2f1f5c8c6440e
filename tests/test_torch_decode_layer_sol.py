"""aimet_tpu_torch.ops.decode_layer_sol.sol_decode_layer (the plain version
the CPU takes) against aimet_tpu on the same numpy inputs.

The JAX ``sol_decode_layer`` (Pallas, interpret mode) is the oracle only
where d_model / block_a <= 2: at 3 and above its W_o double-buffer race
(decode_layer_sol.py:135) corrupts its output, so there the oracle is the
composition ``fused_decode_attention`` + ``fused_wo_mlp``.

Tolerances, as tests/test_decode_layer_sol.py: cache bytes bit-exact;
outputs within 2e-2 of their max; with int8_dots relmax < 6e-2 and
relative MSE < 3e-3 (per-row activation quantization of bf16
intermediates that the two sides round at different points).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.transformer import TransformerConfig, rope_freqs
from aimet_tpu.ops.decode_attention_fused import fused_decode_attention
from aimet_tpu.ops.decode_layer_sol import sol_decode_layer as j_sol
from aimet_tpu.ops.fused_layer import fused_wo_mlp
from aimet_tpu.ops.int_matmul import quantize_weight_int4
from aimet_tpu.ops.kv_cache import init_quantized_kv_cache, prefill_kv
from aimet_tpu_torch.ops.decode_layer_sol import sol_decode_layer


def _setup(seed, h=8):
    b, s, kh, d = 8, 32, 2, 128
    dm, f, pos = h * d, 2 * h * d, 11
    cfg = TransformerConfig(vocab_size=64, d_model=dm, n_layers=1,
                            n_heads=h, n_kv_heads=kh, d_ff=f)
    rng = np.random.RandomState(seed)
    cache = prefill_kv(init_quantized_kv_cache(b, s, kh, d),
                       jnp.asarray(rng.randn(b, pos, kh, d), jnp.float32),
                       jnp.asarray(rng.randn(b, pos, kh, d), jnp.float32), 0)
    nq = (h + 2 * kh) * d
    c = dict(b=b, s=s, h=h, kh=kh, d=d, dm=dm, f=f, pos=pos, cache=cache)
    c["qkv"] = jnp.asarray(rng.randn(b, nq), jnp.float32).astype(jnp.bfloat16)
    c["resid"] = jnp.asarray(rng.randn(b, dm) * 0.1, jnp.float32
                             ).astype(jnp.bfloat16)
    c["cos"], c["sin"] = rope_freqs(cfg, jnp.asarray([pos]))

    def rq(k, n):
        return quantize_weight_int4(
            jnp.asarray(rng.randn(k, n) * 0.05, jnp.float32))

    c["wo"], wg, wu = rq(h * d, dm), rq(dm, f), rq(dm, f)
    c["wg"], c["wu"] = wg, wu
    c["wgu"] = (jnp.concatenate([wg[0], wu[0]], axis=1),
                jnp.concatenate([wg[1], wu[1]]))
    c["wd"], c["wq"] = rq(f, dm), rq(dm, nq)
    c["gamma"] = jnp.asarray(rng.rand(dm) + 0.5, jnp.float32)
    c["agamma"] = jnp.asarray(rng.rand(dm) + 0.5, jnp.float32)
    return c


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _port(c, next_qkv, int8_dots, cache_index=None):
    pair = lambda p: (_t(p[0]), _t(p[1]))
    kc, vc = _t(c["cache"].k), _t(c["cache"].v)
    res = sol_decode_layer(
        _t(c["qkv"]), _t(c["resid"]), kc, vc, _t(c["cache"].k_scale),
        _t(c["cache"].v_scale),
        c["pos"] if cache_index is None else cache_index, _t(c["cos"]),
        _t(c["sin"]), pair(c["wo"]), pair(c["wgu"]), pair(c["wd"]),
        _t(c["gamma"]), eps=1e-5,
        next_qkv=(pair(c["wq"]), _t(c["agamma"])) if next_qkv else None,
        n_heads=c["h"], n_kv_heads=c["kh"], int8_dots=int8_dots)
    assert res[-2] is kc and res[-1] is vc          # appended in place
    return res[:-2], kc, vc


def _rel(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return (np.abs(g - w).max() / max(np.abs(w).max(), 1e-9),
            np.mean((g - w) ** 2) / max(np.mean(w ** 2), 1e-12))


@pytest.mark.parametrize("next_qkv", [True, False])
@pytest.mark.parametrize("int8_dots", [False, True])
def test_matches_jax_sol_decode_layer(next_qkv, int8_dots):
    c = _setup(seed=5 if int8_dots else 0)
    kw = dict(block_a=512, block_g=512, block_d=512)     # d_model/block_a 2
    if next_qkv:
        kw["next_qkv"] = (c["wq"], c["agamma"])
    want = j_sol(c["qkv"], c["resid"], c["cache"].k, c["cache"].v,
                 c["cache"].k_scale, c["cache"].v_scale, jnp.int32(c["pos"]),
                 c["cos"], c["sin"], c["wo"], c["wgu"], c["wd"], c["gamma"],
                 n_heads=c["h"], n_kv_heads=c["kh"], int8_dots=int8_dots,
                 **kw)
    got, kc, vc = _port(c, next_qkv, int8_dots)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(want[-2]))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(want[-1]))
    for g, w in zip(got, want[:-2]):
        assert g.dtype == torch.bfloat16
        relmax, relmse = _rel(g, w)
        if int8_dots:
            assert relmax < 6e-2 and relmse < 3e-3, (relmax, relmse)
        else:
            assert relmax < 2e-2, relmax


@pytest.mark.parametrize("cache_index", ["scalar", "per_row"])
def test_wide_model_matches_composition(cache_index):
    """d_model 1536 = 3 x block_a 512, where the JAX kernel races: the
    oracle is the two-kernel composition. The port also takes per-row
    positions (all equal here, so the oracle is the same)."""
    c = _setup(seed=3, h=12)
    ao, k_ref, v_ref = fused_decode_attention(
        c["qkv"], c["cos"], c["sin"], c["cache"].k, c["cache"].v,
        c["cache"].k_scale, c["cache"].v_scale, jnp.int32(c["pos"]),
        n_heads=c["h"], n_kv_heads=c["kh"])
    out, qkv = fused_wo_mlp(ao, c["resid"], c["wo"], c["wg"], c["wu"],
                            c["wd"], c["gamma"], block_a=512, block_g=512,
                            block_d=512, next_qkv=(c["wq"], c["agamma"]))
    idx = (None if cache_index == "scalar"
           else torch.full((c["b"],), c["pos"], dtype=torch.int32))
    (got_out, got_qkv), kc, vc = _port(c, True, False, idx)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(v_ref))
    for g, w in ((got_out, out), (got_qkv, qkv)):
        assert _rel(g, w)[0] < 2e-2
