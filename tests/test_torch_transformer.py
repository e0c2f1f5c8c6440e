"""aimet_tpu_torch.models.transformer against aimet_tpu.models.transformer:
rope at atol 1e-6, and the float Transformer (flax weights carried across
by params_from_flax) at rtol/atol 1e-4 on TransformerConfig.tiny()."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from aimet_tpu.models import transformer as jtr
from aimet_tpu_torch.convert import params_from_flax
from aimet_tpu_torch.models import transformer as ttr


def test_rope_matches():
    jcfg, tcfg = jtr.TransformerConfig.tiny(), ttr.TransformerConfig.tiny()
    pos = np.arange(0, 40, 3)
    jc, js = jtr.rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = ttr.rope_freqs(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = np.random.RandomState(0).randn(2, len(pos), 3, 16).astype(np.float32)
    # same cos/sin into both: apply_rope itself
    want = jtr.apply_rope(jnp.asarray(x), jc, js)
    got = ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.array(jc)), torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # per-row (B, T, D/2) tables and the bf16 x f32 -> f32 promotion
    pos2 = np.stack([pos, pos + 5])
    jc2, js2 = jtr.rope_freqs(jcfg, jnp.asarray(pos2))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got2 = ttr.apply_rope(xb, torch.from_numpy(np.array(jc2)),
                          torch.from_numpy(np.array(js2)))
    want2 = jtr.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jc2, js2)
    assert got2.dtype == torch.float32 and want2.dtype == jnp.float32
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-6)


def test_float_transformer_logits_match_flax():
    jcfg = jtr.TransformerConfig.tiny(vocab_size=64)
    tcfg = ttr.TransformerConfig.tiny(vocab_size=64)
    model = jtr.Transformer(jcfg)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 9))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 9), jnp.int32))
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(tokens)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm = ttr.Transformer(tcfg)
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_float_transformer_kv_caches_match_flax():
    """Prefill into float KV caches at 0, then decode one token and two at
    later positions (an int, then a 0-dim tensor): logits at rtol/atol
    1e-4, caches at 1e-5; without caches the model still returns logits
    only."""
    jcfg = jtr.TransformerConfig.tiny(vocab_size=64)
    tcfg = ttr.TransformerConfig.tiny(vocab_size=64)
    model = jtr.Transformer(jcfg)
    rs = np.random.RandomState(1)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 4), jnp.int32))
    tm = ttr.Transformer(tcfg)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    jc = jtr.init_kv_caches(jcfg, 2, 16)
    tc = ttr.init_kv_caches(tcfg, 2, 16, device="cpu")
    for (ja, jb), (ta, tb) in zip(jc, tc):
        assert ta.shape == tuple(ja.shape) == (2, 16, 2, 16)
        assert ta.dtype == tb.dtype == torch.float32 and ta.device.type == \
            "cpu"
    steps = ((rs.randint(0, 64, (2, 6)), 0), (rs.randint(0, 64, (2, 1)), 6),
             (rs.randint(0, 64, (2, 2)), torch.tensor(7)))
    apply = jax.jit(model.apply)
    for toks, idx in steps:
        jl, jc = apply(variables, jnp.asarray(toks), jc,
                       jnp.asarray(int(idx), jnp.int32))
        with torch.no_grad():
            tl, tc2 = tm(torch.from_numpy(toks), tc, idx)
        assert tc2 is not None and tc2[0][0] is tc[0][0]       # in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for (ja, jb), (ta, tb) in zip(jc, tc):
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
    with torch.no_grad():
        assert isinstance(tm(torch.from_numpy(steps[0][0])), torch.Tensor)
    bf = ttr.init_kv_caches(ttr.TransformerConfig.tiny(), 1, 8,
                            dtype=torch.bfloat16, device="cpu")
    assert len(bf) == 2 and bf[0][1].dtype == torch.bfloat16
