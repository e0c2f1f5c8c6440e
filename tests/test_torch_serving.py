"""The serving slice of aimet_tpu_torch against aimet_tpu on the CPU (the
port's plain versions; the JAX package's XLA paths), on the same weights:

- ``w4a8`` on TransformerConfig.tiny() in f32, where decode runs per op;
- ``w4`` and ``w8`` on a 2-layer model of d_model 1024 (``WIDE``), where
  the port's ``w4`` decode takes the whole-layer kernels' plain versions
  (one ``sol_decode_layer`` per layer at a scalar position, attention +
  ``fused_wo_mlp`` with per-slot positions) and the JAX package (off the
  TPU) runs per op.

Tolerances: weight trees byte for byte; f32 logits at rtol/atol 1e-4 and
cache bytes equal; bf16 logits within 5e-2 of their max; greedy tokens of
generate and of the continuous batcher equal (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models import transformer as jtr
from aimet_tpu.ops.kv_cache import init_quantized_kv_cache as j_init
from aimet_tpu.serving import batcher as jb
from aimet_tpu.serving import quantized_llm as jq
from aimet_tpu_torch import convert
from aimet_tpu_torch.models import transformer as ttr
from aimet_tpu_torch.serving import batcher as tb
from aimet_tpu_torch.serving import quantized_llm as tq

VOCAB = 64


@pytest.fixture(scope="module")
def tiny():
    jcfg = jtr.TransformerConfig.tiny(vocab_size=VOCAB)
    tcfg = ttr.TransformerConfig.tiny(vocab_size=VOCAB)
    model = jtr.Transformer(jcfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    jllm = jq.QuantizedLLM(variables, jcfg, mode="w4a8", max_len=32)
    tllm = tq.QuantizedLLM(convert.params_from_flax(params_np), tcfg,
                           mode="w4a8", max_len=32, device="cpu")
    return jcfg, tcfg, jllm, tllm


def _flat(tree):
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            leaves.append(t.float().numpy())
        else:
            leaves.append(np.asarray(t))
    walk(tree)
    return leaves


def _signature(tree):
    """(shape, dtype name) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _signature(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _signature(v)]
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def test_weights_carried_across_byte_for_byte(tiny):
    _, _, jllm, tllm = tiny
    qw_np = jax.tree_util.tree_map(np.asarray, jllm.qw)
    carried = convert.quantized_from_jax(qw_np, device="cpu")
    a, b = _flat(carried), _flat(tllm.qw)
    assert len(a) == len(b) == len(_flat(qw_np))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert tq.quantized_weight_bytes(tllm.qw) == sum(x.nbytes for x in a)


def test_quantized_forward_matches_jax(tiny):
    jcfg, tcfg, jllm, tllm = tiny
    rs = np.random.RandomState(0)
    B, T = 3, 6
    toks = rs.randint(0, VOCAB, (B, T))
    jc = [j_init(B, 32, jcfg.n_kv_heads, jcfg.head_dim)
          for _ in range(jcfg.n_layers)]
    tc = tllm.new_caches(B)
    jl, jc = jllm._prefill(jllm.qw, jcfg, jnp.asarray(toks), jc, 0)
    tl, tc = tllm.prefill(torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    nxt = rs.randint(0, VOCAB, (B, 1))
    for idx in (T, np.asarray([T, T - 2, T + 3], np.int32)):
        jl, jc = jllm._decode(jllm.qw, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(idx, jnp.int32))
        tl, tc = tllm.decode(torch.from_numpy(nxt), tc, torch.as_tensor(idx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(b.k.numpy(), np.asarray(a.k))
            np.testing.assert_array_equal(b.v.numpy(), np.asarray(a.v))


def test_generate_tokens_equal(tiny):
    _, _, jllm, tllm = tiny
    toks = np.random.RandomState(1).randint(0, VOCAB, (2, 5))
    want = np.asarray(jllm.generate(jnp.asarray(toks), 8))
    got = tllm.generate(torch.from_numpy(toks), 8).numpy()
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [1, 4])
def test_batcher_tokens_equal(tiny, chunk):
    _, _, jllm, tllm = tiny
    rs = np.random.RandomState(2)
    prompts = [list(rs.randint(0, VOCAB, int(n))) for n in (4, 6, 3, 5, 4)]
    lens = (5, 3, 7, 4, 6)

    def run(make):
        b = make()
        reqs = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, lens)]
        b.run_until_done(max_steps=200)
        assert all(r.done for r in reqs)
        return [r.generated for r in reqs]

    want = run(lambda: jb.ContinuousBatcher(jllm, num_slots=2,
                                            use_native=False,
                                            step_chunk=chunk))
    got = run(lambda: tb.ContinuousBatcher(tllm, num_slots=2,
                                           step_chunk=chunk))
    assert got == want
    assert [len(g) for g in got] == list(lens)


def test_device_defaults_to_cuda_and_raises_without_it(tiny, monkeypatch):
    _, tcfg, _, tllm = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.QuantizedLLM.from_quantized(tllm.qw, tcfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.random_quantized_weights(tcfg)


@pytest.mark.parametrize("mode", ["w2", "fp8"])
def test_unknown_mode_raises(tiny, mode):
    _, tcfg, _, tllm = tiny
    with pytest.raises(ValueError, match="unknown mode"):
        tq.QuantizedLLM.from_quantized(tllm.qw, tcfg, mode=mode,
                                       device="cpu")


def test_random_weights_structure_and_padded_vocab():
    cfg = ttr.TransformerConfig.tiny(vocab_size=100)
    qw = tq.random_quantized_weights(cfg, mode="w4a8", seed=0, device="cpu")
    jqw = jax.eval_shape(lambda: jq.random_quantized_weights(
        jtr.TransformerConfig.tiny(vocab_size=100), mode="w4a8", seed=0))
    assert _signature(qw) == _signature(jqw)
    assert qw["lm_head"][0].shape[1] % 4096 == 0
    llm = tq.QuantizedLLM.from_quantized(qw, cfg, mode="w4a8", device="cpu",
                                         max_len=16)
    logits, _ = llm.prefill(torch.zeros((2, 4), dtype=torch.int64),
                            llm.new_caches(2))
    assert logits.shape == (2, 4, 100) and torch.isfinite(logits).all()


# --------------------------------------------------------------------------
# w4 and w8 on a model wide enough for the whole-layer decode path
# --------------------------------------------------------------------------

WIDE = dict(vocab_size=VOCAB, d_model=1024, n_layers=2, n_heads=8,
            n_kv_heads=2, d_ff=1024)


def _wide_pair(mode, dtype):
    """(jllm, tllm) on the same JAX-built random weights, carried across
    by ``convert.quantized_from_jax``."""
    jcfg = jtr.TransformerConfig(**WIDE, dtype=getattr(jnp, dtype))
    tcfg = ttr.TransformerConfig(**WIDE, dtype=getattr(torch, dtype))
    jqw = jq.random_quantized_weights(jcfg, mode=mode, seed=1)
    jllm = jq.QuantizedLLM.from_quantized(jqw, jcfg, mode=mode, max_len=32)
    qw = convert.quantized_from_jax(jax.tree_util.tree_map(np.asarray, jqw),
                                    device="cpu")
    tllm = tq.QuantizedLLM.from_quantized(qw, tcfg, mode=mode, max_len=32,
                                          device="cpu")
    return jcfg, jllm, tllm


@pytest.fixture(scope="module")
def wide():
    return {(m, d): _wide_pair(m, d) for m in ("w4", "w8")
            for d in ("float32", "bfloat16")}


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 5e-2, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w4", "w8"])
def test_wide_forward_matches_jax(wide, mode, dtype):
    jcfg, jllm, tllm = wide[mode, dtype]
    rs = np.random.RandomState(3)
    B, T = 3, 6
    toks = rs.randint(0, VOCAB, (B, T))
    jc = [j_init(B, 32, jcfg.n_kv_heads, jcfg.head_dim)
          for _ in range(jcfg.n_layers)]
    tc = tllm.new_caches(B)
    jl, jc = jllm._prefill(jllm.qw, jcfg, jnp.asarray(toks), jc, 0)
    tl, tc = tllm.prefill(torch.from_numpy(toks), tc)
    _close(tl, jl, dtype)
    nxt = rs.randint(0, VOCAB, (B, 1))
    for idx in (T, np.asarray([T, T - 2, T + 3], np.int32)):
        jl, jc = jllm._decode(jllm.qw, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(idx, jnp.int32))
        tl, tc = tllm.decode(torch.from_numpy(nxt), tc,
                             idx if np.ndim(idx) == 0 else
                             torch.from_numpy(idx))
        _close(tl, jl, dtype)
        if dtype == "float32":
            for a, b in zip(jc, tc):
                np.testing.assert_array_equal(b.k.numpy(), np.asarray(a.k))
                np.testing.assert_array_equal(b.v.numpy(), np.asarray(a.v))


@pytest.mark.parametrize("mode", ["w4", "w8"])
def test_wide_generate_and_batcher_tokens_equal(wide, mode):
    _, jllm, tllm = wide[mode, "float32"]
    rs = np.random.RandomState(4)
    toks = rs.randint(0, VOCAB, (2, 5))
    want = np.asarray(jllm.generate(jnp.asarray(toks), 6))
    got = tllm.generate(torch.from_numpy(toks), 6).numpy()
    np.testing.assert_array_equal(got, want)

    prompts = [list(rs.randint(0, VOCAB, 5)) for _ in range(3)]

    def run(make):
        b = make()
        reqs = [b.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (6, 4, 5))]
        b.run_until_done(max_steps=100)
        return [r.generated for r in reqs]

    assert run(lambda: tb.ContinuousBatcher(tllm, num_slots=2,
                                            step_chunk=2)) == run(
        lambda: jb.ContinuousBatcher(jllm, num_slots=2, use_native=False,
                                     step_chunk=2))


@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_quantized_weights_carried_across(tiny, mode):
    """Float weights quantized by both packages give the same bytes, and a
    JAX-built tree loads unchanged (w8: int8 (K, N) codes + f32 scales)."""
    jcfg, tcfg, _, _ = tiny
    variables = jtr.Transformer(jcfg).init(jax.random.PRNGKey(5),
                                           jnp.zeros((1, 8), jnp.int32))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    jqw = jq.quantize_transformer_weights(variables, jcfg, mode)
    tqw = tq.quantize_transformer_weights(
        convert.params_from_flax(params_np), tcfg, mode)
    carried = convert.quantized_from_jax(
        jax.tree_util.tree_map(np.asarray, jqw), device="cpu")
    if mode == "w8":
        assert tqw["layers"][0]["wo"][0].shape == (64, 64)
    for x, y, z in zip(_flat(tqw), _flat(jqw), _flat(carried)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(z, y)


def test_defaults_match_jax(tiny):
    """Both packages called with their default modes (w8 for quantizing,
    the forward and QuantizedLLM; w4 for random weights) agree."""
    jcfg, tcfg, _, _ = tiny
    variables = jtr.Transformer(jcfg).init(jax.random.PRNGKey(6),
                                           jnp.zeros((1, 8), jnp.int32))
    params = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    jllm = jq.QuantizedLLM(variables, jcfg, max_len=16)
    tllm = tq.QuantizedLLM(params, tcfg, max_len=16, device="cpu")
    assert tllm.mode == jllm.mode
    for x, y in zip(_flat(tllm.qw), _flat(jllm.qw)):
        np.testing.assert_array_equal(x, y)
    toks = np.random.RandomState(6).randint(0, VOCAB, (2, 5))
    jl, _ = jq.quantized_forward(
        jllm.qw, jcfg, jnp.asarray(toks),
        [j_init(2, 16, jcfg.n_kv_heads, jcfg.head_dim)
         for _ in range(jcfg.n_layers)])
    tl, _ = tq.quantized_forward(tllm.qw, tcfg, torch.from_numpy(toks),
                                 tllm.new_caches(2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert _signature(tq.random_quantized_weights(tcfg, device="cpu")) == \
        _signature(jax.eval_shape(lambda: jq.random_quantized_weights(jcfg)))
