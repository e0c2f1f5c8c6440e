"""The whole W4A8 serving slice of aimet_tpu_torch against aimet_tpu on
TransformerConfig.tiny() in f32, on the CPU (the port's plain versions;
the JAX package's XLA paths).

Tolerances: weight trees byte for byte; logits at rtol/atol 1e-4; greedy
tokens of generate and of the continuous batcher equal.
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


@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_unported_modes_raise(tiny, mode):
    _, tcfg, _, tllm = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tq.QuantizedLLM.from_quantized(tllm.qw, tcfg, mode=mode,
                                       device="cpu")


def test_random_weights_structure_and_padded_vocab():
    cfg = ttr.TransformerConfig.tiny(vocab_size=100)
    qw = tq.random_quantized_weights(cfg, seed=0, device="cpu")
    jqw = jax.eval_shape(lambda: jq.random_quantized_weights(
        jtr.TransformerConfig.tiny(vocab_size=100), mode="w4a8", seed=0))
    assert _signature(qw) == _signature(jqw)
    assert qw["lm_head"][0].shape[1] % 4096 == 0
    llm = tq.QuantizedLLM.from_quantized(qw, cfg, device="cpu", max_len=16)
    logits, _ = llm.prefill(torch.zeros((2, 4), dtype=torch.int64),
                            llm.new_caches(2))
    assert logits.shape == (2, 4, 100) and torch.isfinite(logits).all()
