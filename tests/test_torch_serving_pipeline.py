"""The rest of the serving path of aimet_tpu_torch against aimet_tpu on the
CPU (the port's plain versions; the JAX package's XLA paths), on the same
weights (TransformerConfig.tiny() in f32, max_len 32):

- ``quantized_forward`` without caches and with T > 1 decode tokens at a
  scalar and at per-slot positions, in ``w8``, ``w4`` and ``w4a8``: logits
  at rtol/atol 1e-4 and cache bytes equal; flat (B, S, KH*D) caches give
  the 4-D caches' logits and bytes;
- the C++ scheduler's returns equal to the JAX package's on one seeded
  sequence of calls;
- ``run_pipelined`` against the step engine (both schedulers, chunks of 1
  and 4), against the JAX package's ``run_pipelined``, with EOS, and after
  ``warm_admission(pipelined=True)``: tokens per request equal;
- ``use_native=True`` without a C++ compiler raises.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu import native as jnative
from aimet_tpu.models import transformer as jtr
from aimet_tpu.ops import kv_cache as jkv
from aimet_tpu.serving import batcher as jb
from aimet_tpu.serving import quantized_llm as jq
from aimet_tpu_torch import convert
from aimet_tpu_torch import native as tnative
from aimet_tpu_torch.models import transformer as ttr
from aimet_tpu_torch.ops import kv_cache as tkv
from aimet_tpu_torch.serving import batcher as tb
from aimet_tpu_torch.serving import quantized_llm as tq

VOCAB, MAX_LEN = 64, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    the test workers share the host's cores (many threads a worker made
    the engines' thousands of small ops several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig.tiny(vocab_size=VOCAB)
    tcfg = ttr.TransformerConfig.tiny(vocab_size=VOCAB)
    variables = jax.jit(jtr.Transformer(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = (
                jq.QuantizedLLM(variables, jcfg, mode=mode, max_len=MAX_LEN),
                tq.QuantizedLLM(params, tcfg, mode=mode, max_len=MAX_LEN,
                                device="cpu"))
        return (jcfg, tcfg, *made[mode])
    return get


def _same_caches(jc, tc):
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.k.numpy(), np.asarray(a.k))
        np.testing.assert_array_equal(b.v.numpy(), np.asarray(a.v))


def _close(got, want, mode):
    """f32 logits at rtol/atol 1e-4; in ``w4a8`` within 5e-2 of their max
    (the serving tests' bound for logits that may part by more than
    rounding): its per-row INT8 activation codes lie on the rounding
    boundaries of both packages' f32 values, where XLA's and PyTorch's
    CPU silu, an ulp apart, can pick codes one level apart, and one level
    moves the logits by up to ~4e-2 here."""
    want = np.asarray(want)
    if mode == "w4a8":
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 5e-2, err
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["w8", "w4", "w4a8"])
def test_cache_free_and_multi_token_forwards_match_jax(models, mode):
    jcfg, tcfg, jllm, tllm = models(mode)
    rs = np.random.RandomState(0)
    B = 3
    toks = rs.randint(0, VOCAB, (B, 7))
    close = lambda t, j: _close(t, j, mode)
    jl, none = jllm._prefill(jllm.qw, jcfg, jnp.asarray(toks))
    tl, tnone = tq.quantized_forward(tllm.qw, tcfg, torch.from_numpy(toks),
                                     mode=mode)
    assert none is None and tnone is None and tl.shape == (B, 7, VOCAB)
    close(tl, jl)

    jc = [jkv.init_quantized_kv_cache(B, MAX_LEN, jcfg.n_kv_heads,
                                      jcfg.head_dim)
          for _ in range(jcfg.n_layers)]
    tc, tf = tllm.new_caches(B), tkv.flatten_kv_caches(tllm.new_caches(B))
    jl, jc = jllm._prefill(jllm.qw, jcfg, jnp.asarray(toks[:, :5]), jc, 0)
    for c in (tc, tf):
        tl, out = tllm.prefill(torch.from_numpy(toks[:, :5]), c)
        assert out is c
        close(tl, jl)
    # T = 3 at a scalar position, then T = 2 at per-slot positions (slot 2's
    # second row falls past the cache and is dropped)
    for idx, t in ((5, 3), (np.asarray([8, 11, MAX_LEN - 1], np.int32), 2)):
        nxt = rs.randint(0, VOCAB, (B, t))
        jl, jc = jllm._decode(jllm.qw, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(idx))
        got = [tllm.decode(torch.from_numpy(nxt), c, torch.as_tensor(idx))[0]
               for c in (tc, tf)]
        close(got[0], jl)
        assert torch.equal(got[0], got[1])
        _same_caches(jc, tc)
        _same_caches(jkv.flatten_kv_caches(jc), tf)
    # one token a row on flat caches: the same dispatch, logits and bytes
    nxt = torch.from_numpy(rs.randint(0, VOCAB, (B, 1)))
    pos = torch.tensor([13, 14, 2], dtype=torch.int32)
    a, b = (tllm.decode(nxt, c, pos)[0] for c in (tc, tf))
    assert torch.equal(a, b)
    _same_caches(tkv.flatten_kv_caches(tc), tf)


def test_native_scheduler_returns_equal_jax():
    rs = np.random.RandomState(7)
    j, t = jnative.NativeScheduler(3, 24), tnative.NativeScheduler(3, 24)
    trace = []
    for step in range(200):
        op = rs.randint(5)
        active = t.active_slots()
        assert active == j.active_slots()
        if op == 0 or step < 4:
            args = (int(rs.randint(1, 9)), int(rs.randint(1, 6)),
                    None if rs.rand() < 0.5 else int(rs.randint(4)))
            trace.append((j.submit(*args), t.submit(*args)))
        elif op == 1:
            trace.append((j.admit(), t.admit()))
        elif active and op in (2, 3):
            slot, tok = int(rs.choice(active)), int(rs.randint(4))
            call = "start" if op == 2 else "record"
            trace.append((getattr(j, call)(slot, tok),
                          getattr(t, call)(slot, tok)))
        else:
            uid = int(rs.randint(12))
            trace.append(((j.request_done(uid), j.request_generated(uid),
                           j.evict(uid)),
                          (t.request_done(uid), t.request_generated(uid),
                           t.evict(uid))))
        trace.append(((j.num_active, j.num_pending),
                      (t.num_active, t.num_pending)))
        for a, b in zip(j.decode_state(), t.decode_state()):
            np.testing.assert_array_equal(a, b)
    assert len(trace) > 200
    for a, b in trace:
        assert a == b


def _prompts(seed, n=9):
    rs = np.random.RandomState(seed)
    return ([list(rs.randint(0, VOCAB, int(k))) for k in rs.randint(2, 9, n)],
            [int(k) for k in rs.randint(2, 12, n)])


def _serve(batcher, prompts, lens, pipelined, eos=None):
    reqs = [batcher.submit(p, max_new_tokens=n, eos_id=eos)
            for p, n in zip(prompts, lens)]
    steps = (batcher.run_pipelined(300) if pipelined
             else batcher.run_until_done(300))
    assert all(r.done for r in reqs) and steps > 0
    return [r.generated for r in reqs]


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("chunk", [1, 4])
def test_pipelined_tokens_equal_the_step_engine(models, use_native, chunk):
    _, _, _, tllm = models("w4a8")
    prompts, lens = _prompts(2)
    make = lambda: tb.ContinuousBatcher(tllm, num_slots=3, step_chunk=chunk,
                                        use_native=use_native)
    want = _serve(make(), prompts, lens, pipelined=False)
    assert [len(g) for g in want] == lens
    assert _serve(make(), prompts, lens, pipelined=True) == want


def test_pipelined_tokens_equal_jax(models):
    _, _, jllm, tllm = models("w4a8")
    prompts, lens = _prompts(3, n=6)
    want = _serve(jb.ContinuousBatcher(jllm, num_slots=3, step_chunk=4),
                  prompts, lens, pipelined=True)
    for use_native in (False, True):
        got = _serve(tb.ContinuousBatcher(tllm, num_slots=3, step_chunk=4,
                                          use_native=use_native),
                     prompts, lens, pipelined=True)
        assert got == want


@pytest.mark.parametrize("use_native", [False, True])
def test_pipelined_stops_at_eos(models, use_native):
    """An EOS token (one the step engine generates mid-request without
    one) ends each request at its first occurrence, in both engines."""
    _, _, _, tllm = models("w4a8")
    prompts, lens = _prompts(4)
    lens = [11] * len(lens)
    make = lambda: tb.ContinuousBatcher(tllm, num_slots=3, step_chunk=4,
                                        use_native=use_native)
    free = _serve(make(), prompts, lens, pipelined=False)
    eos = max(set(t for g in free for t in g[1:-1]),
              key=lambda t: sum(t in g[1:-1] for g in free))
    want = [g[:g.index(eos) + 1] if eos in g else g for g in free]
    assert any(len(w) < 11 for w in want)
    assert _serve(make(), prompts, lens, False, eos) == want
    assert _serve(make(), prompts, lens, True, eos) == want


def test_warm_admission_then_traffic(models):
    _, _, _, tllm = models("w4a8")
    prompts, lens = _prompts(5)
    want = _serve(tb.ContinuousBatcher(tllm, num_slots=4, step_chunk=4),
                  prompts, lens, pipelined=False)
    b = tb.ContinuousBatcher(tllm, num_slots=4, step_chunk=4)
    b.warm_admission(prompt_len=8, pipelined=True)
    assert _serve(b, prompts, lens, pipelined=True) == want
    b.warm_admission(prompt_len=8)
    assert _serve(b, prompts, lens, pipelined=False) == want


def test_native_scheduler_without_a_compiler_raises(models, monkeypatch,
                                                    tmp_path):
    _, _, _, tllm = models("w4a8")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    tnative.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            tb.ContinuousBatcher(tllm, num_slots=2)
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            tb.ContinuousBatcher(tllm, num_slots=2, use_native=True)
        assert tb.ContinuousBatcher(tllm, num_slots=2, use_native=False)
    finally:
        tnative.library.cache_clear()
