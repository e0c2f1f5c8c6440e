"""The pipelined serving engine on the card: the decode chunk captured as one
CUDA graph and replayed, against the same chunk run eagerly and against
the step engine. Every test here needs a CUDA device and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py

On a 2-layer model of Llama-3-8B's widths with 16 slots, in ``w4``,
``w4a8`` and ``w8``: a replayed chunk gives the eager chunk's tokens, carry
and every cache byte, and replayed admissions the eager admissions' first
tokens and cache bytes; ``run_pipelined`` gives the step engine's tokens
for every request; a chunk graph captured by ``warm_admission`` serves
traffic after admissions that set the carry and caches in place, with no
second capture.
"""
import dataclasses

import pytest
import torch

from aimet_tpu_torch.models.transformer import TransformerConfig
from aimet_tpu_torch.serving import quantized_llm as qllm
from aimet_tpu_torch.serving.batcher import ContinuousBatcher

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
SLOTS, CHUNK, MAX_LEN = 16, 4, 256


@pytest.fixture(scope="module")
def weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    made = {}

    def get(mode):
        kind = "w8" if mode == "w8" else "w4"       # w4a8 serves w4 weights
        if kind not in made:
            made[kind] = qllm.random_quantized_weights(CFG, mode=kind,
                                                       seed=0)
        return qllm.QuantizedLLM.from_quantized(made[kind], CFG, mode=mode,
                                                max_len=MAX_LEN)
    return get


def _requests(n, seed):
    g = torch.Generator().manual_seed(seed)
    draw = lambda lo, hi, k: torch.randint(lo, hi, (k,), generator=g).tolist()
    return [(draw(0, CFG.vocab_size, m), k)
            for m, k in zip(draw(8, 97, n), draw(4, 25, n))]


def _serve(llm, reqs, pipelined, use_native=True):
    b = ContinuousBatcher(llm, num_slots=SLOTS, step_chunk=CHUNK,
                          use_native=use_native)
    out = [b.submit(p, max_new_tokens=k) for p, k in reqs]
    steps = b.run_pipelined(500) if pipelined else b.run_until_done(500)
    assert all(r.done for r in out) and steps > 0
    assert [len(r.generated) for r in out] == [k for _, k in reqs]
    return [r.generated for r in out], b


@pytest.mark.parametrize("mode", ["w4", "w4a8", "w8"])
def test_replayed_chunk_equals_eager_chunk(weights, mode):
    llm = weights(mode)
    b = ContinuousBatcher(llm, num_slots=SLOTS, step_chunk=CHUNK)
    b._ensure_carry()
    reqs = _requests(SLOTS, 1)
    b._admit_carry(list(range(SLOTS)), [p for p, _ in reqs])
    tok, pos, out, _ = b._carry
    caches = [dataclasses.replace(c, k=c.k.clone(), v=c.v.clone())
              for c in b.caches]
    want_tok, want_pos = tok.clone(), pos.clone()
    want = torch.empty_like(out)
    b._chunk_steps(want_tok, want_pos, want, caches)
    b._chunk_carry()                            # captures, then one replay
    assert b._graph is not None and b.chunk_replays == 1
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(tok, want_tok) and torch.equal(pos, want_pos)
    for c, w in zip(b.caches, caches):
        assert torch.equal(c.k, w.k) and torch.equal(c.v, w.v)


@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_replayed_admission_equals_eager_admission(weights, mode):
    """The same prompts admitted eagerly (the step engine's admission) and
    by admission graphs (the pipelined engine's; lengths 8-96 take three
    padded lengths): first tokens and every cache byte equal."""
    llm = weights(mode)
    prompts = [p for p, _ in _requests(SLOTS, 4)]
    eager = ContinuousBatcher(llm, num_slots=SLOTS, step_chunk=CHUNK)
    eager._admit(list(range(SLOTS)), prompts)
    graphs = ContinuousBatcher(llm, num_slots=SLOTS, step_chunk=CHUNK)
    graphs._ensure_carry()
    graphs._admit_carry(list(range(SLOTS)), prompts)
    torch.cuda.synchronize()
    assert graphs.admission_replays == SLOTS
    assert len(graphs._admit_graphs) == len(
        {graphs._padded_len(len(p)) for p in prompts}) > 1
    assert torch.equal(eager._firsts, graphs._firsts)
    tok, pos, _, _ = graphs._carry
    assert torch.equal(tok[:, 0], graphs._firsts)
    assert pos.tolist() == [len(p) for p in prompts]
    for a, b in zip(eager.caches, graphs.caches):
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("mode", ["w4", "w4a8", "w8"])
def test_chunk_past_the_cache_writes_nothing(weights, mode):
    """A freed slot keeps decoding for a chunk, and its positions may pass
    the cache: a replayed chunk at positions S - 2 .. S + 13 (K3, and in
    ``w4`` KFL, which reads no cache) writes only the rows inside it, and
    its tokens stay in the vocabulary."""
    llm = weights(mode)
    b = ContinuousBatcher(llm, num_slots=SLOTS, step_chunk=CHUNK)
    b._ensure_carry()
    b._admit_carry(list(range(SLOTS)), [p for p, _ in _requests(SLOTS, 5)])
    tok, pos, out, _ = b._carry
    pos.copy_(torch.arange(SLOTS, dtype=torch.int32, device=pos.device)
              + MAX_LEN - 2)
    before = [(c.k.clone(), c.v.clone()) for c in b.caches]
    b._chunk_carry()
    torch.cuda.synchronize()
    assert ((out >= 0) & (out < CFG.vocab_size)).all()
    for (k0, v0), c in zip(before, b.caches):
        assert torch.equal(c.k[:, :MAX_LEN - 2], k0[:, :MAX_LEN - 2])
        assert torch.equal(c.k[2:], k0[2:]) and torch.equal(c.v[2:], v0[2:])


@pytest.mark.parametrize("mode", ["w4", "w4a8", "w8"])
def test_pipelined_tokens_equal_the_step_engine(weights, mode):
    reqs = _requests(24, 2)
    llm = weights(mode)
    want, _ = _serve(llm, reqs, pipelined=False)
    got, b = _serve(llm, reqs, pipelined=True)
    assert got == want
    assert b.chunk_replays > 0 and b.admission_replays == len(reqs)


def test_warm_graph_survives_admissions(weights):
    """warm_admission captures the chunk; traffic then replays that graph
    after admissions that rewrite the carry and caches in place."""
    reqs = _requests(24, 3)
    llm = weights("w4a8")
    want, _ = _serve(llm, reqs, pipelined=False, use_native=False)
    b = ContinuousBatcher(llm, num_slots=SLOTS, step_chunk=CHUNK)
    b.warm_admission(prompt_len=64, pipelined=True)
    graph, replays = b._graph, b.chunk_replays
    assert graph is not None and replays == 1 and len(b._admit_graphs) == 1
    out = [b.submit(p, max_new_tokens=k) for p, k in reqs]
    b.run_pipelined(500)
    assert b._graph is graph and b.chunk_replays > replays
    assert [r.generated for r in out] == want
