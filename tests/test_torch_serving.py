"""The serving slice of aimet_tpu_torch against aimet_tpu on the CPU (the
port's plain versions; the JAX package's XLA paths), on the same weights:

- ``w4a8`` on TransformerConfig.tiny() in f32, where decode runs per op;
- ``w4`` and ``w8`` on a 2-layer model of d_model 1024 (``WIDE``), where
  the port's ``w4`` decode takes the whole-layer kernels' plain versions
  (one ``sol_decode_layer`` per layer at a scalar position, attention +
  ``fused_wo_mlp`` with per-slot positions) and the JAX package (off the
  TPU) runs per op.

Tolerances: weight trees byte for byte; f32 logits at rtol/atol 1e-4 and
cache bytes equal (on the wide model, each KV write held to the JAX
package's: the port's K and V within ``KV_DRIFT`` of JAX's, a one-level
code difference only where the two straddle a rounding boundary, and both
packages then on the same caches);
bf16 logits within 5e-2 of their max; greedy tokens of generate and of
the continuous batcher equal (f32).
"""
import functools

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


# Largest difference allowed between the port's and the JAX package's K
# and V before quantization, in code units (x * (1 / scale)): 1e-2 of a
# level, i.e. 7.9e-5 of the head's absmax, tighter than the 1e-4 that
# holds the logits. Two correct f32 runs differ there only by rounding
# (torch's CPU sgemm and XLA's dot sum the QKV product in different
# orders, rope's differences of products amplify it): at most 2.8e-4 of a
# level on this model, measured with 1 to 8 threads and with MKL's and
# ATen's AVX512, AVX2, SSE4.2 and default code paths, 35x below the limit.
# A code may then differ from the JAX package's by one level only where a
# rounding boundary lies between the two values.
KV_DRIFT = 1e-2


def _record_jax_kv_writes(monkeypatch, records):
    """Wrap the JAX package's KV writes so that each call's inputs (k, v)
    and the cache it leaves reach ``records`` in call order (host
    callbacks inside jit)."""
    def wrap(kind, fn):
        def write(cache, k, v, *args, **kw):
            new = fn(cache, k, v, *args, **kw)
            jax.debug.callback(
                lambda *a: records.append((kind,) + tuple(map(np.array, a))),
                k, v, new.k, new.v, new.k_scale, new.v_scale, ordered=True)
            return new
        return write

    monkeypatch.setattr(jq, "prefill_kv", wrap("prefill", jq.prefill_kv))
    monkeypatch.setattr(jq, "append_kv", wrap("append", jq.append_kv))


def _placed(shape, t, kind, args):
    """The (B, T, KH, D) values ``t`` where a KV write of ``kind`` with
    ``args`` puts its rows in a (B, S, KH, D) cache; NaN elsewhere."""
    full = np.full(shape, np.nan, np.float32)
    B, T = t.shape[:2]
    if kind == "prefill":
        start = args[0] if args else 0
        full[:, start:start + T] = t
        return full
    idx = np.asarray(args[0])
    if idx.ndim == 0:
        i = min(max(int(idx), 0), shape[1] - T)
        full[:, i:i + T] = t
        return full
    for b in range(B):
        if 0 <= idx[b] <= shape[1] - T:
            full[b, idx[b]:idx[b] + T] = t[b]
    return full


def _kv_reference(kind, x, scale):
    """The KV quantizer's formula in numpy f32 (IEEE division, round half
    to even): a prefill fixes scale = max(amax, 1e-8) / 127 per (row, kv
    head), an append uses the cache's; codes = clip(rint(x * (1 / scale)),
    -127, 127)."""
    if kind == "prefill":
        scale = np.maximum(np.abs(x).max(axis=(1, 3)),
                           np.float32(1e-8)) / np.float32(127)
    r = (np.float32(1) / scale)[:, None, :, None]
    return np.clip(np.rint(x * r), -127, 127), scale


def _hold_kv_writes_to_jax(monkeypatch, records):
    """Hold each KV write of the port to the JAX package's write of the
    same layer and step (``records``), then give the port the JAX cache,
    so that both packages run on from the same caches:

    1. the port's write on the JAX package's k and v equals the formula
       in numpy (``_kv_reference``), codes and scales bit for bit (the
       JAX package's own prefill scale may be an ulp off that: XLA's CPU
       fusion of amax / 127 is not always an IEEE division, ROADMAP queue
       C);
    2. the port's own k and v lie within ``KV_DRIFT`` of the JAX
       package's in code units, and its write gives the JAX package's
       codes except one level where a rounding boundary lies between the
       two values of k * (1 / scale);
    3. the cache then takes the JAX package's codes and scales."""
    from aimet_tpu_torch.ops import decode_attention_fused as tdaf
    from aimet_tpu_torch.ops.kv_cache import QuantizedKVCache

    pending = iter(records)
    fields = ("k", "v", "k_scale", "v_scale")

    def wrap(kind, fn):
        def write(cache, k, v, *args, **kw):
            jkind, jk, jv, jck, jcv, jks, jvs = next(pending)
            assert jkind == kind and kw.get("lengths") is None
            want = dict(zip(fields, (jck, jcv, jks, jvs)))
            before = {f: getattr(cache, f).clone() for f in fields}
            pos = [a.numpy() if isinstance(a, torch.Tensor) else a
                   for a in args]
            scratch = QuantizedKVCache(*(before[f].clone() for f in fields))
            fn(scratch, torch.from_numpy(jk), torch.from_numpy(jv), *args,
               **kw)
            for f, x in (("k", jk), ("v", jv)):
                codes, scale = _kv_reference(
                    kind, x, before[f + "_scale"].numpy())
                placed = _placed(before[f].shape, codes, kind, pos)
                np.testing.assert_array_equal(
                    getattr(scratch, f).numpy(),
                    np.where(np.isnan(placed), before[f].numpy(), placed))
                np.testing.assert_array_equal(
                    getattr(scratch, f + "_scale").numpy(), scale)
            fn(cache, k, v, *args, **kw)
            for f, x, jx, js in (("k", k, jk, jks), ("v", v, jv, jvs)):
                got = getattr(cache, f).numpy().astype(np.int32)
                own = getattr(cache, f + "_scale").numpy()
                tj, tp = (_placed(got.shape, a * (np.float32(1) / sc)[
                    :, None, :, None], kind, pos)
                    for a, sc in ((jx, js), (x.float().numpy(), own)))
                live = ~np.isnan(tj)
                drift = np.abs(tp - tj)
                assert drift[live].max() <= KV_DRIFT, (f, drift[live].max())
                flip = got != want[f]
                assert live[flip].all(), f"{f}: write outside its rows"
                assert (np.abs(got[flip] - want[f][flip]) == 1).all(), f
                edge = np.abs(tj - (np.floor(tj) + 0.5))[flip]
                assert (edge <= drift[flip] + 2 * np.spacing(
                    np.abs(tj[flip]))).all(), (
                    f"{f}: codes differ away from a rounding boundary")
            for f in fields:
                getattr(cache, f).copy_(torch.from_numpy(want[f]))
            return cache
        return write

    monkeypatch.setattr(tq, "prefill_kv", wrap("prefill", tq.prefill_kv))
    monkeypatch.setattr(tdaf, "append_kv", wrap("append", tdaf.append_kv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w4", "w8"])
def test_wide_forward_matches_jax(wide, mode, dtype, monkeypatch):
    """Prefill, then decode at a shared and at per-slot positions. In f32
    every KV write is held to the formula on the JAX package's inputs and
    to the JAX package's codes on the port's own (one level apart only
    where the two values straddle a rounding boundary, see ``KV_DRIFT``) and both packages run on from the JAX
    caches, so the logits hold at 1e-4 though a near-tie code flip alone
    moves them by ~2e-2. bf16 logits within 5e-2 of their max."""
    jcfg, jllm, tllm = wide[mode, dtype]
    jpre, jdec = jllm._prefill, jllm._decode
    if dtype == "float32":
        records = []
        _record_jax_kv_writes(monkeypatch, records)
        _hold_kv_writes_to_jax(monkeypatch, records)
        # fresh jits, traced with the recording writes
        jpre, jdec = (jax.jit(functools.partial(
            jq.quantized_forward, prefill=p, mode=mode),
            static_argnames=("cfg",)) for p in (True, False))
    rs = np.random.RandomState(3)
    B, T = 3, 6
    toks = rs.randint(0, VOCAB, (B, T))
    jc = [j_init(B, 32, jcfg.n_kv_heads, jcfg.head_dim)
          for _ in range(jcfg.n_layers)]
    tc = tllm.new_caches(B)
    jl, jc = jpre(jllm.qw, jcfg, jnp.asarray(toks), jc, 0)
    jax.effects_barrier()
    tl, tc = tllm.prefill(torch.from_numpy(toks), tc)
    _close(tl, jl, dtype)
    nxt = rs.randint(0, VOCAB, (B, 1))
    for idx in (T, np.asarray([T, T - 2, T + 3], np.int32)):
        jl, jc = jdec(jllm.qw, jcfg, jnp.asarray(nxt), jc,
                      jnp.asarray(idx, jnp.int32))
        jax.effects_barrier()
        tl, tc = tllm.decode(torch.from_numpy(nxt), tc,
                             idx if np.ndim(idx) == 0 else
                             torch.from_numpy(idx))
        _close(tl, jl, dtype)
        if dtype == "float32":
            for a, b in zip(jc, tc):
                np.testing.assert_array_equal(b.k.numpy(), np.asarray(a.k))
                np.testing.assert_array_equal(b.v.numpy(), np.asarray(a.v))
    if dtype == "float32":
        assert len(records) == 3 * jcfg.n_layers     # every write held


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
