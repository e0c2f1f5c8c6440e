"""AMP, AutoQuant and the float-layer rule of ``lower_to_int`` in
aimet_tpu_torch against the JAX package, on the same numpy-made weights
and inputs (``device="cpu"``; the JAX models of tests/test_ptq.py and
their port copies, tests/torch_ptq_util.py).

- ``lower_to_int(mode="auto")`` leaves a layer whose parameter quantizer
  was set to ``float`` on the float path, as the JAX lowering does: the
  same ``lowered_ops`` / ``skipped_ops`` / ``downgraded_ops``, outputs
  within 1e-5 of the JAX output's max (static INT8 codes from the same
  encodings: tests/test_torch_lowering.py's bound), for a float-assigned
  linear (TinyMLP) and conv (TinyCNN).
- Quantizer groups identical, by name, on TinyMLP, TinyCNN and a
  two-block ResNet; on TransformerConfig.tiny() the groups that carry
  parameters are the same sets of parameters (the JAX graph shares the
  silu / where quantizers across layers, so its activation-only groups
  are fewer and its op names shift: see test_torch_quantsim.py).
- ``choose_mixed_precision``: every eval of the run (baseline, phase 1,
  phase 2 flips; each a -MSE against the float output) within
  SCORE_RTOL |score| + SCORE_ATOL of the JAX run's (each sim calibrated
  on its own, min-max, on the same batches; measured: 3.3e-4 |score| at
  most, 4.8e-9 absolute); the phase-1 order is only as steady as the
  gaps between neighbouring scores, so the test first asserts that every
  neighbouring pair is either an exact tie in both packages (the same
  configuration evaluated twice: a group without parameters under two
  candidates that differ only in the parameter bitwidth) or further apart
  than the tolerance, and that every phase-2 decision clears the
  accuracy budget by more than it; then the final assignment and the
  pareto front's costs are equal and its accuracies within the tolerance;
  ``reduce_convert_ops`` gives equal converts_before / after, cost_ratio
  and assignment.
- AutoQuantWithAutoMixedPrecision on TinyCNN (4-bit weights, AdaRound at
  one iteration, AMP candidates 8/8 > 8/4), the JAX package's once and the
  port's cold and then warm on one cache directory: the same stages and
  best stage, each PTQ stage's accuracy within STAGE_TOL of its |value|,
  relative (measured: 5e-7); the AMP stage's evals within the AMP score
  tolerance and the same assignment; the warm run optimizes no AdaRound
  layer, equalizes nothing, evaluates only the AdaRound and AMP stages (as
  the JAX package does), calibrates the rebuilt sim AMP runs on once
  more (auto_quant.py:243) and gives the cold run's history, encodings
  and weights bit for bit (tests/test_amp_autoquant_analyzer.py's
  TestAutoQuantWithAmp); the diagnostics text and HTML are the JAX
  package's, character for character, on the same history.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.algorithms import amp as jamp
from aimet_tpu.algorithms import auto_quant as jaq
from aimet_tpu.algorithms.adaround import AdaroundParameters as JaxAdaParams
from aimet_tpu.quantsim.lowering import lower_to_int as jax_lower
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, convert, lower_to_int
from aimet_tpu_torch.algorithms import adaround as tada
from aimet_tpu_torch.algorithms import amp as tamp
from aimet_tpu_torch.algorithms import auto_quant as taq
from torch_ptq_util import nchw, one_thread, pair  # noqa: F401
from torch_quantsim_util import tiny_numpy_pair, to_torch

SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-8     # AMP evals (-MSE)
STAGE_TOL = 1e-5      # AutoQuant stage accuracies: relative
LOWER_TOL = 1e-5      # lowered outputs: / max |JAX|
LISTS = ("lowered_ops", "skipped_ops", "downgraded_ops", "op_modes")


def _sims(name, **kw):
    """Both packages' min-max sims of torch_ptq_util MODELS[name], each
    calibrated on the same two numpy batches."""
    fn, v, tm, x, rs = pair(name)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    batches = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax", **kw)
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              device="cpu", **kw)
    ts.compute_encodings(None, [nchw(b) for b in batches])
    return fn, jv, js, tm, ts, batches


# ---------------------------------------------------------------------------
# lower_to_int leaves float-assigned layers on the float path
# ---------------------------------------------------------------------------

def _float_case(kind):
    """Both sims of TinyMLP or TinyCNN, the port's on the JAX encodings,
    and the parameter set to float."""
    model, param = {"linear": ("tiny_mlp", "Dense_0.kernel"),
                    "conv": ("tiny_cnn", "Conv_1.kernel")}[kind]
    fn, jv, js, tm, ts, batches = _sims(model)
    for k, e in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, e)
    return (js, ts, jv, param, jnp.asarray(batches[0]), nchw(batches[0]))


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_lower_to_int_skips_float_assigned_layers(kind):
    js, ts, jp, name, jx, tx = _float_case(kind)
    js.set_quantizer_data_type(convert.jax_param_key(name), "float", 16)
    ts.set_quantizer_data_type(name, "float", 16)
    jl = jax_lower(js, jp, mode="auto", use_pallas=False)
    tl = lower_to_int(ts, None, mode="auto")
    for f in LISTS:
        assert getattr(tl, f) == getattr(jl, f), f
    skipped = "linear_0" if kind == "linear" else "conv_1"
    assert skipped in tl.skipped_ops and skipped not in tl.lowered_ops
    assert tl.lowered_ops, "the other layers lower"
    want = np.asarray(jax.jit(lambda p, x: jl(p, x))(jp, jx))
    got = tl(ts.params, tx).detach().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= LOWER_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# AMP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny_mlp", "tiny_cnn", "resnet_basic"])
def test_quantizer_groups_match_jax(name):
    fn, v, tm, x, rs = pair(name)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax")
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              device="cpu")
    want = [(g.name, g.act_quantizers,
             [convert.port_param_name(p) for p in g.param_quantizers])
            for g in jamp.find_quantizer_groups(js)]
    got = [(g.name, g.act_quantizers, g.param_quantizers)
           for g in tamp.find_quantizer_groups(ts)]
    assert got == want
    # every parameter quantizer in exactly one group
    params = [p for _, _, ps in got for p in ps]
    assert sorted(params) == sorted(
        n for n, s in ts.quantizers.items() if s.kind == "param")


def test_quantizer_groups_on_the_transformer_match_jax():
    fn, jv, tm, tok, _ = tiny_numpy_pair()
    js = JaxSim(fn, (jv, jnp.asarray(tok)), quant_scheme="minmax")
    ts = QuantizationSimModel(tm, (to_torch(tok),), quant_scheme="minmax",
                              device="cpu")
    jg, tg = jamp.find_quantizer_groups(js), tamp.find_quantizer_groups(ts)

    def with_params(groups, rename=lambda p: p):
        return [(bool(g.act_quantizers),
                 tuple(rename(p) for p in g.param_quantizers))
                for g in groups if g.param_quantizers]
    # the same parameters grouped together, in the same order, each
    # behind an activation quantizer (or none) alike
    assert with_params(tg) == with_params(jg, convert.port_param_name)
    assert len(with_params(tg)) == 15
    # the JAX graph shares two silu / where quantizers a layer: 3 fewer
    # activation-only groups on two layers
    assert len(tg) - len(jg) == 3


def _eval_pair(fn, jv, batches):
    """-MSE of each package's forward against the JAX float output, and
    the lists of every score each one returned, in order."""
    ref = np.asarray(fn(jv, jnp.asarray(batches[0])))
    jscores, tscores = [], []

    def jeval(forward):
        s = -float(np.mean((np.asarray(
            forward(jnp.asarray(batches[0]))) - ref) ** 2))
        jscores.append(s)
        return s

    def teval(forward):
        out = forward(nchw(batches[0])).numpy()
        if out.ndim == 4:
            out = out.transpose(0, 2, 3, 1)
        s = -float(np.mean((out - ref) ** 2))
        tscores.append(s)
        return s
    return jeval, teval, jscores, tscores


def _cands(mod, name):
    """Float 16 against 8-bit activations and 4-bit weights where the
    convert-op pass has boundaries to remove (the ResNet); 8-bit weights
    against 4 elsewhere."""
    if name == "resnet_basic":
        return [mod.fp16_candidate(), mod.Candidate(8, 4)]
    return [mod.Candidate(8, 8), mod.Candidate(8, 4)]


def _same_cand(a, b):
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def _tol(s):
    return SCORE_RTOL * abs(s) + SCORE_ATOL


def _assert_same_amp_run(jr, jscores, tscores, drop):
    """``jscores`` / ``tscores``: each package's AMP evals in order (the
    baseline, phase 1, phase 2). The greedy order must be decided by gaps
    the two packages' rounding cannot swap, no phase-2 decision may sit
    within the tolerance of the budget, and every eval agrees."""
    n1 = len(jr.phase1_scores)
    j1, t1 = np.asarray(jscores[1:1 + n1]), np.asarray(tscores[1:1 + n1])
    order = np.argsort(-j1, kind="stable")
    for a, b in zip(order, order[1:]):
        tie = j1[a] == j1[b] and t1[a] == t1[b]
        gap = _tol(j1[a]) + _tol(j1[b])
        assert tie or (j1[a] - j1[b] > gap and t1[a] - t1[b] > gap), \
            f"phase-1 scores {j1[a]}, {j1[b]} closer than {gap}: the " \
            "greedy order is not determined"
    for s in jscores[1 + n1:]:
        assert abs((jr.baseline_accuracy - s) - drop) > \
            _tol(s) + _tol(jr.baseline_accuracy), s
    assert len(tscores) == len(jscores)
    for s_t, s_j in zip(tscores, jscores):
        assert abs(s_t - s_j) <= _tol(s_j), (s_t, s_j)


def _assert_same_assignment(tr, jr):
    assert set(tr.group_bitwidths) == set(jr.group_bitwidths)
    for g, c in jr.group_bitwidths.items():
        assert _same_cand(tr.group_bitwidths[g], c), g


# accuracy budgets: each admits some flips and refuses others
AMP_CASES = {"tiny_mlp": 2e-3, "tiny_cnn": 5e-3, "resnet_basic": 1e-3}


@pytest.mark.parametrize("name", list(AMP_CASES))
def test_amp_matches_jax(name):
    drop = AMP_CASES[name]
    fn, jv, js, tm, ts, batches = _sims(name)
    jeval, teval, jscores, tscores = _eval_pair(fn, jv, batches)
    jr = jamp.choose_mixed_precision(js, jv, _cands(jamp, name), jeval, drop)
    tr = tamp.choose_mixed_precision(ts, None, _cands(tamp, name), teval, drop)
    _assert_same_amp_run(jr, jscores, tscores, drop)

    jkeys = {(g, dataclasses.astuple(c)): s
             for (g, c), s in jr.phase1_scores.items()}
    tkeys = {(g, dataclasses.astuple(c)): s
             for (g, c), s in tr.phase1_scores.items()}
    assert list(tkeys) == list(jkeys)
    _assert_same_assignment(tr, jr)
    assert [c for c, _ in tr.pareto_front] == [c for c, _ in jr.pareto_front]
    for (_, a), (_, b) in zip(tr.pareto_front, jr.pareto_front):
        assert abs(a - b) <= _tol(b)
    flipped = {dataclasses.astuple(c) for c in tr.group_bitwidths.values()}
    assert len(flipped) > 1, "the budget admits some flips, not all"

    jo = jamp.reduce_convert_ops(js, jr, _cands(jamp, name))
    to = tamp.reduce_convert_ops(ts, tr, _cands(tamp, name))
    assert (to.converts_before, to.converts_after) == \
        (jo.converts_before, jo.converts_after)
    assert to.cost_ratio == jo.cost_ratio
    assert {g: dataclasses.astuple(c) for g, c in to.assignment.items()} == \
        {g: dataclasses.astuple(c) for g, c in jo.assignment.items()}
    for name_q, spec in ts.quantizers.items():
        jspec = js.quantizers[name_q if spec.kind != "param"
                              else convert.jax_param_key(name_q)]
        assert (spec.bitwidth, spec.data_type) == \
            (jspec.bitwidth, jspec.data_type), name_q


def test_count_convert_ops_walks_input_ops():
    """A boundary is a producer -> consumer edge between different act
    precisions; ops without their own act precision inherit the
    producer's (through ``Op.input_ops``)."""
    fn, v, tm, x, _ = pair("resnet_basic")
    js = JaxSim(fn, (jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x)))
    ts = QuantizationSimModel(tm, (nchw(x),), device="cpu")
    acts = [n for n, s in ts.quantizers.items()
            if s.kind != "param" and n in {op.name for op in ts.graph.ops}]
    for k in range(len(acts) + 1):
        bw = {n: (16 if i < k else 8) for i, n in enumerate(acts)}
        assert tamp._count_convert_ops(ts, bw) == \
            jamp._count_convert_ops(js, bw)


# ---------------------------------------------------------------------------
# AutoQuant
# ---------------------------------------------------------------------------

AQ_DROP = 1e-6     # unmet by every PTQ stage: the AMP stage runs
AQ_STAGES = ["fp32", "quantsim", "cle", "adaround", "amp"]


@pytest.fixture(scope="module")
def autoquant_runs(tmp_path_factory):
    """AutoQuantWithAutoMixedPrecision on TinyCNN (4-bit weights, AMP
    candidates 8/8 > 8/4): the JAX package's once, the port's twice on one
    cache directory, cold and then warm, with the port's AdaRound layer
    optimizations, equalizations, calibrations (the sims
    ``compute_encodings`` ran on) and both packages' AMP runs (result,
    sim, evals before it) recorded. AdaRound at one iteration rounds as
    the quantsim stage does, which stays the best PTQ stage (CLE scores
    lower here), so AMP runs on the quantsim stage's sim: on the warm run
    a sim rebuilt from the stored encodings, which ``compute_encodings``
    calibrates again before AMP (auto_quant.py:243)."""
    fn, v, tm, x, rs = pair("tiny_cnn")
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    batches = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    jeval, teval, jscores, tscores = _eval_pair(fn, jv, batches)
    kw = dict(quant_scheme="minmax", default_param_bw=4)
    cache_dir = str(tmp_path_factory.mktemp("autoquant"))
    rec = {"amp": [], "calibrated": [], "adaround": 0, "equalize": 0}
    mp = pytest.MonkeyPatch()

    def capture(mod, scores):
        real = mod.choose_mixed_precision

        def run(sim, *a, **k):
            n = len(scores)
            r = real(sim, *a, **k)
            rec["amp"].append((r, sim, n))
            return r
        mp.setattr(mod, "choose_mixed_precision", run)

    def count(obj, attr, key):
        real = getattr(obj, attr)

        def counted(*a, **k):
            if key == "calibrated":
                rec[key].append(a[0])
            else:
                rec[key] += 1
            return real(*a, **k)
        mp.setattr(obj, attr, counted)
    capture(jamp, jscores)
    capture(tamp, tscores)
    count(tada._RoundingOptimizer, "run", "adaround")
    count(taq, "equalize_model", "equalize")
    count(QuantizationSimModel, "compute_encodings", "calibrated")

    jr = jaq.AutoQuantWithAutoMixedPrecision(
        fn, (jv, jnp.asarray(x)), jv, [jnp.asarray(b) for b in batches],
        jeval, adaround_params=JaxAdaParams(num_batches=2, num_iterations=1),
        amp_candidates=_cands(jamp, "tiny_cnn"), **kw
    ).optimize(allowed_accuracy_drop=AQ_DROP)
    out = {"jax": (jr, rec["amp"][-1], list(jscores)), "port": []}
    for _ in range(2):                              # cold, then warm
        for k in ("adaround", "equalize"):
            rec[k] = 0
        rec["calibrated"].clear()
        t0 = len(tscores)
        aq = taq.AutoQuantWithAutoMixedPrecision(
            tm, (nchw(x),), None, [nchw(b) for b in batches], teval,
            adaround_params=tada.AdaroundParameters(num_batches=2,
                                                    num_iterations=1),
            amp_candidates=_cands(tamp, "tiny_cnn"), cache_dir=cache_dir,
            device="cpu", **kw)
        tr = aq.optimize(allowed_accuracy_drop=AQ_DROP)
        out["port"].append(dict(
            aq=aq, result=tr, amp=rec["amp"][-1], scores=tscores[t0:],
            adaround=rec["adaround"], equalize=rec["equalize"],
            calibrated=list(rec["calibrated"])))
    mp.undo()
    out["cache_files"] = {p.name for p in pathlib.Path(cache_dir).iterdir()}
    return out


def test_autoquant_matches_jax_and_resumes_from_its_cache(autoquant_runs):
    """The stages, best stage and stage accuracies (within STAGE_TOL of
    |value|, relative) are the JAX run's; the warm run optimizes no
    AdaRound layer, equalizes nothing, evaluates only the AdaRound stage
    and the AMP stage (as the JAX package does), and gives the cold run's
    history, encodings and weights bit for bit."""
    jr = autoquant_runs["jax"][0]
    cold, warm = autoquant_runs["port"]
    r1, r2 = cold["result"], warm["result"]
    assert [s.name for s in r1.history] == [s.name for s in jr.history] \
        == AQ_STAGES
    assert r1.best_stage == jr.best_stage == "amp"
    for a, b in zip(r1.history[1:4], jr.history[1:4]):
        assert abs(a.accuracy - b.accuracy) <= STAGE_TOL * abs(b.accuracy)
    assert abs(r1.history[0].accuracy) <= STAGE_TOL * abs(
        jr.history[1].accuracy)
    # one AdaRound iteration rounds as the quantsim stage does: the tie
    # that leaves the quantsim stage the best PTQ stage, in both
    for h in (jr.history, r1.history):
        assert h[3].accuracy == h[1].accuracy > h[2].accuracy

    assert cold["adaround"] > 0 and cold["equalize"] == 1
    assert (warm["adaround"], warm["equalize"]) == (0, 0)
    n_amp = len(warm["scores"]) - 1
    assert len(cold["scores"]) - n_amp == 4     # fp32, quantsim, CLE, Ada
    assert [(s.name, s.accuracy) for s in r2.history] == \
        [(s.name, s.accuracy) for s in r1.history]
    assert r2.best_stage == r1.best_stage
    assert r2.sim.export_encodings() == r1.sim.export_encodings()
    assert r2.params.keys() == r1.params.keys()
    for k in r1.params:
        assert torch.equal(r2.params[k], r1.params[k]), k
    names = autoquant_runs["cache_files"]
    assert {"autoquant.fp32_eval.pkl", "autoquant.quantsim.pkl",
            "autoquant.cle.pkl", "autoquant.cle_eval.pkl"} <= names
    assert any(n.startswith("autoquant.ada.") for n in names)


def test_autoquant_with_amp_runs_amp_when_target_unmet(autoquant_runs):
    """The AMP stage runs in both packages when no PTQ stage meets the
    target: its evals within the AMP score tolerance of the JAX run's (the
    greedy order decided, as in test_amp_matches_jax), the same
    assignment, its accuracy above every PTQ stage's. It runs on the
    quantsim stage's sim, which the cold run calibrated once, and the warm
    run, having rebuilt it from the cache, calibrated once again before
    AMP (TestAutoQuantWithAmp, tests/test_amp_autoquant_analyzer.py)."""
    jr, (jamp_r, _, jn), jscores = autoquant_runs["jax"]
    cold, warm = autoquant_runs["port"]
    for run in (cold, warm):
        tr, (tamp_r, amp_sim, _) = run["result"], run["amp"]
        assert tamp_r is run["aq"].amp_result
        assert tr.history[-1].name == "amp" and tr.best_stage == "amp"
        assert tr.accuracy > max(s.accuracy for s in tr.history[1:-1])
        assert abs(tr.accuracy - jr.accuracy) <= _tol(jr.accuracy)
        n_amp = len(jscores) - jn
        _assert_same_amp_run(jamp_r, jscores[jn:], run["scores"][-n_amp:],
                             AQ_DROP)
        _assert_same_assignment(tamp_r, jamp_r)
        assert sum(c is amp_sim for c in run["calibrated"]) == 1
    # cold: the quantsim and CLE stages' sims, the AdaRound stage's sim
    # before and after AdaRound; warm: the AdaRound stage's two and the
    # rebuilt quantsim stage's sim before AMP
    assert (len(cold["calibrated"]), len(warm["calibrated"])) == (4, 3)
    assert cold["amp"][1] is cold["result"].sim
    assert warm["amp"][1] is warm["result"].sim


def test_diagnostics_match_jax(tmp_path):
    history = [("fp32", 0.91, False), ("quantsim", 0.85, True),
               ("cle", 0.88, True), ("adaround", 0.9, True)]
    jres = jaq.AutoQuantResult(
        "adaround", 0.9, None, None,
        [jaq.StageResult(*h) for h in history])
    tres = taq.AutoQuantResult(
        "adaround", 0.9, None, None,
        [taq.StageResult(*h) for h in history])
    assert tres.diagnostics() == jres.diagnostics()
    a = jres.export_diagnostics(str(tmp_path / "j.html"))
    b = tres.export_diagnostics(str(tmp_path / "t.html"))
    assert open(b).read() == open(a).read()
    assert "AutoQuant diagnostics" in open(b).read()
