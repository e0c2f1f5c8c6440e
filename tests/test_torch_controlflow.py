"""Control flow in the graph and the sim of aimet_tpu_torch against the JAX
package (tests/test_controlflow_quantsim.py's intent): ``scan`` / ``while``
/ ``cond`` bodies as inner ops with ``Op.scope``, their quantizers placed,
calibrated per step, applied and exported under the JAX names; QAT
gradients through a scan; a scan over stacked weights; lowering that skips
the scoped ops; DeepSpeech2 through the one sim.

The same numpy-made weights and inputs go through both packages (the port
on the CPU). Encodings, outputs and gradients are held at the tolerances
of tests/test_torch_quantsim.py (rtol 1e-5, atol 1e-6 for f32) unless a
test says otherwise. tests/test_controlflow_quantsim.py's TestNestedJit
has no counterpart: make_fx inlines nested calls, so there is no call
body to inline.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.models.deepspeech import deepspeech2_apply as jax_ds2_apply
from aimet_tpu.quantsim.lowering import lower_to_int as jax_lower_to_int
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu.quantsim.recurrent import lstm_step as jax_lstm_step
from aimet_tpu_torch import convert
from aimet_tpu_torch.graph import control_flow as cf
from aimet_tpu_torch.models.deepspeech import DeepSpeech2, LSTMCell
from aimet_tpu_torch.quantsim.lowering import lower_to_int
from aimet_tpu_torch.quantsim.qsim import QuantizationSimModel
from aimet_tpu_torch.quantsim.recurrent import lstm_step

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _name(k):
    return convert.port_param_name(k)


def _graph_rows(graph):
    return [(op.name, op.type, op.scope) for op in graph.ops]


def _subgraphs(graph):
    return [(v["kind"], [o.name for o in v["inner_ops"]])
            for v in graph.subgraph_eqns.values()]


def _quantizers(sim):
    return [(_name(n), s.kind, s.channel_axis)
            for n, s in sim.quantizers.items()]


def _assert_encodings(jenc, penc, rtol=RTOL, atol=ATOL):
    assert sorted(_name(k) for k in jenc) == sorted(penc)
    for k, e in jenc.items():
        p = penc[_name(k)]
        for f in ("min", "max", "delta", "offset"):
            np.testing.assert_allclose(
                p.__dict__[f].detach().cpu().numpy(), np.asarray(
                    getattr(e, f)), rtol=rtol, atol=atol, err_msg=(k, f))


def _export_keys(exported):
    return {sect: sorted(_name(k) for k in exported[sect])
            for sect in ("activation_encodings", "param_encodings")}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# scan: a single-layer LSTM + linear head
# ---------------------------------------------------------------------------
def jax_lstm_model(params, x):
    B = x.shape[0]
    H = params["cell"]["recurrent_kernel"].shape[0]

    def step(carry, x_t):
        h, c = carry
        h, c = jax_lstm_step(params["cell"], x_t, h, c)
        return (h, c), h

    init = (jnp.zeros((B, H)), jnp.zeros((B, H)))
    _, hs = jax.lax.scan(step, init, jnp.swapaxes(x, 0, 1))
    return jnp.swapaxes(hs, 0, 1) @ params["head"]


class LSTMModel(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.cell = LSTMCell(6, 12)
        self.head = torch.nn.Parameter(_t(params["head"]))
        for k, v in params["cell"].items():
            getattr(self.cell, k).data.copy_(_t(v))

    def forward(self, x):
        B = x.shape[0]
        cell = self.cell.params()

        def step(carry, x_t):
            h, c = carry
            h, c = lstm_step(cell, x_t, h, c)
            return (h, c), h

        zeros = torch.zeros(B, 12, dtype=x.dtype, device=x.device)
        _, hs = cf.scan(step, (zeros, zeros), x.transpose(0, 1))
        return hs.transpose(0, 1) @ self.head


@pytest.fixture(scope="module")
def lstm_pair():
    """Both sims built, calibrated on the same 3 batches, and the JAX
    oracle's forwards, exports and QAT gradients computed once."""
    rng = np.random.RandomState(0)
    params = {"cell": {"kernel": rng.randn(6, 48).astype(np.float32) * 0.3,
                       "recurrent_kernel":
                           rng.randn(12, 48).astype(np.float32) * 0.3,
                       "bias": rng.randn(48).astype(np.float32) * 0.1},
              "head": rng.randn(12, 4).astype(np.float32) * 0.3}
    x = rng.randn(2, 7, 6).astype(np.float32)
    data = [rng.randn(2, 7, 6).astype(np.float32) for _ in range(3)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jsim = JaxSim(jax_lstm_model, (jp, jnp.asarray(x)))
    jsim.compute_encodings(jp, iter([jnp.asarray(d) for d in data]))
    model = LSTMModel(params)
    sim = QuantizationSimModel(model, (_t(x),), device="cpu")
    sim.compute_encodings(None, iter([_t(d) for d in data]))

    apply_fn, enc_params = jsim.qat_fn()

    def loss(p, ep):
        return jnp.sum(apply_fn(p, ep, jnp.asarray(x)) ** 2)

    # the oracles jitted: one compile each, where the eager interpreter
    # compiles every primitive alone
    gp, ge = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, enc_params)
    oracle = {"fp": jax.jit(jsim.fp_fn)(jp, jnp.asarray(x)),
              "q": jax.jit(jsim.quantized_fn)(jp, jnp.asarray(x)),
              "export": jsim.export_encodings(),
              "grad_params": gp, "grad_enc": ge}
    return jsim, sim, x, oracle


def test_scan_lstm_graph_matches_jax(lstm_pair):
    jsim, sim, _, _ = lstm_pair
    assert _graph_rows(sim.graph) == _graph_rows(jsim.graph)
    assert _subgraphs(sim.graph) == _subgraphs(jsim.graph)
    inner = [op.name for op in sim.graph.ops if op.scope == "scan_0"]
    assert any("linear" in n for n in inner)
    assert any("sigmoid" in n for n in inner) and \
        any("tanh" in n for n in inner)
    scan = sim.graph.get_op("scan_0")
    j_scan = jsim.graph.get_op("scan_0")
    assert {k: scan.attrs[k] for k in j_scan.attrs} == j_scan.attrs
    # the LSTM's kernels reach the inner linears across the body boundary
    assert sim.graph.get_op("scan_0/linear_1").param_products[
        "kernel"].param_path == "cell.recurrent_kernel"
    assert [p.name for p in scan.inputs] == ["input1"]


def test_scan_lstm_quantizers_match_jax(lstm_pair):
    jsim, sim, _, _ = lstm_pair
    assert _quantizers(sim) == _quantizers(jsim)
    assert "scan_0" not in sim.quantizers
    inner_acts = [n for n, s in sim.quantizers.items()
                  if s.kind == "act" and n.startswith("scan_0/")]
    assert len(inner_acts) >= 4
    names = {sorted(v)[0]: v for v in sim._sub_act_names.values()}
    assert sorted(sum(names.values(), [])) == sorted(inner_acts)


def test_scan_lstm_calibrate_quantize_export(lstm_pair):
    jsim, sim, x, oracle = lstm_pair
    _assert_encodings(jsim.encodings, sim.encodings)
    _close(sim.fp_fn(None, _t(x)), oracle["fp"])
    q = sim.quantized_fn(None, _t(x))
    _close(q, oracle["q"])
    fp = oracle["fp"]
    err = float(np.linalg.norm(q.numpy() - fp) / np.linalg.norm(fp))
    assert 0 < err < 0.2
    exported = sim.export_encodings()
    assert _export_keys(exported) == _export_keys(oracle["export"])
    assert any(k.startswith("scan_0/")
               for k in exported["activation_encodings"])


def test_scan_lstm_qat_grads_match_jax(lstm_pair):
    """Gradients of sum(qat_fn(...)^2) through the per-step fake-quant:
    to the weights (straight-through) and to every encoding's (min, max)
    (range learning), at rtol 1e-4 / atol 1e-5 (sums over 7 steps of
    gradients whose rounding terms differ by an ulp between XLA and
    PyTorch)."""
    jsim, sim, x, oracle = lstm_pair
    apply_fn, enc_params = sim.qat_fn()
    enc_params = {k: (a.requires_grad_(), b.requires_grad_())
                  for k, (a, b) in enc_params.items()}
    params = {k: v.clone().requires_grad_() for k, v in sim.params.items()}
    (apply_fn(params, enc_params, _t(x)) ** 2).sum().backward()
    gp = oracle["grad_params"]
    for jkey, want in (("cell.kernel", gp["cell"]["kernel"]),
                       ("cell.recurrent_kernel",
                        gp["cell"]["recurrent_kernel"]),
                       ("cell.bias", gp["cell"]["bias"]),
                       ("head", gp["head"])):
        _close(params[jkey].grad, want, rtol=1e-4, atol=1e-5)
    assert float(params["cell.kernel"].grad.abs().sum()) > 0
    ge = oracle["grad_enc"]
    assert sorted(_name(k) for k in ge) == sorted(enc_params)
    total = 0.0
    for k, (gmin, gmax) in ge.items():
        mn, mx = enc_params[_name(k)]
        for got, want in ((mn.grad, gmin), (mx.grad, gmax)):
            got = torch.zeros_like(mn) if got is None else got
            _close(got, want, rtol=1e-4, atol=1e-5)
        if k.startswith("scan_0/"):
            total += float(np.abs(gmin).sum() + np.abs(gmax).sum())
    assert total > 0


def test_scan_lstm_lowering_skips_scoped_ops(lstm_pair):
    jsim, sim, x, _ = lstm_pair
    jp = {"cell": {k: jnp.asarray(v.detach().numpy())
                   for k, v in sim.model.cell.params().items()},
          "head": jnp.asarray(sim.model.head.detach().numpy())}
    want = jax_lower_to_int(jsim, jp, mode="w8")
    got = lower_to_int(sim, mode="w8")
    assert got.lowered_ops == want.lowered_ops == ["linear_0"]
    assert got.skipped_ops == want.skipped_ops
    assert got.skipped_ops == ["scan_0/linear_0", "scan_0/linear_1"]
    _close(got(sim.params, _t(x)), jax.jit(want.__call__)(jp, jnp.asarray(x)),
           rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# scan over stacked weights
# ---------------------------------------------------------------------------
def jax_scanned_mlp(params, x):
    def layer(h, w):
        return jnp.tanh(h @ w), None

    h, _ = jax.lax.scan(layer, x, params["stack"])
    return h @ params["out"]


class ScannedMLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.stack = torch.nn.Parameter(_t(params["stack"]))
        self.out = torch.nn.Parameter(_t(params["out"]))

    def forward(self, x):
        h, _ = cf.scan(lambda h, w: (torch.tanh(h @ w), None), x,
                       self.stack)
        return h @ self.out


def test_scan_over_stacked_weights_matches_jax():
    rng = np.random.RandomState(1)
    params = {"stack": rng.randn(3, 8, 8).astype(np.float32) * 0.4,
              "out": rng.randn(8, 4).astype(np.float32) * 0.4}
    x = rng.randn(5, 8).astype(np.float32)
    data = [rng.randn(5, 8).astype(np.float32) for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jsim = JaxSim(jax_scanned_mlp, (jp, jnp.asarray(x)))
    sim = QuantizationSimModel(ScannedMLP(params), (_t(x),), device="cpu")
    assert _graph_rows(sim.graph) == _graph_rows(jsim.graph)
    assert _quantizers(sim) == _quantizers(jsim)
    assert sim.graph.get_op("scan_0/linear_0").param_products[
        "kernel"].param_path == "stack"
    jsim.compute_encodings(jp, iter([jnp.asarray(d) for d in data]))
    sim.compute_encodings(None, iter([_t(d) for d in data]))
    _assert_encodings(jsim.encodings, sim.encodings)
    q = sim.quantized_fn(None, _t(x))
    _close(q, jax.jit(jsim.quantized_fn)(jp, jnp.asarray(x)))
    fp = sim.fp_fn(None, _t(x))
    assert 0 < float((q - fp).norm() / fp.norm()) < 0.2


# ---------------------------------------------------------------------------
# cond / while
# ---------------------------------------------------------------------------
def jax_cond_model(params, x, flag):
    return jax.lax.cond(flag > 0, lambda h: jnp.tanh(h @ params["w1"]),
                        lambda h: jax.nn.relu(h @ params["w2"]), x)


class CondModel(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.w1 = torch.nn.Parameter(_t(params["w1"]))
        self.w2 = torch.nn.Parameter(_t(params["w2"]))

    def forward(self, x, flag):
        return cf.cond(flag > 0, lambda h: torch.tanh(h @ self.w1),
                       lambda h: torch.relu(h @ self.w2), x)


def test_cond_branch_quantizers_match_jax():
    rng = np.random.RandomState(2)
    params = {"w1": rng.randn(8, 8).astype(np.float32) * 0.4,
              "w2": rng.randn(8, 8).astype(np.float32) * 0.4}
    x = rng.randn(4, 8).astype(np.float32)
    data = [(rng.randn(4, 8).astype(np.float32), i % 2) for i in range(4)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jsim = JaxSim(jax_cond_model, (jp, jnp.asarray(x), jnp.int32(1)))
    sim = QuantizationSimModel(CondModel(params),
                               (_t(x), torch.tensor(1, dtype=torch.int32)),
                               device="cpu")
    assert _graph_rows(sim.graph) == _graph_rows(jsim.graph)
    assert _subgraphs(sim.graph) == _subgraphs(jsim.graph)
    assert _quantizers(sim) == _quantizers(jsim)
    assert any(n.startswith("cond_0/b1/") for n in sim.quantizers)
    jsim.compute_encodings(jp, iter([(jnp.asarray(d), jnp.int32(f))
                                     for d, f in data]))
    sim.compute_encodings(None, iter([
        (_t(d), torch.tensor(f, dtype=torch.int32)) for d, f in data]))
    _assert_encodings(jsim.encodings, sim.encodings)
    for flag in (0, 1):
        q = sim.quantized_fn(None, _t(x), torch.tensor(flag))
        _close(q, jax.jit(jsim.quantized_fn)(jp, jnp.asarray(x),
                                             jnp.int32(flag)))
        fp = sim.fp_fn(None, _t(x), torch.tensor(flag))
        assert 0 < float((q - fp).norm() / fp.norm()) < 0.25


def jax_while_model(params, x):
    def body(state):
        i, h = state
        return i + 1, jnp.tanh(h @ params["w"])

    return jax.lax.while_loop(lambda s: s[0] < 3, body,
                              (jnp.int32(0), x))[1]


class WhileModel(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(_t(w))

    def forward(self, x):
        def body(state):
            i, h = state
            return i + 1, torch.tanh(h @ self.w)

        counter = torch.zeros((), dtype=torch.int32, device=x.device)
        return cf.while_loop(lambda s: s[0] < 3, body, (counter, x))[1]


def test_while_body_quantizers_match_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(8, 8).astype(np.float32) * 0.4
    x = rng.randn(4, 8).astype(np.float32)
    data = [rng.randn(4, 8).astype(np.float32) for _ in range(3)]
    jp = {"w": jnp.asarray(w)}
    jsim = JaxSim(jax_while_model, (jp, jnp.asarray(x)))
    sim = QuantizationSimModel(WhileModel(w), (_t(x),), device="cpu")
    assert _graph_rows(sim.graph) == _graph_rows(jsim.graph)
    assert _quantizers(sim) == _quantizers(jsim)
    assert sim.graph.get_op("while_0").attrs == \
        jsim.graph.get_op("while_0").attrs
    jsim.compute_encodings(jp, iter([jnp.asarray(d) for d in data]))
    sim.compute_encodings(None, iter([_t(d) for d in data]))
    _assert_encodings(jsim.encodings, sim.encodings)
    q = sim.quantized_fn(None, _t(x))
    _close(q, jax.jit(jsim.quantized_fn)(jp, jnp.asarray(x)))
    fp = sim.fp_fn(None, _t(x))
    assert 0 < float((q - fp).norm() / fp.norm()) < 0.25
    # the model itself (no trace) runs the same loop
    _close(sim.model(_t(x)), jsim.fp_fn(jp, jnp.asarray(x)))


def test_quantizable_while_condition_raises():
    class Bad(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.eye(4) * 0.5)

        def forward(self, x):
            return cf.while_loop(lambda h: (h @ self.w).sum() > 0,
                                 lambda h: h * 0.5, x)

    with pytest.raises(NotImplementedError, match="while"):
        QuantizationSimModel(Bad(), (torch.ones(2, 4),), device="cpu")


def test_nested_scan_in_cond_matches_jax():
    """A scan inside a cond branch: one sub-graph inside another, its ops
    named under both (``cond_0/b1/scan_0/linear_0``), as in JAX; the
    traced graph computes what the model does."""
    rng = np.random.RandomState(6)
    w = rng.randn(8, 8).astype(np.float32) * 0.4
    x = rng.randn(3, 4, 8).astype(np.float32)

    def jax_model(params, x, flag):
        def inner(h):
            return jax.lax.scan(
                lambda c, xt: (jnp.tanh(c @ params["w"] + xt), c), h[0],
                h)[1]
        return jax.lax.cond(flag > 0, inner, lambda h: h * 2.0, x)

    class Nested(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(_t(w))

        def forward(self, x, flag):
            def inner(h):
                return cf.scan(lambda c, xt: (torch.tanh(c @ self.w + xt),
                                              c), h[0], h)[1]
            return cf.cond(flag > 0, inner, lambda h: h * 2.0, x)

    jsim = JaxSim(jax_model, ({"w": jnp.asarray(w)}, jnp.asarray(x),
                              jnp.int32(1)))
    sim = QuantizationSimModel(Nested(), (_t(x), torch.tensor(1)),
                               device="cpu")
    assert _graph_rows(sim.graph) == _graph_rows(jsim.graph)
    assert ("cond_0/b1/scan_0/linear_0", "linear", "cond_0/b1/scan_0") in \
        _graph_rows(sim.graph)
    for flag in (0, 1):
        _close(sim.fp_fn(None, _t(x), torch.tensor(flag)),
               jax_model({"w": jnp.asarray(w)}, jnp.asarray(x),
                         jnp.int32(flag)))


def test_eager_helpers_match_lax():
    """The helpers outside a trace: plain loops with lax's semantics."""
    rng = np.random.RandomState(4)
    xs = rng.randn(5, 3).astype(np.float32)
    for reverse in (False, True):
        jc, jys = jax.lax.scan(lambda c, x: (c + x, c * x), jnp.zeros(3),
                               jnp.asarray(xs), reverse=reverse)
        c, ys = cf.scan(lambda c, x: (c + x, c * x), torch.zeros(3), _t(xs),
                        reverse=reverse)
        _close(c, jc)
        _close(ys, jys)
    assert float(cf.cond(torch.tensor(0), lambda a: a + 1, lambda a: a - 1,
                         torch.tensor(1.0))) == 0.0


# ---------------------------------------------------------------------------
# DeepSpeech2 through the one sim
# ---------------------------------------------------------------------------
def ds2_params(rng, n_mels, conv_channels, hidden, num_layers, vocab):
    """The JAX package's DeepSpeech2 tree (its shapes and scales, small
    random biases) drawn with numpy."""
    freq = -(-(-(-n_mels // 2)) // 2)

    def normal(scale, *shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def lstm(in_dim):
        return {"kernel": normal(0.1, in_dim, 4 * hidden),
                "recurrent_kernel": normal(0.1, hidden, 4 * hidden),
                "bias": normal(0.05, 4 * hidden)}

    c = conv_channels
    params = {"conv1": {"kernel": normal(0.05, 11, 11, 1, c),
                        "bias": normal(0.05, c)},
              "conv2": {"kernel": normal(0.05, 11, 11, c, c),
                        "bias": normal(0.05, c)},
              "lstm": [], "head": {"kernel": normal(0.05, 2 * hidden, vocab),
                                   "bias": normal(0.05, vocab)}}
    in_dim = c * freq
    for _ in range(num_layers):
        params["lstm"].append({"fwd": lstm(in_dim), "bwd": lstm(in_dim)})
        in_dim = 2 * hidden
    return params


@pytest.fixture(scope="module")
def ds2_pair():
    rng = np.random.RandomState(5)
    pnp = ds2_params(rng, n_mels=16, conv_channels=4, hidden=8,
                     num_layers=1, vocab=5)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    x = rng.randn(2, 12, 16).astype(np.float32)
    data = [rng.randn(2, 12, 16).astype(np.float32) for _ in range(2)]
    jsim = JaxSim(jax_ds2_apply, (params, jnp.asarray(x)))
    jsim.compute_encodings(params, iter([jnp.asarray(d) for d in data]))
    model = DeepSpeech2(16, 4, 8, 1, 5)
    model.load_state_dict(convert.deepspeech_params_from_jax(pnp))
    sim = QuantizationSimModel(model, (_t(x),), device="cpu")
    sim.compute_encodings(None, iter([_t(d) for d in data]))
    jlow = {m: jax_lower_to_int(jsim, params, mode=m)
            for m in ("w8", "w8a8")}
    oracle = {"fp": jax.jit(jsim.fp_fn)(params, jnp.asarray(x)),
              "q": jax.jit(jsim.quantized_fn)(params, jnp.asarray(x)),
              "export": jsim.export_encodings(),
              "lowered": {m: (lm.lowered_ops, lm.skipped_ops,
                              lm.downgraded_ops,
                              jax.jit(lm.__call__)(params, jnp.asarray(x)))
                          for m, lm in jlow.items()}}
    return jsim, sim, x, oracle


def test_deepspeech2_graph_and_quantizers_match_jax(ds2_pair):
    jsim, sim, _, _ = ds2_pair
    assert _graph_rows(sim.graph) == _graph_rows(jsim.graph)
    assert _quantizers(sim) == _quantizers(jsim)
    scans = [op for op in sim.graph.ops if op.type == "scan"]
    assert [s.attrs["reverse"] for s in scans] == [False, True]
    assert [s.attrs for s in scans] == [
        op.attrs for op in jsim.graph.ops if op.type == "scan"]


def test_deepspeech2_sim_matches_jax(ds2_pair):
    jsim, sim, x, oracle = ds2_pair
    _assert_encodings(jsim.encodings, sim.encodings)
    fp = sim.fp_fn(None, _t(x))
    _close(fp, oracle["fp"], atol=1e-5)
    q = sim.quantized_fn(None, _t(x))
    _close(q, oracle["q"], atol=1e-5)
    assert float((q - fp).norm() / fp.norm()) < 0.5
    exported = sim.export_encodings()
    assert _export_keys(exported) == _export_keys(oracle["export"])
    assert any(k.startswith("scan_")
               for k in exported["activation_encodings"])


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_deepspeech2_lowering_matches_jax(ds2_pair, mode):
    """The convs and the head lower; the scoped linears are skipped, in
    JAX's order; the lowered forward (the kernels' plain versions here)
    matches the JAX lowering's."""
    jsim, sim, x, oracle = ds2_pair
    lowered, skipped, downgraded, want = oracle["lowered"][mode]
    got = lower_to_int(sim, mode=mode)
    assert got.lowered_ops == lowered
    assert got.skipped_ops == skipped
    assert got.downgraded_ops == downgraded
    assert [n for n in skipped if n.startswith("scan_")] == \
        [op.name for op in sim.graph.ops
         if op.scope is not None and op.type == "linear"]
    _close(got(sim.params, _t(x)), want, rtol=1e-4, atol=1e-4)
