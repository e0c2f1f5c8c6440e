"""The LLM PTQ algorithms (GPTQ / GPTVQ, SmoothQuant), BN re-estimation and
QuantAnalyzer in aimet_tpu_torch against the JAX package, on the same
numpy-made weights and inputs (``device="cpu"``; flax weights carried
across, tests/torch_ptq_util.py), at one intra-op thread but for the
accuracy gates (GPTQ beats nearest rounding, the SmoothQuant rescue),
which run at the default thread count.

Where a result is not bit for bit, the yardstick is the port's own f32
error, as in tests/test_torch_qat.py: within 4 x max|x32 - x64| (+ one ulp,
2u max|x|) of JAX's, x64 the port's result from an f64 twin of the same
weights and inputs.

- GPTQ: the dampened inverse (dead columns flagged alike, the inverse by
  the yardstick); the column loop given JAX's block and inverse (codes bit
  for bit, values and errors by the yardstick); the codes of
  tests/test_gptq.py's TinyMLP (linear) and conv net against JAX's (every
  code equal); the JAX test's gates (beats
  nearest rounding, weights on their frozen grid) in the port.
- GPTVQ: the k-means' assignments bit for bit and its centroids by the
  yardstick (tests/test_gptq.py's clusters); tests/test_gptq.py's
  reconstruction check in the port.
- SmoothQuant: the targets on tests/test_smooth_quant.py's NormedMLP and on
  TransformerConfig.tiny() (the same producers and consumers as JAX's);
  the scales and smoothed weights by the yardstick; float exactness at the
  JAX test's bounds; the W8A8 rescue (< 0.6 of the error) and the scale
  guards.
- BN re-estimation: a small ResNet's means and variances (float forward)
  by the yardstick against JAX's; in the quantized forward, against the
  same statistics in f64 of the captured BN inputs.
- QuantAnalyzer: the sensitivities, the accuracies and the per-layer MSEs
  (each kind as one vector) by the yardstick against JAX's, and the HTML
  report.
"""
import contextlib
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.algorithms import bn_reestimation as jbnre
from aimet_tpu.algorithms import gptq as jgptq
from aimet_tpu.algorithms import quant_analyzer as jqa
from aimet_tpu.algorithms import smooth_quant as jsq
from aimet_tpu.graph.connected_graph import ConnectedGraph as JaxGraph
from aimet_tpu.models.cnn import TinyMLP as JaxTinyMLP
from aimet_tpu.models.resnet import Bottleneck as JaxBottleneck
from aimet_tpu.models.resnet import ResNet as JaxResNet
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, convert
from aimet_tpu_torch.algorithms import (GPTVQParameters, QuantAnalyzer,
                                        apply_gptq, apply_gptvq,
                                        apply_smooth_quant,
                                        compute_smoothing_scales,
                                        find_smooth_targets,
                                        reestimate_bn_stats)
from aimet_tpu_torch.algorithms import gptq as tgptq
from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
from aimet_tpu_torch.models.layers import Conv
from aimet_tpu_torch.models.resnet import Bottleneck, ResNet
from torch_ptq_util import (TinyMLP, init_variables, nchw,
                            one_thread, randomize)
from torch_quantsim_util import tiny_numpy_pair, to_torch

U = 2.0 ** -24
# the intra-op thread count before the module's ``one_thread`` fixture
DEFAULT_THREADS = torch.get_num_threads()


@contextlib.contextmanager
def default_threads():
    """The accuracy gates run at the default thread count (the rest of the
    file at one thread: the parallel test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _within(got32, got64, want, what=""):
    got32, got64, want = (np.asarray(a, np.float64) for a in
                          (got32, got64, want))
    tol = 4 * np.abs(got32 - got64).max() + 2 * U * np.abs(got64).max()
    err = np.abs(got32 - want).max()
    assert err <= tol, (what, err, tol)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# GPTQ / GPTVQ
# ---------------------------------------------------------------------------

def test_hessian_inverse_dampening_matches_jax():
    rs = np.random.RandomState(0)
    X = rs.randn(64, 8).astype(np.float32)
    H = X.T @ X
    H[3] = 0.0
    H[:, 3] = 0.0
    jinv, jdead = jgptq._prep_hessian_inverse(jnp.asarray(H))
    inv32, dead = tgptq._prep_hessian_inverse(torch.from_numpy(H))
    inv64, _ = tgptq._prep_hessian_inverse(torch.from_numpy(H).double())
    np.testing.assert_array_equal(_np(dead), np.asarray(jdead))
    assert bool(dead[3]) and np.isfinite(_np(inv32)).all()
    _within(_np(inv32), _np(inv64), jinv, "Hinv")


def test_gptq_block_matches_jax_given_its_inputs():
    rs = np.random.RandomState(1)
    X = rs.randn(128, 16).astype(np.float32)
    jinv, _ = jgptq._prep_hessian_inverse(jnp.asarray(X.T @ X))
    W = rs.randn(6, 16).astype(np.float32)
    emin = -np.abs(W).max(1, keepdims=True)
    emax = np.abs(W).max(1, keepdims=True)
    jq, je = jgptq._gptq_block(jnp.asarray(W), jinv, jnp.asarray(emin),
                               jnp.asarray(emax), 4, True)
    q, e = tgptq._gptq_block(torch.from_numpy(W),
                             torch.from_numpy(np.asarray(jinv)),
                             torch.from_numpy(emin), torch.from_numpy(emax),
                             4, True)
    q64, e64 = tgptq._gptq_block(
        *(torch.from_numpy(np.asarray(a)).double()
          for a in (W, jinv, emin, emax)), 4, True)
    # the codes bit for bit; the values by the yardstick (jitted, XLA
    # multiplies by 1 / delta where the port divides)
    delta = emax.astype(np.float64) / 7
    np.testing.assert_array_equal(np.round(_np(q) / delta),
                                  np.round(np.asarray(jq) / delta))
    _within(_np(q), _np(q64), jq, "Q")
    _within(_np(e), _np(e64), je, "E")


class JaxConvNet(nn.Module):
    """tests/test_gptq.py::test_gptq_conv_layers's Net."""
    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(8, (3, 3), padding="SAME")(x))
        return nn.Conv(4, (3, 3), padding="SAME")(x)


class ConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 8, (3, 3), use_bias=True)
        self.Conv_1 = Conv(8, 4, (3, 3), use_bias=True)

    def forward(self, x):
        return self.Conv_1(torch.relu(self.Conv_0(x)))


GPTQ_MODELS = {
    # name: (jax model, port model, input shape (flax layout), bw, block)
    "linear": (lambda: JaxTinyMLP(features=32),
               lambda: TinyMLP(in_features=16, features=32), (16, 16), 4,
               16),
    "conv": (JaxConvNet, ConvNet, (4, 8, 8, 3), 4, 32),
}


@functools.lru_cache(maxsize=None)
def _gptq_pair(name, bw=None):
    """Both packages' minmax sims of GPTQ_MODELS[name] calibrated on the
    same 4 batches, the weights carried across."""
    jm_cls, make, shape, bw0, _ = GPTQ_MODELS[name]
    rs = np.random.RandomState(3)
    jm = jm_cls()
    x = rs.randn(*shape).astype(np.float32)
    v = init_variables(jm, x, rs)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    fn = lambda p, t: jm.apply(p, t)
    batches = [rs.randn(*shape).astype(np.float32) for _ in range(4)]
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax",
                default_param_bw=bw or bw0)
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    tm = make()
    tm.load_state_dict(convert.cnn_params_from_flax(v))
    tb = [nchw(b) for b in batches]
    ts = QuantizationSimModel(tm, (nchw(x),), quant_scheme="minmax",
                              default_param_bw=bw or bw0, device="cpu")
    ts.compute_encodings(None, tb)
    return fn, jv, js, tm, ts, batches, tb


def _codes(w, enc, per_channel_axis):
    d = enc.delta
    if per_channel_axis is not None and np.ndim(d):
        shape = [1] * np.ndim(w)
        shape[per_channel_axis] = -1
        d = np.reshape(d, shape)
    return np.round(np.asarray(w, np.float64) / np.asarray(d, np.float64))


@pytest.mark.parametrize("name", list(GPTQ_MODELS))
def test_gptq_codes_match_jax(name):
    fn, jv, js, tm, ts, batches, tb = _gptq_pair(name)
    block = GPTQ_MODELS[name][4]
    jnew = jgptq.apply_gptq(js, jv, [jnp.asarray(b) for b in batches],
                            block_size=block)
    new = apply_gptq(ts, None, tb, block_size=block)
    jflat = {convert.port_param_name(jax.tree_util.keystr(p)): np.asarray(a)
             for p, a in jax.tree_util.tree_leaves_with_path(jnew)}
    frozen = sorted(ts._frozen)
    assert frozen == sorted(convert.port_param_name(k) for k in js._frozen)
    for k in frozen:
        w, jw = _np(new[k]), jflat[k]
        if w.ndim == 4:                   # OIHW against HWIO
            jw = jw.transpose(3, 2, 0, 1)
        enc = ts.encodings[k]
        ax = ts.quantizers[k].channel_axis
        q = _codes(w, enc, ax)
        np.testing.assert_array_equal(q, _codes(jw, enc, ax), err_msg=k)
        # on the frozen grid (tests/test_gptq.py's check)
        d = _np(enc.delta)
        dq = _np(enc.delta) if not d.ndim else d.reshape(
            [-1 if i == ax else 1 for i in range(w.ndim)])
        np.testing.assert_allclose(w / dq, np.round(w / dq), atol=1e-3)
    # the other params are the caller's tensors, unchanged
    for k, p in tm.named_parameters():
        if k not in frozen:
            assert new[k] is p or torch.equal(new[k], p.detach())


@pytest.mark.parametrize("name", list(GPTQ_MODELS))
def test_gptq_beats_nearest_rounding(name):
    """tests/test_gptq.py's gates (test_gptq_beats_nearest_rounding,
    test_gptq_conv_layers) in the port, at the default thread count."""
    fn, jv, js, tm, ts, batches, tb = _gptq_pair(name)
    block = GPTQ_MODELS[name][4]
    params = {k: v.detach() for k, v in tm.named_parameters()}
    with default_threads():
        sim = QuantizationSimModel(tm, (tb[0],), quant_scheme="minmax",
                                   default_param_bw=4, device="cpu")
        sim.compute_encodings(None, tb)
        with torch.no_grad():
            ref = tm(tb[0])
        err_nearest = (sim.quantized_fn(params, tb[0]) - ref).abs().mean() \
            .item()
        new = apply_gptq(sim, params, tb, block_size=block)
        err_gptq = (sim.quantized_fn(new, tb[0]) - ref).abs().mean().item()
    assert err_gptq < err_nearest, (err_gptq, err_nearest)


def test_weighted_kmeans_matches_jax():
    rs = np.random.RandomState(4)
    pts = np.concatenate([rs.randn(100, 2) + 5,
                          rs.randn(100, 2) - 5]).astype(np.float32)
    w = (rs.rand(200, 2) + 0.5).astype(np.float32)
    for k in (2, 16):
        jc, ja = jgptq._weighted_kmeans(jnp.asarray(pts), jnp.asarray(w), k,
                                        10, jax.random.PRNGKey(0))
        c32, a32 = tgptq._weighted_kmeans(torch.from_numpy(pts),
                                          torch.from_numpy(w), k, 10)
        c64, _ = tgptq._weighted_kmeans(torch.from_numpy(pts).double(),
                                        torch.from_numpy(w).double(), k, 10)
        np.testing.assert_array_equal(_np(a32), np.asarray(ja))
        _within(_np(c32), _np(c64), jc, f"centroids k={k}")
    cent = tgptq._weighted_kmeans(torch.from_numpy(pts), torch.ones(200, 2),
                                  2, 10)[0]
    c = np.sort(_np(cent)[:, 0])
    assert c[0] < -3 and c[1] > 3


def test_gptvq_reconstructs():
    """tests/test_gptq.py::test_gptvq_runs_and_reconstructs in the port."""
    fn, jv, js, tm, ts, batches, tb = _gptq_pair("linear", bw=8)
    params = {k: v.detach() for k, v in tm.named_parameters()}
    with torch.no_grad():
        ref = tm(tb[0])
    new = apply_gptvq(ts, params, tb, GPTVQParameters(
        vector_dim=2, index_bw=6, cols_per_block=16))
    out = ts.fp_fn(new, tb[0])
    rel = ((out - ref).abs().mean() / (ref.abs().mean() + 1e-9)).item()
    assert rel < 0.5
    w0, w1 = _np(params["Dense_0.kernel"]), _np(new["Dense_0.kernel"])
    assert not np.allclose(w0, w1)
    assert np.unique(np.round(w1.astype(np.float64), 6)).size < w1.size / 2
    # op_names limits the layers
    only = apply_gptvq(ts, params, tb, GPTVQParameters(
        vector_dim=2, index_bw=6, cols_per_block=16), op_names=["linear_1"])
    assert torch.equal(only["Dense_0.kernel"], params["Dense_0.kernel"])
    assert not torch.equal(only["Dense_1.kernel"], params["Dense_1.kernel"])


# ---------------------------------------------------------------------------
# SmoothQuant
# ---------------------------------------------------------------------------

class JaxNormedMLP(nn.Module):
    """tests/test_smooth_quant.py's NormedMLP."""
    d: int = 32
    h: int = 64

    @nn.compact
    def __call__(self, x):
        y = x * jax.lax.rsqrt(jnp.mean(x * x, -1, keepdims=True) + 1e-6)
        y = y * self.param("gamma", nn.initializers.ones, (self.d,))
        a = nn.Dense(self.h, use_bias=False, name="w_gate")(y)
        b = nn.Dense(self.h, use_bias=False, name="w_up")(y)
        return nn.Dense(self.d, name="w_down")(nn.silu(a) * b)


class _Kernel(torch.nn.Module):
    def __init__(self, d_in, d_out, bias=False):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = torch.nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class NormedMLP(torch.nn.Module):
    def __init__(self, d=32, h=64):
        super().__init__()
        self.gamma = torch.nn.Parameter(torch.ones(d))
        self.w_gate = _Kernel(d, h)
        self.w_up = _Kernel(d, h)
        self.w_down = _Kernel(h, d, bias=True)

    def forward(self, x):
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
        y = y * self.gamma
        a, b = self.w_gate(y), self.w_up(y)
        return self.w_down(a * torch.sigmoid(a) * b)


@functools.lru_cache(maxsize=None)
def _sq_setup():
    """tests/test_smooth_quant.py's setup (outliers in the norm's gamma),
    in both packages, and the port's f64 twin."""
    rs = np.random.RandomState(0)
    jm = JaxNormedMLP()
    x0 = rs.randn(8, 32).astype(np.float32)
    v = init_variables(jm, x0, rs)
    for k in ("w_gate", "w_up", "w_down"):
        v["params"][k]["kernel"] = (rs.randn(*v["params"][k]["kernel"].shape)
                                    / np.sqrt(32)).astype(np.float32)
    gamma = np.ones(32, np.float32)
    gamma[[3, 17]] = 50.0
    v["params"]["gamma"] = gamma
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    fn = lambda p, t: jm.apply(p, t)
    calib = [rs.randn(8, 32).astype(np.float32) for _ in range(3)]
    tms = []
    for dt in (torch.float32, torch.float64):
        tm = NormedMLP().to(dt)
        tm.load_state_dict({k: t.to(dt) for k, t in
                            convert.cnn_params_from_flax(v).items()})
        tms.append(tm)
    return fn, jv, jnp.asarray(x0), [jnp.asarray(c) for c in calib], tms, \
        x0, calib


def _port_sites(targets):
    return sorted((t.producer.type, tuple(sorted(
        c.param_products["kernel"].param_path for c in t.consumers)))
        for t in targets)


def _jax_sites(targets):
    return sorted((t.producer.type, tuple(sorted(
        convert.port_param_name(c.param_products["kernel"].param_path)
        for c in t.consumers))) for t in targets)


def test_smooth_targets_match_jax_on_the_mlp():
    fn, jv, jx, jcalib, (tm, _), x0, calib = _sq_setup()
    jt = jsq.find_smooth_targets(JaxGraph(fn, (jv, jx)))
    tt = find_smooth_targets(ConnectedGraph(tm, (torch.from_numpy(x0),)))
    assert _port_sites(tt) == _jax_sites(jt)
    assert any(len(t.consumers) == 2 and t.producer.type == "scale"
               for t in tt)


def test_smooth_quant_matches_jax_and_is_float_exact():
    fn, jv, jx, jcalib, (tm, tm64), x0, calib = _sq_setup()
    jv2, jinfo = jsq.apply_smooth_quant(fn, (jv, jx), jv, jcalib, alpha=0.5)
    outs = []
    for m, dt in ((tm, torch.float32), (tm64, torch.float64)):
        xs = torch.from_numpy(x0).to(dt)
        outs.append(apply_smooth_quant(
            m, (xs,), None, [torch.from_numpy(c).to(dt) for c in calib],
            alpha=0.5))
    (p32, info32), (p64, info64) = outs
    assert list(info32) == ["scale_2"] or len(info32) == len(jinfo)
    (s32,), (s64,), (js_,) = (list(info32.values()), list(info64.values()),
                              list(jinfo.values()))
    _within(_np(s32), _np(s64), js_, "scales")
    assert float(s32.max() / s32.min()) > 3.0
    jflat = {convert.port_param_name(jax.tree_util.keystr(p)): np.asarray(a)
             for p, a in jax.tree_util.tree_leaves_with_path(jv2)}
    for k in p32:
        _within(_np(p32[k]), _np(p64[k]), jflat[k], k)
    # float exactness at tests/test_smooth_quant.py's bound
    xs = torch.from_numpy(x0)
    with torch.no_grad():
        ref = _np(tm(xs))
        got = _np(torch.func.functional_call(tm, p32, (xs,)))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    # the caller's tensors are untouched
    assert torch.equal(tm.gamma.detach()[[3, 17]], torch.tensor([50., 50.]))


def test_smooth_quant_rescues_w8a8_on_outliers():
    """tests/test_smooth_quant.py::test_w8a8_rescue_on_outliers in the port,
    at the default thread count."""
    fn, jv, jx, jcalib, (tm, _), x0, calib = _sq_setup()
    xs = torch.from_numpy(x0)
    tc = [torch.from_numpy(c) for c in calib]
    g = ConnectedGraph(tm, (xs,))
    (t,) = [t for t in find_smooth_targets(g) if len(t.consumers) == 2]
    site = [t.act_product_name] + [
        c.param_products["kernel"].param_path for c in t.consumers] + [
        p.param_path for p in t.producer.param_products.values()]
    site = [s.removesuffix(".out") for s in site]

    def errs(params):
        sim = QuantizationSimModel(tm, (xs,), device="cpu")
        sim.compute_encodings(params, tc)
        with torch.no_grad():
            f = _np(torch.func.functional_call(tm, params, (xs,)))
        out = []
        for q in (sim.quantized_fn_subset(params, xs, enabled=site),
                  sim.quantized_fn(params, xs)):
            q = _np(q)
            out.append(np.sqrt(np.mean((q - f) ** 2)) / (np.std(f) + 1e-12))
        return out

    params = {k: v.detach() for k, v in tm.named_parameters()}
    with default_threads():
        site_plain, full_plain = errs(params)
        smoothed, _ = apply_smooth_quant(tm, (xs,), params, tc, alpha=0.5)
        site_smooth, full_smooth = errs(smoothed)
    assert site_smooth < 0.6 * site_plain, (site_plain, site_smooth)
    assert full_smooth < full_plain


def test_scale_guards():
    s = compute_smoothing_scales(torch.tensor([0.0, 1.0, 4.0]),
                                 torch.tensor([1.0, 0.0, 1.0]), alpha=0.5)
    want = jsq.compute_smoothing_scales(jnp.array([0.0, 1.0, 4.0]),
                                        jnp.array([1.0, 0.0, 1.0]), 0.5)
    np.testing.assert_array_equal(_np(s), np.asarray(want))
    np.testing.assert_array_equal(_np(s), [1.0, 1.0, 2.0])


def test_smooth_targets_and_exactness_on_the_transformer():
    """tests/test_smooth_quant.py::test_transformer_targets_and_exactness
    on the port's tiny (its weights carried from the JAX package's)."""
    fn, variables, tm, tok, _ = tiny_numpy_pair()
    jt = jnp.asarray(tok)
    jtargets = jsq.find_smooth_targets(JaxGraph(fn, (variables, jt)))
    t = to_torch(tok)
    g = ConnectedGraph(tm, (t,))
    targets = find_smooth_targets(g)
    assert _port_sites(targets) == _jax_sites(jtargets)
    grouped = sorted(len(x.consumers) for x in targets)
    assert len(targets) >= 4 and grouped.count(3) >= 2 \
        and grouped.count(2) >= 2, grouped
    assert any(x.consumers[0].param_products["kernel"].param_path
               == "lm_head.kernel" for x in targets)
    new, info = apply_smooth_quant(tm, (t,), None, [t], alpha=0.5, graph=g,
                                   targets=targets)
    assert len(info) == len(targets)
    with torch.no_grad():
        ref = _np(tm(t))
        got = _np(torch.func.functional_call(tm, new, (t,)))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5)


# ---------------------------------------------------------------------------
# BN re-estimation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resnet_pair():
    rs = np.random.RandomState(6)
    jm = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck,
                   num_classes=10, num_filters=8)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    v = randomize(init_variables(jm, x, rs), rs)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    fn = lambda p, t: jm.apply(p, t)
    batches = [(rs.randn(2, 16, 16, 3) + 0.5).astype(np.float32)
               for _ in range(2)]
    # the JAX sim runs only the float forward: no calibration needed
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax")
    sims = []
    for dt in (torch.float32, torch.float64):
        tm = ResNet([1, 1], Bottleneck, num_classes=10, num_filters=8).to(dt)
        tm.load_state_dict({k: t.to(dt) for k, t in
                            convert.cnn_params_from_flax(v).items()})
        ts = QuantizationSimModel(tm, (nchw(x).to(dt),),
                                  quant_scheme="minmax", device="cpu")
        ts.compute_encodings(None, [nchw(b).to(dt) for b in batches])
        sims.append(ts)
    return fn, jv, js, sims, batches


def test_bn_reestimation_matches_jax_on_a_resnet():
    fn, jv, js, (ts, ts64), batches = _resnet_pair()
    jnew = jbnre.reestimate_bn_stats(js, jv, [jnp.asarray(b)
                                              for b in batches], mode="fp")
    new32 = reestimate_bn_stats(ts, None, [nchw(b) for b in batches],
                                mode="fp")
    new64 = reestimate_bn_stats(ts64, None, [nchw(b).double()
                                             for b in batches], mode="fp")
    jstats = {convert.port_param_name(jax.tree_util.keystr(p)): np.asarray(a)
              for p, a in jax.tree_util.tree_leaves_with_path(
                  jnew["batch_stats"])}
    keys = [k for k in new32 if k.endswith((".mean", ".var"))]
    assert len(keys) == 2 * len(ts.graph.ops_of_type("batchnorm")) == \
        2 * 9
    for k in keys:
        _within(_np(new32[k]), _np(new64[k]), jstats[k], k)
        assert not torch.equal(new32[k], ts.params[k])


def test_bn_reestimation_quantized_matches_f64_stats():
    fn, jv, js, (ts, _), batches = _resnet_pair()
    xs = [nchw(b) for b in batches]
    new = reestimate_bn_stats(ts, None, xs)
    for op in ts.graph.ops_of_type("batchnorm"):
        name = op.inputs[0].name
        caps = torch.cat([ts.collect_activations(None, (x,), [name],
                                                 "quantized")[name]
                          for x in xs]).double()
        mean = caps.mean(dim=(0, 2, 3))
        var = caps.var(dim=(0, 2, 3), unbiased=False)
        path = next(p for p in op.attrs["param_roots"] if p.endswith("mean"))
        got_m = new[path].double()
        got_v = new[path.replace("mean", "var")].double()
        n = caps.numel() // caps.shape[1]
        # an f32 sum of n terms: n u sum|x| (and of x^2 for the variance)
        tol_m = n * U * caps.abs().mean(dim=(0, 2, 3))
        tol_v = n * U * (caps ** 2).mean(dim=(0, 2, 3)) + 2 * tol_m * \
            mean.abs()
        assert ((got_m - mean).abs() <= tol_m + 1e-12).all(), op.name
        assert ((got_v - var).abs() <= tol_v + 1e-12).all(), op.name


# ---------------------------------------------------------------------------
# QuantAnalyzer
# ---------------------------------------------------------------------------

def test_quant_analyzer_matches_jax(tmp_path):
    rs = np.random.RandomState(8)
    jm = JaxTinyMLP(features=16)
    x = rs.randn(8, 16).astype(np.float32)
    v = init_variables(jm, x, rs)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    fn = lambda p, t: jm.apply(p, t)
    batches = [rs.randn(8, 16).astype(np.float32) for _ in range(3)]
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme="minmax")
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    jref = fn(jv, jnp.asarray(batches[0]))
    jres = jqa.QuantAnalyzer(js, jv, lambda f: -float(jnp.mean(
        (f(jnp.asarray(batches[0])) - jref) ** 2))).analyze(
        mse_batches=[jnp.asarray(batches[0])])

    results, sims = [], []
    for dt in (torch.float32, torch.float64):
        tm = TinyMLP(in_features=16, features=16).to(dt)
        tm.load_state_dict({k: t.to(dt) for k, t in
                            convert.cnn_params_from_flax(v).items()})
        tb = [torch.from_numpy(b).to(dt) for b in batches]
        ts = QuantizationSimModel(tm, (tb[0],), quant_scheme="minmax",
                                  device="cpu")
        ts.compute_encodings(None, tb)
        with torch.no_grad():
            ref = tm(tb[0])
        res = QuantAnalyzer(ts, None, lambda f, tb=tb, ref=ref: -(
            (f(tb[0]) - ref) ** 2).mean().item()).analyze(
            mse_batches=[tb[0]])
        results.append(res)
        sims.append(ts)
    r32, r64 = results
    assert r32.fp_accuracy == pytest.approx(0.0)
    assert r32.fp_accuracy >= r32.quantized_accuracy - 1e-9
    # each kind of result as one vector (the yardstick's max over it)
    acc = ("quantized_accuracy", "param_only_accuracy", "act_only_accuracy")
    _within(*([getattr(r, f) for f in acc] for r in (r32, r64, jres)),
            "accuracies")
    jsens = {convert.port_param_name(k): s
             for k, s in jres.per_quantizer_sensitivity.items()}
    names = sorted(r32.per_quantizer_sensitivity)
    assert names == sorted(jsens) and len(names) == len(sims[0].encodings)
    _within([r32.per_quantizer_sensitivity[k] for k in names],
            [r64.per_quantizer_sensitivity[k] for k in names],
            [jsens[k] for k in names], "sensitivities")
    layers = sorted(r32.per_layer_mse)
    assert layers == sorted(jres.per_layer_mse)
    _within(*([r.per_layer_mse[k] for k in layers]
              for r in (r32, r64, jres)), "per-layer MSE")
    out = tmp_path / "report.html"
    QuantAnalyzer.export_html(r32, str(out))
    text = out.read_text()
    assert "Quantization analysis" in text and "linear_2" in text
