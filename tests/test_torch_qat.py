"""Quantization-aware training in aimet_tpu_torch against the JAX package,
on the same numpy-made inputs (``device="cpu"``).

- ``quantize_dequantize``'s gradients against ``jax.grad`` of the JAX
  function: the forward and the straight-through gradient to x bit for bit;
  zero encoding gradients on a static grid; the range-learning gradients of
  (min, max) (symmetric, asymmetric, unsigned symmetric, per channel, 3-D
  broadcast) within the f32 bound of a sum of n terms, (n + 8) u sum m_i
  (u = 2^-24; the terms' own few roundings are the 8), m_i each term's
  magnitude before its own cancellation (|x_quant + offset| + |x / delta|,
  times |upstream|), taken in f64 from the reference formula
  (quantsim_straight_through_grad.py), which both packages are held to;
  ``round_ste``; ``blockwise_quantize_dequantize``'s gradients likewise.
- ``torch.autograd.gradcheck`` in f64 where the analytic gradient is the
  derivative of the forward: (min, max) of x on the clipped side of the grid
  (inside the grid the straight-through estimator is by design not the
  derivative of the staircase), and the FP8 fake cast's maxval.
- Stochastic rounding: unbiased (tests/test_affine.py's check; the draws
  are PyTorch's, not JAX's).
- The FP8 maxval searches (min-max and the 111-point MSE sweep) bit for bit,
  per tensor and per channel; the FP8 cast on them within 4 * 2^-19
  relative (its scale 2 ** t, t a sum of terms up to 16 that the
  frameworks round apart by ulps of 16, as the JAX package's own jitted
  and eager casts do).
- ``set_quantizer_data_type``: int -> float (FP16, FP8) -> int, the
  quantized forward against the JAX sim's within 1e-6 of its max, the
  encodings restored bit for bit.
- ``qat_fn`` / ``static_grid_qat_fn``: the gradients of a loss to the
  params and to every (min, max) against ``jax.grad`` of the JAX sim's, on
  tests/test_lowering.py's MLP with every quantizer on, and on
  TransformerConfig.tiny() (weights drawn with numpy) with its parameter
  quantizers alone (its activation quantizers round a hair apart in the
  two frameworks at some positions: tests/test_torch_quantsim.py), the JAX
  sim's encodings carried across (``convert.encodings_from_jax``). The
  yardstick is the port's own f32 error: each parameter's gradient, and
  all the (min) gradients as one vector and the (max) ones as another,
  within 4 x max|g32 - g64| (+ one ulp, 2u max|g|, for the result's own
  rounding) of JAX's, g64 the port's gradient with the model, inputs and
  encodings in f64 — two f32 results each off the exact value by about
  that gap differ by at most twice it, and the max over a tensor gets a
  factor 2. (A per-tensor encoding's gradient is one number, whose own gap
  can be near 0 by chance: hence the vectors.)
- ``update_encodings_from_qat`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.quantization import affine as jaffine
from aimet_tpu.quantization import blockwise as jblock
from aimet_tpu.quantization import float_sim as jfs
from aimet_tpu.quantization import grads as jgrads
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, convert
from aimet_tpu_torch.models import transformer as transformer_module
from aimet_tpu_torch.models.transformer import Transformer, TransformerConfig
from aimet_tpu_torch.quantization import affine, blockwise, float_sim, grads
from torch_ptq_util import one_thread
from torch_quantsim_util import jax_mlp, mlp_pair, tiny_numpy_pair, to_torch

U = 2.0 ** -24


def _t(a, grad=False, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _ref_terms(x, mn, mx, up, bw, sym, unsigned):
    """The reference formula in f64 (quantsim_straight_through_grad.py:
    252-329): per element the terms of d/dmin and d/dmax before the
    reduction, broadcast to x's shape, and each term's magnitude before
    its own cancellation (the scale of its f32 rounding error)."""
    x, mn, mx, up = (np.asarray(a, np.float64) for a in (x, mn, mx, up))
    mn, mx = np.broadcast_to(mn, x.shape), np.broadcast_to(mx, x.shape)
    ns = float(2 ** bw - 1)
    if sym and not unsigned:
        delta = mx / np.floor(ns / 2)
        offset = np.full_like(delta, -np.ceil(ns / 2))
    else:
        delta = (mx - mn) / ns
        offset = mn / delta if sym else -np.clip(np.round(-mn / delta), 0, ns)
    xr = np.round(x / delta) - offset
    xq = np.clip(xr, 0, ns)
    mask = (xr >= 0) & (xr <= ns)
    if sym and not unsigned:
        g = ((xq + offset) * up - mask * (x / delta) * up) / np.floor(ns / 2)
        mag = (np.abs(xq + offset) + mask * np.abs(x / delta)) * np.abs(up) \
            / np.floor(ns / 2)
        return (-g, mag), (g, mag)
    t1 = (xq + offset - x * mask / delta) * up / ns
    m1 = (np.abs(xq + offset) + np.abs(x * mask / delta)) * np.abs(up) / ns
    t2 = ns / (mx - mn) ** 2 * delta * up * ~mask
    return ((-t1 + mx * t2, m1 + np.abs(mx * t2)),
            (t1 - mn * t2, m1 + np.abs(mn * t2)))


def _reduce(a, shape):
    lead = a.ndim - len(shape)
    a = a.sum(axis=tuple(range(lead))) if lead else a
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and a.shape[i] != 1)
    return (a.sum(axis=axes, keepdims=True) if axes else a).reshape(shape)


def _assert_within_sum_bound(got, terms, shape, n):
    """|got - sum(terms)| <= (n + 8) u sum(magnitudes), by element of
    ``shape``."""
    t, mag = terms
    ref, tol = _reduce(t, shape), (n + 8) * U * _reduce(mag, shape)
    err = np.abs(np.asarray(got, np.float64).reshape(shape) - ref)
    assert np.all(err <= tol), (err.max(), tol.min())


CASES = {
    # name: (x shape, encoding shape, symmetric, unsigned, x offset)
    "symmetric": ((256,), (), True, False, 0.0),
    "asymmetric": ((256,), (), False, False, 0.4),
    "unsigned_symmetric": ((256,), (), True, True, 1.0),
    "per_channel": ((4, 32), (4, 1), True, False, 0.0),
    "per_channel_asymmetric": ((4, 32), (4, 1), False, False, 0.3),
    "broadcast_3d": ((3, 8, 5), (8, 1), False, False, 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_range_learning_grads_match_jax(case):
    shape, eshape, sym, unsigned, shift = CASES[case]
    rs = np.random.RandomState(len(case))
    x = (rs.randn(*shape) * 1.3 + shift).astype(np.float32)
    if unsigned:
        x = np.abs(x)
        mn = np.zeros(eshape, np.float32)
    else:
        mn = np.asarray(-rs.rand(*eshape) - 0.5, np.float32)
    mx = np.asarray(rs.rand(*eshape) + 0.5, np.float32)
    up = rs.randn(*shape).astype(np.float32)
    kw = dict(bitwidth=8, symmetric=sym, unsigned_symmetric=unsigned)

    def f(x_, a, b):
        return jnp.sum(jgrads.quantize_dequantize(
            x_, a, b, learn_range=True, **kw) * up)
    jout = jgrads.quantize_dequantize(jnp.asarray(x), mn, mx, **kw)
    jdx, jdmin, jdmax = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx))

    X, A, B = _t(x, True), _t(mn, True), _t(mx, True)
    out = grads.quantize_dequantize(X, A, B, learn_range=True, **kw)
    (out * _t(up)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(X.grad.numpy(), np.asarray(jdx))
    assert A.grad.shape == A.shape and B.grad.shape == B.shape

    tmin, tmax = _ref_terms(x, mn, mx, up, 8, sym, unsigned)
    n = x.size // max(mn.size, 1)
    for got, want, terms in ((A.grad, jdmin, tmin), (B.grad, jdmax, tmax)):
        _assert_within_sum_bound(got.numpy(), terms, mn.shape, n)
        _assert_within_sum_bound(want, terms, mn.shape, n)


def test_ste_gradient_masks_out_of_range():
    x = np.array([-2.0, -0.5, 0.0, 0.5, 2.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jgrads.quantize_dequantize(
        v, -1.0, 1.0, bitwidth=8, symmetric=True)))(jnp.asarray(x))
    X = _t(x, True)
    grads.quantize_dequantize(X, -1.0, 1.0, bitwidth=8,
                              symmetric=True).sum().backward()
    np.testing.assert_array_equal(X.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(X.grad.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])


def test_static_grid_gives_encodings_zero_grads():
    x = np.linspace(-1, 1, 11).astype(np.float32)
    jmn, jmx = jax.grad(lambda a, b: jnp.sum(jgrads.quantize_dequantize(
        jnp.asarray(x), a, b, bitwidth=8)), argnums=(0, 1))(
        jnp.float32(-1.0), jnp.float32(1.0))
    A, B = _t(-1.0, True), _t(1.0, True)
    grads.quantize_dequantize(_t(x), A, B, bitwidth=8).sum().backward()
    assert float(jmn) == A.grad.item() == 0.0
    assert float(jmx) == B.grad.item() == 0.0


def test_gradcheck_f64_where_the_gradient_is_the_derivative():
    rs = np.random.RandomState(3)
    # x beyond the grid on both sides: out is the grid's edge, whose
    # derivative to max is the analytic range gradient, to x zero
    x = torch.tensor(np.concatenate([rs.uniform(2.5, 4.0, 16),
                                     -rs.uniform(2.5, 4.0, 16)]),
                     dtype=torch.float64, requires_grad=True)
    mx = torch.tensor([1.5, 2.0], dtype=torch.float64,
                      requires_grad=True).reshape(2, 1)
    assert torch.autograd.gradcheck(
        lambda x_, m: grads.quantize_dequantize(
            x_.reshape(2, 16), -2.0, m, bitwidth=8, symmetric=True,
            learn_range=True), (x, mx))
    # the FP8 fake cast: a plain round, so its autograd gradient is the
    # derivative (to x zero, to maxval through the scales)
    xf = torch.tensor(rs.randn(64) * 3, dtype=torch.float64,
                      requires_grad=True)
    mv = torch.tensor(4.3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x_, m: float_sim.fake_cast_to_ieee_float(x_, m), (xf, mv))


def test_round_ste():
    x = np.array([0.3, 1.7], np.float32)
    want = jax.grad(lambda v: jnp.sum(jgrads.round_ste(v) * 2))(
        jnp.asarray(x))
    X = _t(x, True)
    out = grads.round_ste(X)
    (out * 2).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jgrads.round_ste(x)))
    np.testing.assert_array_equal(X.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("learn_range", [False, True])
def test_blockwise_grads_match_jax(learn_range):
    rs = np.random.RandomState(5)
    w = rs.randn(8, 32).astype(np.float32)
    up = rs.randn(8, 32).astype(np.float32)
    enc = jblock.blockwise_encoding(jnp.asarray(w), 8, 1, 4, True)
    mn, mx = np.asarray(enc.min) * 0.9, np.asarray(enc.max) * 0.9

    def f(w_, a, b):
        e = jaffine.compute_encoding_from_min_max(a, b, 4, True)
        e = dataclasses.replace(e, min=a, max=b)
        return jnp.sum(jblock.blockwise_quantize_dequantize(
            w_, 8, 1, 4, True, encoding=e, learn_range=learn_range) * up)
    jdw, jdmin, jdmax = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(mn), jnp.asarray(mx))

    W, A, B = _t(w, True), _t(mn, True), _t(mx, True)
    e = affine.compute_encoding_from_min_max(A.detach(), B.detach(), 4, True)
    e = dataclasses.replace(e, min=A, max=B)
    out = blockwise.blockwise_quantize_dequantize(
        W, 8, 1, 4, True, encoding=e, learn_range=learn_range)
    (out * _t(up)).sum().backward()
    np.testing.assert_array_equal(W.grad.numpy(), np.asarray(jdw))
    if not learn_range:
        assert not A.grad.any() and not B.grad.any()
        assert not np.asarray(jdmin).any() and not np.asarray(jdmax).any()
        return
    wb = w.reshape(8, 4, 8)
    tmin, tmax = _ref_terms(wb, mn, mx, up.reshape(8, 4, 8), 4, True, False)
    for got, want, terms in ((A.grad, jdmin, tmin), (B.grad, jdmax, tmax)):
        _assert_within_sum_bound(got.numpy(), terms, mn.shape, 8)
        _assert_within_sum_bound(want, terms, mn.shape, 8)
    # the default encoding (the blocks' own min-max) gives the same forward
    np.testing.assert_array_equal(
        blockwise.blockwise_quantize_dequantize(_t(w), 8, 1).numpy(),
        np.asarray(jblock.blockwise_quantize_dequantize(jnp.asarray(w), 8, 1)))


def test_stochastic_rounding_unbiased():
    """tests/test_affine.py::test_stochastic_rounding_unbiased in the port,
    with a torch.Generator for the key."""
    e = affine.compute_encoding_from_min_max(torch.tensor(0.0),
                                             torch.tensor(255.0), 8, False)
    x = torch.full((20000,), 10.4)
    q = affine.quantize(x, e.delta, e.offset, e.num_steps,
                        stochastic_key=torch.Generator().manual_seed(0))
    assert abs(q.mean().item() - 10.4) < 0.02
    assert set(q.unique().tolist()) == {10.0, 11.0}
    deq = affine.quantize_dequantize_encoding(
        x, e, stochastic_key=torch.Generator().manual_seed(1))
    assert abs(deq.mean().item() - 10.4) < 0.02
    # without a key: nearest rounding, as before
    assert torch.equal(affine.quantize(x, e.delta, e.offset, e.num_steps),
                       torch.full_like(x, 10.0))


@pytest.mark.parametrize("channel_axis", [None, 0, 1])
def test_fp8_maxval_searches_match_jax(channel_axis):
    rs = np.random.RandomState(7)
    x = (rs.randn(16, 24) * np.logspace(-1, 1, 24)).astype(np.float32)
    for jf, tf in ((jfs.init_fp8_maxval_minmax,
                    float_sim.init_fp8_maxval_minmax),
                   (jfs.init_fp8_maxval_mse, float_sim.init_fp8_maxval_mse)):
        want = np.asarray(jf(jnp.asarray(x), channel_axis))
        got = tf(_t(x), channel_axis).numpy()
        np.testing.assert_array_equal(got, want, err_msg=jf.__name__)
        # the cast's scale 2 ** t: t = log_scale - m - bias sums terms up
        # to 2^e = 16, which the two frameworks round apart (log2, order)
        # by ulps of 16 (2^-19); 2 ** t carries that as ln2 * dt relative,
        # under 4 * 2^-19 for 4 ulps (the JAX package's own jitted and eager
        # casts disagree as much)
        np.testing.assert_allclose(
            float_sim.quantize_to_fp8(_t(x), torch.from_numpy(got),
                                      channel_axis).numpy(),
            np.asarray(jfs.quantize_to_fp8(jnp.asarray(x), want,
                                           channel_axis)),
            rtol=4 * 2.0 ** -19, atol=0)


@pytest.fixture(scope="module")
def mlp_sims():
    jp, tm, x, batches = mlp_pair()
    js = JaxSim(jax_mlp, (jp, jnp.asarray(x)), quant_scheme="minmax")
    js.compute_encodings(jp, iter([jnp.asarray(b) for b in batches]))
    ts = QuantizationSimModel(tm, (torch.from_numpy(x),),
                              quant_scheme="minmax", device="cpu")
    ts.compute_encodings(None, [torch.from_numpy(b) for b in batches])
    for k, v in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, v)
    return js, ts, jp, x


def _enc_fields(e):
    return [np.asarray(getattr(e, f)) for f in ("min", "max", "delta",
                                                 "offset")]


def test_set_quantizer_data_type_round_trip(mlp_sims):
    js, ts, jp, x = mlp_sims
    name = "w1"
    jname = "['w1']"
    before = _enc_fields(ts.encodings[name])
    tx = torch.from_numpy(x)
    try:
        for dt, bw in (("float", 16), ("float", 8), ("int", 8)):
            js.set_quantizer_data_type(jname, dt, bw)
            ts.set_quantizer_data_type(name, dt, bw)
            spec = ts.quantizers[name]
            assert (spec.data_type, spec.bitwidth) == (dt, bw)
            want = np.asarray(js.quantized_fn(jp, jnp.asarray(x)))
            got = ts.quantized_fn(None, tx).numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        for a, b in zip(_enc_fields(ts.encodings[name]), before):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            _enc_fields(ts.encodings[name])[0],
            np.asarray(js.encodings[jname].min))
        # back at another bitwidth: the grid recomputed from the weights
        ts.set_quantizer_data_type(name, "int", 4)
        js.set_quantizer_data_type(jname, "int", 4)
        for a, b in zip(_enc_fields(ts.encodings[name]),
                        _enc_fields(js.encodings[jname])):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError):
            ts.set_quantizer_data_type(name, "fp8")
    finally:
        js.set_quantizer_data_type(jname, "int", 8)
        ts.set_quantizer_data_type(name, "int", 8)


def _close_to_jax(got32, got64, want, what):
    got32, got64, want = (np.asarray(a, np.float64) for a in
                          (got32, got64, want))
    gap = np.abs(got32 - got64).max()
    tol = 4 * gap + 2 * U * np.abs(got64).max()
    err = np.abs(got32 - want).max()
    assert err <= tol, (what, err, tol)


def _encodings_close_to_jax(ge, ge64, jg_e):
    """Every quantizer's (min) gradients as one vector, and (max)'s: a
    per-tensor encoding's gradient is one number, whose own f32 gap can
    be near 0 by chance, so the yardstick is the largest gap over all."""
    names = sorted(ge)
    assert names == sorted(convert.port_param_name(k) for k in jg_e)
    if not names:
        return
    jflat = {convert.port_param_name(k): v for k, v in jg_e.items()}
    for i in (0, 1):
        cat = lambda d, f: np.concatenate(
            [np.asarray(f(d[n][i]), np.float64).reshape(-1) for n in names])
        _close_to_jax(cat(ge, _np), cat(ge64, _np), cat(jflat, np.asarray),
                      ("min", "max")[i])


def _np(t):
    return t.detach().numpy()


def _loss_grads_port(apply, params, enc, x, up):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    leaves = list(params.values())
    if enc is not None:
        enc = {k: (a.detach().clone().requires_grad_(True),
                   b.detach().clone().requires_grad_(True))
               for k, (a, b) in enc.items()}
        for a, b in enc.values():
            leaves += [a, b]
        out = apply(params, enc, x)
    else:
        out = apply(params, x)
    g = torch.autograd.grad((out * up).sum(), leaves, allow_unused=True)
    gp = dict(zip(params, g[:len(params)]))
    ge = {}
    if enc is not None:
        it = iter(g[len(params):])
        ge = {k: (next(it), next(it)) for k in enc}
    return gp, ge


def _port_pair(ts, ts64, learn_range, x, x64, up):
    """Port gradients in f32 and in f64 (the f64 sim given the f32 sim's
    encodings)."""
    for k, e in ts.encodings.items():
        ts64.set_encoding(k, dataclasses.replace(
            e, min=e.min.double(), max=e.max.double(),
            delta=e.delta.double(), offset=e.offset.double()))
    out = []
    for sim, xx, dt in ((ts, x, torch.float32), (ts64, x64, torch.float64)):
        # the twin's own dtypes: a model may keep some parts in f32
        params = {k: v.to(sim.params[k].dtype) for k, v in ts.params.items()}
        upd = up.to(dt)
        if learn_range:
            apply, enc = sim.qat_fn()
            out.append(_loss_grads_port(apply, params, enc, xx, upd))
        else:
            out.append(_loss_grads_port(sim.static_grid_qat_fn(), params,
                                        None, xx, upd))
    return out


def _mlp64(jp):
    from torch_quantsim_util import TorchMLP
    return TorchMLP({k: np.asarray(v, np.float64) for k, v in jp.items()})


@pytest.mark.parametrize("learn_range", [True, False],
                         ids=["qat_fn", "static_grid_qat_fn"])
def test_mlp_qat_grads_match_jax(mlp_sims, learn_range):
    js, ts, jp, x = mlp_sims
    rs = np.random.RandomState(11)
    out_shape = np.asarray(js.quantized_fn(jp, jnp.asarray(x))).shape
    up = rs.randn(*out_shape).astype(np.float32)
    if learn_range:
        apply, enc0 = js.qat_fn()          # eager, as on tiny
        jg_p, jg_e = jax.grad(
            lambda p, e: jnp.sum(apply(p, e, jnp.asarray(x)) * up),
            argnums=(0, 1))(jp, enc0)
    else:
        apply = js.static_grid_qat_fn()
        jg_p = jax.jit(jax.grad(
            lambda p: jnp.sum(apply(p, jnp.asarray(x)) * up)))(jp)
        jg_e = {}
    ts64 = QuantizationSimModel(_mlp64(jp), (torch.from_numpy(x).double(),),
                                quant_scheme="minmax", device="cpu")
    (gp, ge), (gp64, ge64) = _port_pair(
        ts, ts64, learn_range, torch.from_numpy(x),
        torch.from_numpy(x).double(), torch.from_numpy(up))
    assert set(gp) == set(jg_p)
    for k in gp:
        _close_to_jax(gp[k], gp64[k], jg_p[k], k)
    _encodings_close_to_jax(ge, ge64, jg_e)
    if learn_range:
        assert any(np.abs(ge[k][1].numpy()).max() > 0 for k in ge)


class _F64Torch:
    """``torch`` with ``float32`` read as ``float64``."""
    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@pytest.fixture(scope="module")
def tiny_param_sims():
    """Both packages' sims on tiny with only their parameter encodings (no
    activation encodings: those quantizers stay off), the JAX encodings
    carried across; and the port's f64 twin."""
    fn, variables, tm, tok, batches = tiny_numpy_pair()
    js = JaxSim(fn, (variables, jnp.asarray(tok)), quant_scheme="minmax")
    js.compute_param_encodings(variables)
    ts = QuantizationSimModel(tm, (to_torch(tok),), quant_scheme="minmax",
                              device="cpu")
    for k, v in convert.encodings_from_jax(js.encodings,
                                           device="cpu").items():
        ts.set_encoding(k, v)
    assert set(ts.encodings) == {k for k, s_ in ts.quantizers.items()
                                 if s_.kind == "param"}
    # the f64 twin: the model keeps its attention scores, RMSNorm variance,
    # rope and lm_head in f32 by name (``torch.float32``); built and traced
    # with that name read as f64, every part of it computes in f64
    cfg64 = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer_module, "torch", _F64Torch())
        tm64 = Transformer(cfg64).double()
        tm64.load_state_dict({k: v.double()
                              for k, v in tm.state_dict().items()})
        ts64 = QuantizationSimModel(tm64, (to_torch(tok),),
                                    quant_scheme="minmax", device="cpu")
    assert all(p.dtype == torch.float64 for p in ts64.params.values())
    return js, ts, ts64, variables, tok


@pytest.mark.parametrize("learn_range", [True, False],
                         ids=["qat_fn", "static_grid_qat_fn"])
def test_tiny_qat_grads_match_jax(tiny_param_sims, learn_range):
    js, ts, ts64, variables, tok = tiny_param_sims
    rs = np.random.RandomState(13)
    jt = jnp.asarray(tok)
    up = rs.randn(*np.asarray(js.quantized_fn(variables, jt)).shape).astype(
        np.float32) * 0.1
    if learn_range:
        # eager: jitted, XLA multiplies by 1 / delta, which moves the
        # range gradients' cancelling terms by more than f32 sums do
        apply, enc0 = js.qat_fn()
        jg_p, jg_e = jax.grad(lambda p, e: jnp.sum(apply(p, e, jt) * up),
                              argnums=(0, 1))(variables, enc0)
    else:
        apply = js.static_grid_qat_fn()
        jg_p = jax.jit(jax.grad(lambda p: jnp.sum(apply(p, jt) * up)))(
            variables)
        jg_e = {}
    (gp, ge), (gp64, ge64) = _port_pair(ts, ts64, learn_range, to_torch(tok),
                                        to_torch(tok), torch.from_numpy(up))
    flat = {convert.port_param_name(jax.tree_util.keystr(p)): v
            for p, v in jax.tree_util.tree_leaves_with_path(jg_p)}
    assert set(gp) == set(flat)
    for k in gp:
        _close_to_jax(gp[k], gp64[k], flat[k], k)
    _encodings_close_to_jax(ge, ge64, jg_e)


def test_update_encodings_from_qat_matches_jax(mlp_sims):
    js, ts, jp, x = mlp_sims
    saved_j, saved_t = dict(js.encodings), dict(ts.encodings)
    try:
        _, jenc = js.qat_fn()
        apply, tenc = ts.qat_fn()
        rs = np.random.RandomState(17)
        moved_j, moved_t = {}, {}
        for k, (a, b) in jenc.items():
            da = rs.uniform(-0.05, 0.05, np.shape(a)).astype(np.float32)
            db = rs.uniform(-0.05, 0.05, np.shape(b)).astype(np.float32)
            moved_j[k] = (a + da, b + db)
            name = convert.port_param_name(k)
            ta, tb = tenc[name]
            moved_t[name] = (ta + torch.from_numpy(da).reshape(ta.shape),
                             tb + torch.from_numpy(db).reshape(tb.shape))
        # qat_fn's encodings are copies: moving them leaves the sim's as is
        assert all(torch.equal(ts.encodings[k].min, saved_t[k].min)
                   for k in tenc)
        js.update_encodings_from_qat(moved_j)
        ts.update_encodings_from_qat(moved_t)
        for k in jenc:
            for a, b in zip(_enc_fields(ts.encodings[
                    convert.port_param_name(k)]),
                    _enc_fields(js.encodings[k])):
                np.testing.assert_array_equal(a, b)
    finally:
        js._encodings.update(saved_j)
        ts._encodings.update(saved_t)
