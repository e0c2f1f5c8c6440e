"""aimet_tpu_torch.algorithms.adaround and .seq_mse against the JAX
package's, on tests/test_adaround_seqmse.py's TinyMLP and
tests/test_ptq.py's TinyCNN (weights made with numpy and carried across,
tests/torch_ptq_util.py), with the JAX test's own checks in the port.

Tolerances:
- AdaRound, 20 iterations from the same weights, grids and batches: α
  within ALPHA_TOL (measured: at most 1.6e-6) of the JAX package's
  (both packages' reconstruction losses sum in another order); the hard
  roundings may differ only where |α| < FLIP_ALPHA in both (measured: none
  differ), and the rounded weights elsewhere are equal within 1e-6 of
  their max.
- SeqMSE: every layer's chosen encoding equal to the JAX package's
  within 1e-6 relative (the same candidate per channel; an exact tie in
  the loss could pick another, none occurs here).

The captured CUDA-graph loop runs only on the card
(tests/test_torch_cuda_ptq.py); here the loop is eager.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aimet_tpu.algorithms.adaround as jada
import aimet_tpu_torch.algorithms.adaround as tada
from aimet_tpu_torch.algorithms import seq_mse
from aimet_tpu.algorithms.seq_mse import apply_seq_mse as jax_seq_mse
from aimet_tpu.quantsim.config import QuantSimConfig as JaxConfig
from aimet_tpu.quantsim.qsim import QuantizationSimModel as JaxSim
from aimet_tpu_torch import QuantizationSimModel, QuantSimConfig, convert
from aimet_tpu_torch.algorithms import (AdaroundParameters, apply_adaround,
                                        apply_seq_mse)
from torch_ptq_util import from_flax, nchw, one_thread, pair

ALPHA_TOL = 1e-4
FLIP_ALPHA = 1e-3


def _port_sim(name, per_channel=False, n_batches=3, scheme="minmax"):
    """(jax fn, variables, port model, calibrated port sim, batches, x)."""
    fn, v, tm, x, rs = pair(name)
    batches = [rs.randn(*x.shape).astype(np.float32)
               for _ in range(n_batches)]
    ts = QuantizationSimModel(
        tm, (nchw(x),), quant_scheme=scheme, default_param_bw=4,
        device="cpu",
        config=QuantSimConfig.per_channel_default() if per_channel else None)
    ts.compute_encodings(None, [nchw(b) for b in batches])
    return fn, v, tm, ts, batches, x


def _sims(name, per_channel=False, n_batches=3, scheme="minmax"):
    """``_port_sim``'s and the JAX package's sim on the same weights and
    batches."""
    fn, v, tm, ts, batches, x = _port_sim(name, per_channel, n_batches,
                                          scheme)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    js = JaxSim(fn, (jv, jnp.asarray(x)), quant_scheme=scheme,
                default_param_bw=4,
                config=JaxConfig.per_channel_default() if per_channel
                else None)
    js.compute_encodings(jv, iter([jnp.asarray(b) for b in batches]))
    return fn, v, jv, js, tm, ts, batches


def _jax_layout(a):
    """A port weight-shaped array (OIHW) in the JAX package's (HWIO)."""
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def test_h_alpha_and_alpha_init_match_jax():
    a = np.linspace(-10, 10, 101).astype(np.float32)
    h = tada._h_alpha(torch.from_numpy(a)).numpy()
    assert h.min() == 0.0 and h.max() == 1.0 and np.all(np.diff(h) >= 0)
    np.testing.assert_allclose(h, np.asarray(jada._h_alpha(jnp.asarray(a))),
                               atol=1e-7)
    rs = np.random.RandomState(0)
    w = rs.randn(32).astype(np.float32)
    alpha = tada._alpha_init(torch.from_numpy(w), torch.tensor(0.1))
    np.testing.assert_allclose(
        alpha.numpy(), np.asarray(jada._alpha_init(jnp.asarray(w),
                                                   jnp.float32(0.1))),
        rtol=1e-5, atol=1e-6)
    # h(alpha_init) is the fractional part: soft quant at init is w
    rest = w / np.float32(0.1) - np.floor(w / np.float32(0.1))
    np.testing.assert_allclose(tada._h_alpha(alpha).numpy(), rest,
                               atol=2e-4)


@pytest.mark.parametrize("name,per_channel", [("tiny_mlp", False),
                                              ("tiny_cnn", True)])
def test_adaround_alpha_matches_jax(monkeypatch, name, per_channel):
    fn, v, jv, js, tm, ts, batches = _sims(name, per_channel)
    jal, tal = [], []
    soft_quant = jada._soft_quant

    def record(w, d, o, ns, alpha, soft=True):
        if not soft:
            jal.append(np.asarray(alpha))
        return soft_quant(w, d, o, ns, alpha, soft)

    hard = tada._RoundingOptimizer.hard_weight

    def record_port(self):
        tal.append(self.alpha.detach().numpy().copy())
        return hard(self)

    monkeypatch.setattr(jada, "_soft_quant", record)
    monkeypatch.setattr(tada._RoundingOptimizer, "hard_weight", record_port)
    want = jada.apply_adaround(js, jv, [jnp.asarray(b) for b in batches],
                               jada.AdaroundParameters(num_batches=2,
                                                       num_iterations=20))
    got = apply_adaround(ts, None, [nchw(b) for b in batches],
                         AdaroundParameters(num_batches=2,
                                            num_iterations=20))
    assert len(jal) == len(tal) == 3
    for a, b in zip(jal, tal):
        b = _jax_layout(b)
        assert np.abs(a - b).max() <= ALPHA_TOL
        flips = (a >= 0) != (b >= 0)
        assert (np.abs(a[flips]) < FLIP_ALPHA).all()
        assert (np.abs(b[flips]) < FLIP_ALPHA).all()
    for k, w in from_flax(want).items():
        w, g = w.numpy(), got[k].numpy()
        np.testing.assert_allclose(g, w, atol=1e-6 * np.abs(w).max(),
                                   rtol=0, err_msg=k)


def test_adaround_weights_on_grid_frozen_and_better():
    """tests/test_adaround_seqmse.py::test_adaround_weights_on_grid_and_better
    in the port."""
    fn, v, tm, ts, batches, x = _port_sim("tiny_mlp")
    xs = [torch.from_numpy(b) for b in batches]
    new = apply_adaround(ts, None, xs, AdaroundParameters(
        num_batches=3, num_iterations=200))
    for op in ts.graph.ops_of_type("linear"):
        kpath = op.param_products["kernel"].param_path
        q = new[kpath].numpy() / float(ts.encodings[kpath].delta)
        np.testing.assert_allclose(q, np.round(q), atol=1e-3)
        assert kpath in ts._frozen
    ref = ts.fp_fn(None, xs[0])
    err_nearest = (ts.quantized_fn(None, xs[0]) - ref).abs().mean()
    err_ada = (ts.quantized_fn(new, xs[0]) - ref).abs().mean()
    assert err_ada < err_nearest
    # the caller's params are untouched
    assert all(torch.equal(p, ts.params[k]) for k, p in tm.state_dict()
               .items())


def test_adaround_cache_dir_resumes(tmp_path, monkeypatch):
    fn, v, tm, ts, batches, x = _port_sim("tiny_mlp")
    xs = [torch.from_numpy(b) for b in batches]
    cfg = AdaroundParameters(num_batches=2, num_iterations=10)
    first = apply_adaround(ts, None, xs, cfg, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("adaround.linear_*.npz"))) == 3

    def never(*a, **k):
        raise AssertionError("a cached layer was optimized again")

    monkeypatch.setattr(tada, "optimize_layer_rounding", never)
    again = apply_adaround(ts, None, xs, cfg, cache_dir=str(tmp_path))
    for k in first:
        assert torch.equal(first[k], again[k])
    # other input weights: the cache does not apply
    changed = {k: p * 1.5 for k, p in ts.params.items()}
    with pytest.raises(AssertionError, match="optimized again"):
        apply_adaround(ts, changed, xs, cfg, cache_dir=str(tmp_path))


@pytest.mark.parametrize("name,per_channel,loss,inp", [
    ("tiny_mlp", True, "mse", "symqt"), ("tiny_mlp", False, "mse", "symqt"),
    ("tiny_cnn", True, "neg_sqnr", "asym"), ("tiny_cnn", True, "mse",
                                             "symfp")])
def test_seq_mse_matches_jax(monkeypatch, name, per_channel, loss, inp):
    fn, v, jv, js, tm, ts, batches = _sims(name, per_channel)
    want = jax_seq_mse(js, jv, [jnp.asarray(b) for b in batches],
                       num_candidates=20, loss_fn=loss, inp_symmetry=inp)
    # small chunks: the candidates in several vmapped pieces
    monkeypatch.setattr(seq_mse, "CPU_CHUNK_BYTES", 20000)
    got = apply_seq_mse(ts, None, [nchw(b) for b in batches],
                        num_candidates=20, loss_fn=loss, inp_symmetry=inp)
    assert got == want and len(got) == 3
    assert {convert.port_param_name(k) for k in js._frozen} == ts._frozen
    for k in js._frozen:
        je, te = js.encodings[k], ts.encodings[convert.port_param_name(k)]
        for f in ("min", "max", "delta", "offset"):
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.asarray(getattr(je, f)),
                                       rtol=1e-6, atol=1e-8, err_msg=(k, f))


def test_seq_mse_freezes_and_improves(monkeypatch):
    """tests/test_adaround_seqmse.py's SeqMSE checks in the port: frozen
    per-channel encodings that survive a recalibration, the 1.05 bound,
    per-tensor and neg_sqnr runs, and the chunking not changing the
    choice."""
    fn, v, tm, ts, batches, x = _port_sim("tiny_mlp", per_channel=True)
    xs = [torch.from_numpy(b) for b in batches]
    ref = ts.fp_fn(None, xs[0])
    err_before = float((ts.quantized_fn(None, xs[0]) - ref).abs().mean())
    assert len(apply_seq_mse(ts, None, xs, num_candidates=20)) == 3
    assert len(ts._frozen) == 3
    chosen = {k: ts.encodings[k] for k in ts._frozen}
    ts.compute_encodings(None, xs)
    for k, e in chosen.items():
        assert ts.encodings[k] is e
    err_after = float((ts.quantized_fn(None, xs[0]) - ref).abs().mean())
    assert err_after <= err_before * 1.05

    fn, v, tm, ts2, batches, x = _port_sim("tiny_mlp", per_channel=True)
    with monkeypatch.context() as m:
        m.setattr(seq_mse, "CPU_CHUNK_BYTES", 1)     # a candidate a chunk
        apply_seq_mse(ts2, None, xs, num_candidates=20)
    for k, e in chosen.items():
        assert torch.equal(ts2.encodings[k].max, e.max)

    fn, v, tm, ts3, batches, x = _port_sim("tiny_mlp")
    assert apply_seq_mse(ts3, None, xs, num_candidates=10)
    assert torch.isfinite(ts3.quantized_fn(None, xs[0])).all()
    with pytest.raises(ValueError):
        apply_seq_mse(ts3, None, xs, loss_fn="l1")
