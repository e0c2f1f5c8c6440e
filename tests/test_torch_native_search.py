"""The port's C++ encoding searches (``aimet_tpu_torch.native``, its own
copy of ``encoding_search.cpp``) against the port's numpy searches, and
the percentile / mse / entropy analyzers against the JAX package's on the
same numpy batches.

Tolerances:
- C++ against numpy: SQNR and percentile rtol 1e-9 (as
  tests/test_native.py); MSE rtol 1e-6 (the numpy search takes its
  candidates' grids in float32, the C++ in float64).
- Analyzers: the 512-bin PDF of percentile / mse bit for bit (the sqnr
  observer, tests/test_torch_encoding_analyzer.py); the auto-rescaling
  histogram's counts within 1e-6 of their max (the rescale is a float32
  matmul, summed in another order) and its range bit for bit; the
  percentile and mse encodings bit for bit (both packages call the same
  C++ search on the same PDF); entropy encodings bit for bit from the
  same state, and within 1e-6 relative from each package's own state.
"""
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.quantization import encoding_analyzer as jea
from aimet_tpu_torch import native
from aimet_tpu_torch.quantization import encoding_analyzer as tea
from torch_ptq_util import one_thread

FIELDS = ("min", "max", "delta", "offset")
GRIDS = [(8, False, False, False), (8, True, False, False),
         (8, True, True, False), (8, True, False, True),
         (4, False, False, False)]


def _state(seed, dist="normal"):
    rs = np.random.RandomState(seed)
    x = rs.randn(50000)
    if dist == "outlier":
        x = np.concatenate([x, [30.0]])
    elif dist == "positive":
        x = np.abs(x)
    st = tea.update_histogram(tea.HistogramState.init(device="cpu"),
                              torch.from_numpy(x.astype(np.float32)))
    return st.xleft.double().numpy(), st.pdf.double().numpy()


@pytest.mark.parametrize("dist", ["normal", "outlier", "positive"])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bw", [4, 8])
def test_sqnr_search_matches_numpy(dist, sym, bw):
    xleft, pdf = _state(bw, dist)
    want = tea._sqnr_search(xleft, pdf, bw, sym, False, False)
    got = native.sqnr_search(xleft, pdf, bw, sym, False, False)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("pct", [100.0, 99.9, 99.0, 90.0])
def test_percentile_range_matches_numpy(pct):
    xleft, pdf = _state(1)
    np.testing.assert_allclose(native.percentile_range(xleft, pdf, pct),
                               tea._percentile_range(xleft, pdf, pct),
                               rtol=1e-9)


@pytest.mark.parametrize("dist", ["normal", "outlier"])
@pytest.mark.parametrize("bw", [4, 8])
def test_mse_search_matches_numpy(dist, bw):
    xleft, pdf = _state(2, dist)
    np.testing.assert_allclose(
        native.mse_search(xleft, pdf, bw, False, False, False),
        tea._mse_search(xleft, pdf, bw, False, False, False), rtol=1e-6)


def test_batched_search_equals_one_call_a_row():
    states = [_state(i, d) for i, d in enumerate(("normal", "outlier",
                                                   "positive"))]
    xleft = np.stack([s[0] for s in states])
    pdf = np.stack([s[1] for s in states])
    out = native.sqnr_search_batch(xleft, pdf, 8, True)
    assert out.shape == (3, 4)
    for i in range(3):
        np.testing.assert_array_equal(
            out[i], native.sqnr_search(xleft[i], pdf[i], 8, True))
    with pytest.raises(ValueError):
        native.sqnr_search_batch(xleft[:, :100], pdf[:, :100], 8, True)


def test_search_library_without_a_compiler_raises(monkeypatch, tmp_path):
    """No numpy fallback: a library that cannot be built raises from the
    analyzer's compute."""
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    native.library.cache_clear()
    try:
        ta = tea.EncodingAnalyzer("sqnr")
        st = ta.update(ta.init_state(device="cpu"), torch.randn(64))
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            ta.compute(st)
    finally:
        native.library.cache_clear()


def _batches(channel_axis=None, relu=False, seed=0):
    rs = np.random.RandomState(seed)
    shape = (6, 40) if channel_axis is None else (5, 3, 24)
    # widening ranges, so the entropy histogram rescales twice
    out = [(rs.randn(*shape) * s + o).astype(np.float32)
           for s, o in ((1.0, 0.2), (2.5, -0.3), (4.0, 1.0))]
    return [np.maximum(b, 0) for b in out] if relu else out


@functools.lru_cache(maxsize=None)
def _observed(scheme, channel_axis, relu=False, percentile=100.0):
    return _observe(scheme, _batches(channel_axis, relu), channel_axis,
                    percentile)


def _observe(scheme, batches, channel_axis, percentile=100.0):
    ja = jea.EncodingAnalyzer(scheme, channel_axis=channel_axis,
                              percentile=percentile)
    ta = tea.EncodingAnalyzer(scheme, channel_axis=channel_axis,
                              percentile=percentile)
    js = ja.init_state(batches[0].shape)
    ts = ta.init_state(batches[0].shape, device="cpu")
    for b in batches:
        js = ja.update(js, jnp.asarray(b))
        ts = ta.update(ts, torch.from_numpy(b))
    return ja, js, ta, ts


@pytest.mark.parametrize("channel_axis", [None, 1])
def test_rescaling_histogram_matches_jax(channel_axis):
    _, js, _, ts = _observed("entropy", channel_axis)
    assert isinstance(ts, tea.RescalingHistogramState)
    for f in ("min", "max", "initialized", "updated"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    want = np.asarray(js.hist)
    np.testing.assert_allclose(ts.hist.numpy(), want,
                               atol=1e-6 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(ts.hist.numpy().sum(-1), want.sum(-1),
                               rtol=1e-6)


def test_rescaling_histogram_all_zero_batch_keeps_state():
    st = tea.update_rescaling_histogram(
        tea.RescalingHistogramState.init(device="cpu"), torch.zeros(16))
    assert bool(st.updated) and not bool(st.initialized)
    assert float(st.hist.sum()) == 0.0


@pytest.mark.parametrize(
    "scheme,channel_axis,percentile,bw,sym,strict,unsigned",
    [("percentile", None, 99.9, *g) for g in GRIDS]
    + [("mse", None, 100.0, *g) for g in GRIDS]
    + [("percentile", 1, 90.0, *GRIDS[1]), ("mse", 1, 100.0, *GRIDS[3])])
def test_percentile_and_mse_encodings_match_jax(scheme, channel_axis,
                                                percentile, bw, sym, strict,
                                                unsigned):
    """Per tensor on every grid, per channel (a search a channel) on
    one each."""
    ja, js, ta, ts = _observed(scheme, channel_axis, unsigned, percentile)
    for f in ("xleft", "pdf"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    want = ja.compute(js, bw, sym, strict, unsigned)
    got = ta.compute(ts, bw, sym, strict, unsigned)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("channel_axis,bw,sym,strict,unsigned", [
    (None, 8, False, False, False), (None, 4, False, False, False),
    (None, 4, True, False, False), (None, 4, True, True, False),
    (None, 4, True, False, True), (1, 4, True, False, True)])
def test_entropy_encodings_match_jax(channel_axis, bw, sym, strict,
                                     unsigned):
    """Per tensor on each kind of grid, per channel (3 channels, a KL
    search each) on one; mostly at 4 bits, whose 15-bin windows keep the
    search's Python loop short."""
    ja, js, ta, ts = _observed("entropy", channel_axis, unsigned)
    # the same state through both searches: bit for bit
    same = tea.RescalingHistogramState(
        *(torch.from_numpy(np.array(getattr(js, f))) for f in
          ("hist", "min", "max", "initialized", "updated")))
    want = ja.compute(js, bw, sym, strict, unsigned)
    got = ta.compute(same, bw, sym, strict, unsigned)
    own = ta.compute(ts, bw, sym, strict, unsigned)
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)
        np.testing.assert_allclose(getattr(own, f).numpy(), w, rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_kl_helpers_match_jax():
    rs = np.random.RandomState(3)
    hist = np.floor(np.abs(rs.randn(512)) * 50)
    hist[:40] = 0
    np.testing.assert_array_equal(tea._condition_histogram(hist),
                                  jea._condition_histogram(hist))
    p, q = hist[40:] + 1, hist[40:][::-1] + 1
    assert tea._compute_kl(p, q) == jea._compute_kl(p, q)
    np.testing.assert_array_equal(
        tea._rescale_hist_np(hist, -1.0, 2.0, -2.0, 2.0),
        jea._rescale_hist_np(hist, -1.0, 2.0, -2.0, 2.0))
    for args in ((8, True, False, False), (4, False, True, False)):
        assert tea._optimize_kl(hist, -1.0, 2.0, *args) == \
            jea._optimize_kl(hist, -1.0, 2.0, *args)
