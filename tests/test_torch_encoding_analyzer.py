"""aimet_tpu_torch.quantization.encoding_analyzer against aimet_tpu's on
the same numpy batches. Observer states (running min/max; the 512-bin
PDF's edges, density and counts) bit for bit against the JAX updates run
op by op. Encodings: min-max bit for bit; SQNR (the port's copy of the
C++ search) bit for bit against the JAX package's numpy search
(``USE_NATIVE`` off) on these batches, and within 1e-6 relative of its
native C++ search. The percentile, mse and entropy schemes are held to
the JAX package in tests/test_torch_native_search.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimet_tpu.quantization import encoding_analyzer as jea
from aimet_tpu_torch.quantization import encoding_analyzer as tea

FIELDS = ("min", "max", "delta", "offset")
GRIDS = [(8, False, False, False), (8, True, False, False),
         (8, True, True, False), (8, True, False, True),
         (4, True, False, False), (4, False, False, False)]


def _batches(channel_axis=None, relu=False):
    rng = np.random.RandomState(0)
    shape = (6, 40) if channel_axis is None else (5, 3, 24)
    out = [(rng.randn(*shape) * s + o).astype(np.float32)
           for s, o in ((1.0, 0.2), (2.5, -0.3), (0.7, 1.0))]
    return [np.maximum(b, 0) for b in out] if relu else out


def _observe(scheme, batches, channel_axis):
    ja = jea.EncodingAnalyzer(scheme, channel_axis=channel_axis)
    ta = tea.EncodingAnalyzer(scheme, channel_axis=channel_axis)
    js = ja.init_state(batches[0].shape)
    ts = ta.init_state(batches[0].shape, device="cpu")
    for b in batches:
        js = ja.update(js, jnp.asarray(b))
        ts = ta.update(ts, torch.from_numpy(b))
    return ja, js, ta, ts


@pytest.mark.parametrize("scheme", ["minmax", "sqnr"])
@pytest.mark.parametrize("channel_axis", [None, 1])
def test_observer_states_bit_for_bit(scheme, channel_axis):
    _, js, _, ts = _observe(scheme, _batches(channel_axis), channel_axis)
    names = ("min", "max", "updated") if scheme == "minmax" else (
        "xleft", "pdf", "iterations", "initialized", "updated")
    for f in names:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("bw,sym,strict,unsigned", GRIDS)
@pytest.mark.parametrize("scheme,channel_axis",
                         [("minmax", None), ("minmax", 1), ("sqnr", None),
                          ("sqnr", 1)])
def test_encodings_bit_for_bit(monkeypatch, scheme, channel_axis, bw, sym,
                               strict, unsigned):
    monkeypatch.setattr(jea, "USE_NATIVE", False)
    ja, js, ta, ts = _observe(scheme, _batches(channel_axis, relu=unsigned),
                              channel_axis)
    want = ja.compute(js, bw, sym, strict, unsigned)
    got = ta.compute(ts, bw, sym, strict, unsigned)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("sym", [False, True])
def test_sqnr_against_native_search(sym):
    ja, js, ta, ts = _observe("sqnr", _batches(), None)
    want = ja.compute(js, 8, sym)       # native C++ search when it builds
    got = ta.compute(ts, 8, sym)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_all_zero_data_and_no_data():
    ja, js, ta, ts = _observe("sqnr", [np.zeros((4, 8), np.float32)], None)
    want, got = ja.compute(js, 8, False), ta.compute(ts, 8, False)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for scheme in ("minmax", "sqnr"):
        ta = tea.EncodingAnalyzer(scheme)
        with pytest.raises(RuntimeError):
            ta.compute(ta.init_state(device="cpu"))


@pytest.mark.parametrize("scheme", ["percentile", "mse", "entropy"])
def test_unported_schemes_raise(scheme):
    """Once unported, now ported: each scheme constructs, refuses to
    compute before any data, and an unknown scheme still raises."""
    ta = tea.EncodingAnalyzer(scheme)
    with pytest.raises(RuntimeError):
        ta.compute(ta.init_state(device="cpu"))
    with pytest.raises(ValueError):
        tea.EncodingAnalyzer("nope")
