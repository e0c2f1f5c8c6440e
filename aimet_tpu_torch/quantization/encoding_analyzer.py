"""Calibration observers and encoding analyzers — counterpart of
``aimet_tpu/quantization/encoding_analyzer.py``.

Design split, as in the JAX package:
  - ``update(state, x)`` runs on the device once per calibration batch: a
    running min/max, or the reference's 512-bin running-mean PDF whose
    range the first batch fixes (3x enlarged; out-of-range values are
    dropped). It never waits for the device.
  - ``compute(state, ...)`` runs once at the end of calibration on the
    host (numpy): the min-max gating, or the TF-enhanced SQNR grid search
    (candidates and GAMMA = 3.0 cost of TfEnhancedEncodingAnalyzer.cpp).
    The port keeps its own numpy copy of the search.

Schemes ported: ``minmax`` and ``sqnr`` (the default activation scheme).
``percentile``, ``mse`` and ``entropy`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops._common import div_ieee
from .affine import (AffineEncoding, compute_encoding_from_min_max,
                     gate_min_max, num_quant_steps)

PDF_SIZE = 512
MIN_RANGE = 0.01
GAMMA = 3.0  # saturation-cost weight (TfEnhancedEncodingAnalyzer.h:102)

SCHEMES = ("minmax", "sqnr", "percentile", "mse", "entropy")
PORTED_SCHEMES = ("minmax", "sqnr")


# ---------------------------------------------------------------------------
# Observer states and device-side updates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MinMaxState:
    """Running min/max. Leading dims = channel dims (or none)."""
    min: torch.Tensor
    max: torch.Tensor
    updated: torch.Tensor      # bool

    @classmethod
    def init(cls, shape=(), device=None):
        return cls(min=torch.full(shape, math.inf, device=device),
                   max=torch.full(shape, -math.inf, device=device),
                   updated=torch.zeros(shape, dtype=torch.bool,
                                       device=device))


@dataclasses.dataclass
class HistogramState:
    """Fixed-grid 512-bin running-mean PDF (reference ``PDF`` struct)."""
    xleft: torch.Tensor        # (..., 512) left edges
    pdf: torch.Tensor          # (..., 512) running-mean probability density
    iterations: torch.Tensor   # (...,) int32
    initialized: torch.Tensor  # (...,) bool
    updated: torch.Tensor      # (...,) bool — any data seen (even all-zero)

    @classmethod
    def init(cls, shape=(), device=None):
        z = dict(device=device)
        return cls(xleft=torch.zeros(shape + (PDF_SIZE,), **z),
                   pdf=torch.zeros(shape + (PDF_SIZE,), **z),
                   iterations=torch.zeros(shape, dtype=torch.int32, **z),
                   initialized=torch.zeros(shape, dtype=torch.bool, **z),
                   updated=torch.zeros(shape, dtype=torch.bool, **z))


def update_min_max(state: MinMaxState, x: torch.Tensor) -> MinMaxState:
    """Rows of x (C, L) against a (C,) state, or any x against a 0-dim one
    (TfEncodingAnalyzer::updateStats)."""
    if state.min.dim() == 0:
        bmin, bmax = x.min().float(), x.max().float()
    else:
        bmin, bmax = x.amin(dim=1).float(), x.amax(dim=1).float()
    return MinMaxState(min=torch.minimum(state.min, bmin),
                       max=torch.maximum(state.max, bmax),
                       updated=torch.ones_like(state.updated))


def _initialize_pdf_edges(bmin, bmax):
    """InitializePdf (math_functions.cpp:208-241), signed variant; bmin,
    bmax (C,) -> left edges (C, 512)."""
    bmax = torch.where(bmin == bmax, bmin + 0.01, bmax)
    center = (bmax + bmin) / 2
    lo = center - 3 * (center - bmin)
    hi = center + 3 * (bmax - center)
    bucket = (hi - lo) / PDF_SIZE
    i = torch.arange(PDF_SIZE, dtype=torch.float32, device=bmin.device)
    return lo[:, None] + i[None, :] * bucket[:, None]


def _update_histogram_rows(state: HistogramState,
                           x: torch.Tensor) -> HistogramState:
    """UpdatePdf (math_functions.cpp:244-288) on each row of x (C, L) with a
    state of leading shape (C,)."""
    x = x.to(torch.float32)
    C, L = x.shape
    bmin, bmax = x.amin(dim=1), x.amax(dim=1)
    all_zero = (bmin == 0) & (bmax == 0)
    cand = _initialize_pdf_edges(bmin, bmax)
    init_now = ~state.initialized & ~all_zero
    xleft = torch.where(state.initialized[:, None], state.xleft, cand)
    active = state.initialized | init_now

    bucket = xleft[:, 1] - xleft[:, 0]
    safe = torch.where(bucket == 0, 1.0, bucket)
    idx = torch.round((x - xleft[:, :1]) / safe[:, None])
    valid = (idx >= 0) & (idx < PDF_SIZE)
    # exact integer counts (no host sync: the bin index is clamped and the
    # dropped values weigh 0)
    flat = (idx.clamp(0, PDF_SIZE - 1).to(torch.int64)
            + torch.arange(C, device=x.device)[:, None] * PDF_SIZE)
    counts = torch.zeros(C * PDF_SIZE, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat.reshape(-1), valid.reshape(-1).to(torch.int64))
    prob = div_ieee(counts.reshape(C, PDF_SIZE).to(torch.float32), float(L))
    iters = state.iterations.to(torch.float32)[:, None]
    new_pdf = (state.pdf * iters + prob) / (iters + 1)
    return HistogramState(
        xleft=xleft,
        pdf=torch.where(active[:, None], new_pdf, state.pdf),
        iterations=torch.where(active, state.iterations + 1,
                               state.iterations),
        initialized=active, updated=torch.ones_like(state.updated))


def update_histogram(state: HistogramState, x: torch.Tensor) -> HistogramState:
    """UpdatePdf on a 0-dim state (``x`` flattened) or on the rows of x
    (C, L) against a (C,) state."""
    if state.iterations.dim() == 0:
        one = HistogramState(*(t[None] for t in dataclasses.astuple(state)))
        out = _update_histogram_rows(one, x.reshape(1, -1))
        return HistogramState(*(t[0] for t in dataclasses.astuple(out)))
    return _update_histogram_rows(state, x)


# ---------------------------------------------------------------------------
# Host-side encoding computation (numpy)
# ---------------------------------------------------------------------------

def _fallback_encoding(bitwidth, symmetric, strict, unsigned):
    """All-zero-data fallback covering [-1, 1]
    (TfEnhancedEncodingAnalyzer::computeEncoding, .cpp:85-107)."""
    ns = num_quant_steps(bitwidth)
    delta = 2.0 / ns
    offset = math.floor(-1.0 / delta)
    mn = offset * delta
    mx = mn + ns * delta
    return float(mn), float(mx), float(delta), float(offset)


def _find_range_of_aggregate_stats(xleft: np.ndarray, pdf: np.ndarray):
    """First/last nonzero PDF bins, include 0, enforce MIN_RANGE
    (TfEnhancedEncodingAnalyzer.cpp:256-292)."""
    nz = np.nonzero(pdf > 0)[0]
    if nz.size == 0:
        mn, mx = float(xleft[0]), float(xleft[-1])
    else:
        mn, mx = float(xleft[nz[0]]), float(xleft[nz[-1]])
    mn = min(mn, 0.0)
    mx = max(mx, 0.0)
    mx = max(mx, mn + MIN_RANGE)
    return mn, mx


def _quant_and_sat_cost_vec(xleft, pdf, bitwidth, deltas, offsets):
    """_quantAndSatCost (TfEnhancedEncodingAnalyzer.cpp:307-350) over a
    batch of candidates. deltas/offsets: (K,). Returns (K,) costs."""
    ns = 2 ** bitwidth - 1
    pdf_start = xleft[0]
    pdf_step = xleft[1] - xleft[0]
    mids = pdf_start + np.arange(PDF_SIZE) * pdf_step + pdf_step / 2

    min_val = deltas * offsets
    max_val = deltas * (offsets + ns)
    min_ind = np.clip(np.floor((min_val - pdf_start) / pdf_step).astype(
        np.int64), 0, PDF_SIZE - 1)
    max_ind = np.clip(np.floor((max_val - pdf_start) / pdf_step).astype(
        np.int64), 0, PDF_SIZE - 1)

    bins = np.arange(PDF_SIZE)[None, :]
    min_mid = mids[min_ind][:, None]
    max_mid = mids[max_ind][:, None]

    in_bottom = bins < min_ind[:, None]
    in_top = bins >= max_ind[:, None]
    in_mid = ~(in_bottom | in_top)

    sat_bottom = np.sum(pdf[None, :] * (mids[None, :] - min_mid) ** 2
                        * in_bottom, axis=1)
    sat_top = np.sum(pdf[None, :] * (mids[None, :] - max_mid) ** 2 * in_top,
                     axis=1)

    d = deltas[:, None]
    o = offsets[:, None]
    quantized = np.round(mids[None, :] / d - o)
    dequantized = d * (quantized + o)
    quant_cost = np.sum(pdf[None, :] * (mids[None, :] - dequantized) ** 2
                        * in_mid, axis=1)
    return GAMMA * (sat_bottom + sat_top) + quant_cost


def _sqnr_search(xleft, pdf, bitwidth, symmetric, strict, unsigned):
    """TfEnhanced getComputedEncodings (TfEnhancedEncodingAnalyzer.cpp:
    355-400)."""
    mn, mx = _find_range_of_aggregate_stats(xleft, pdf)
    ns = num_quant_steps(bitwidth, strict_symmetric=symmetric and strict)
    fns = float(ns)

    deltas, offsets = [], []
    if symmetric:
        # _pickTestCandidatesSymmetric (.cpp:217-254)
        if mn == 0.0 and unsigned:
            delta_max = mx / fns
            test_offset = 0.0
        else:
            delta_max = max(abs(mx), abs(mn)) / (fns / 2.0)
            test_offset = float(math.floor(-fns / 2))
        for i in range(1, 102):
            deltas.append(i / 100.0 * delta_max)
            offsets.append(test_offset)
    else:
        # _pickTestCandidatesAsymmetric (.cpp:178-214)
        observed_delta = (mx - mn) / fns
        observed_offset = round(mn / observed_delta)
        obs_min = observed_delta * observed_offset
        obs_max = observed_delta * (observed_offset + fns)
        delta_max = observed_delta
        for fi in range(1, 18):
            f = fi / 16.0
            for i in range(21):
                test_delta = f * delta_max
                test_offset = int(-fns + fns / 20.0 * i)
                # _clampToObservedMinMax (.cpp:150-175)
                tmin = test_delta * test_offset
                tmax = test_delta * (test_offset + fns)
                if tmin < obs_min and tmax > obs_max:
                    continue
                tmin = max(obs_min, tmin)
                tmax = min(obs_max, tmax)
                if tmin == tmax:
                    continue
                test_delta = (tmax - tmin) / fns
                test_offset = round(tmin / test_delta)
                deltas.append(test_delta)
                offsets.append(float(test_offset))
        deltas.append(observed_delta)
        offsets.append(float(observed_offset))

    deltas = np.asarray(deltas, np.float64)
    offsets = np.asarray(offsets, np.float64)
    costs = _quant_and_sat_cost_vec(xleft.astype(np.float64),
                                    pdf.astype(np.float64), bitwidth, deltas,
                                    offsets)
    best = int(np.argmin(costs))
    best_delta, best_offset = float(deltas[best]), float(offsets[best])
    best_min = best_delta * best_offset
    best_max = best_delta * (best_offset + fns)
    return best_min, best_max, best_delta, best_offset


def _encoding_tuple_from_min_max(mn, mx, bitwidth, symmetric, strict,
                                 unsigned):
    enc = compute_encoding_from_min_max(
        np.float32(mn), np.float32(mx), bitwidth, symmetric, strict, unsigned)
    return float(enc.min), float(enc.max), float(enc.delta), float(enc.offset)


# ---------------------------------------------------------------------------
# Analyzer front-end
# ---------------------------------------------------------------------------

class EncodingAnalyzer:
    """Static-config calibration analyzer.

    ``scheme``: ``minmax`` or ``sqnr`` (TF-enhanced); the reference's
    ``percentile``, ``mse`` and ``entropy`` are not ported yet.
    ``channel_axis``: None for per-tensor; an axis index for per-channel.
    """

    def __init__(self, scheme: str = "sqnr",
                 channel_axis: Optional[int] = None):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; expected one of "
                             f"{SCHEMES}")
        if scheme not in PORTED_SCHEMES:
            raise NotImplementedError(
                f"calibration scheme {scheme!r} is not ported to "
                f"aimet_tpu_torch yet (ported: {PORTED_SCHEMES})")
        self.scheme = scheme
        self.channel_axis = channel_axis

    def init_state(self, tensor_shape: Tuple[int, ...] = (), device=None):
        shape = ()
        if self.channel_axis is not None:
            shape = (tensor_shape[self.channel_axis],)
        if self.scheme == "minmax":
            return MinMaxState.init(shape, device)
        return HistogramState.init(shape, device)

    def _per_channel_view(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.movedim(x, self.channel_axis, 0)
        return x.reshape(x.shape[0], -1)

    def update(self, state, x: torch.Tensor):
        fn = update_min_max if self.scheme == "minmax" else update_histogram
        if self.channel_axis is None:
            return fn(state, x.reshape(-1))
        return fn(state, self._per_channel_view(x))

    def compute(self, state, bitwidth: int = 8, symmetric: bool = False,
                strict_symmetric: bool = False,
                unsigned_symmetric: bool = False) -> AffineEncoding:
        """The encoding from a state, on the state's device (f32 fields of
        the state's leading shape)."""
        device = state.updated.device
        st = {k: v.detach().cpu().numpy()
              for k, v in dataclasses.asdict(state).items()}
        args = (bitwidth, symmetric, strict_symmetric, unsigned_symmetric)
        if self.channel_axis is None:
            vals = [np.float32(v) for v in self._compute_one(st, *args)]
        else:
            n = st["updated"].shape[0]
            rows = [self._compute_one({k: v[i] for k, v in st.items()}, *args)
                    for i in range(n)]
            vals = [np.asarray(col, np.float32) for col in zip(*rows)]
        mins, maxs, deltas, offsets = (
            torch.as_tensor(v, dtype=torch.float32, device=device)
            for v in vals)
        return AffineEncoding(min=mins, max=maxs, delta=deltas,
                              offset=offsets, bitwidth=bitwidth,
                              symmetric=symmetric,
                              strict_symmetric=strict_symmetric,
                              unsigned_symmetric=unsigned_symmetric)

    def _compute_one(self, st, bitwidth, symmetric, strict, unsigned):
        if self.scheme == "minmax":
            if not bool(st["updated"]):
                raise RuntimeError(
                    "compute_encodings called before any calibration data")
            mn, mx = gate_min_max(np.float32(st["min"]), np.float32(st["max"]))
            return _encoding_tuple_from_min_max(float(mn), float(mx),
                                                bitwidth, symmetric, strict,
                                                unsigned)
        if not bool(st["initialized"]):
            if not bool(st["updated"]):
                raise RuntimeError(
                    "compute_encodings called before any calibration data")
            # saw data but it was all zeros: [-1, 1] fallback
            return _fallback_encoding(bitwidth, symmetric, strict, unsigned)
        return _sqnr_search(np.asarray(st["xleft"], np.float64),
                            np.asarray(st["pdf"], np.float64), bitwidth,
                            symmetric, strict, unsigned)
