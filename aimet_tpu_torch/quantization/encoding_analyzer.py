"""Calibration observers and encoding analyzers — counterpart of
``aimet_tpu/quantization/encoding_analyzer.py``.

Design split, as in the JAX package:
  - ``update(state, x)`` runs on the device once per calibration batch: a
    running min/max, or the reference's 512-bin running-mean PDF whose
    range the first batch fixes (3x enlarged; out-of-range values are
    dropped). It never waits for the device.
  - ``compute(state, ...)`` runs once at the end of calibration on the
    host: the min-max gating, or a search over the histogram in the C++
    host library (``aimet_tpu_torch.native``, built by g++ at first use;
    a failed build raises): the TF-enhanced SQNR grid search (candidates
    and GAMMA = 3.0 cost of TfEnhancedEncodingAnalyzer.cpp; one batched
    call for all of a per-channel quantizer's channels), the percentile
    clip (PercentileEncodingAnalyzer.cpp) and the MSE candidate search
    (MseEncodingAnalyzer.cpp), as the JAX package calls them.
  - The ``entropy`` scheme observes an auto-rescaling histogram
    (``RescalingHistogramState``, math_functions.cpp:477-560) and runs the
    TensorRT-style sliding-window KL search in numpy
    (EntropyEncodingAnalyzer.cpp:156-400), as the JAX package does.

The numpy searches here (``_sqnr_search``, ``_percentile_range``,
``_mse_search``) are the C++ searches' plain versions: the tests hold the
library to them.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops._common import div_ieee
from .affine import (AffineEncoding, compute_encoding_from_min_max,
                     gate_min_max, num_quant_steps)

PDF_SIZE = 512
MIN_RANGE = 0.01
GAMMA = 3.0  # saturation-cost weight (TfEnhancedEncodingAnalyzer.h:102)

SCHEMES = ("minmax", "sqnr", "percentile", "mse", "entropy")


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


@dataclasses.dataclass
class RescalingHistogramState:
    """Auto-rescaling histogram (reference ``TensorProfilingParams``)."""
    hist: torch.Tensor         # (..., 512) raw counts
    min: torch.Tensor          # (...,)
    max: torch.Tensor          # (...,)
    initialized: torch.Tensor  # (...,) bool
    updated: torch.Tensor      # (...,) bool — any data seen (even all-zero)

    @classmethod
    def init(cls, shape=(), device=None):
        z = dict(device=device)
        return cls(hist=torch.zeros(shape + (PDF_SIZE,), **z),
                   min=torch.zeros(shape, **z), max=torch.zeros(shape, **z),
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


def _per_row(update, state, x):
    """Run a row update on a 0-dim state (``x`` flattened) or on the rows
    of x (C, L) against a (C,) state."""
    if state.updated.dim() == 0:
        cls = type(state)
        one = cls(*(t[None] for t in dataclasses.astuple(state)))
        out = update(one, x.reshape(1, -1))
        return cls(*(t[0] for t in dataclasses.astuple(out)))
    return update(state, x)


def update_histogram(state: HistogramState, x: torch.Tensor) -> HistogramState:
    """UpdatePdf on a 0-dim state (``x`` flattened) or on the rows of x
    (C, L) against a (C,) state."""
    return _per_row(_update_histogram_rows, state, x)


def _rescale_counts(hist, old_min, old_max, new_min, new_max):
    """Proportional-overlap redistribution of each row's counts (C, 512)
    onto a new equal grid (math_functions.cpp:503-560): each source bin's
    mass splits over the destination bins it overlaps, by overlap length.
    Bounds are (C,)."""
    src_w = (old_max - old_min) / PDF_SIZE
    dst_w = (new_max - new_min) / PDF_SIZE
    i = torch.arange(PDF_SIZE, dtype=torch.float32, device=hist.device)
    src_lo = old_min[:, None] + i * src_w[:, None]          # (C, 512)
    src_hi = src_lo + src_w[:, None]
    dst_lo = new_min[:, None] + i * dst_w[:, None]
    dst_hi = dst_lo + dst_w[:, None]
    overlap = torch.clamp(
        torch.minimum(src_hi[:, :, None], dst_hi[:, None, :])
        - torch.maximum(src_lo[:, :, None], dst_lo[:, None, :]), min=0.0) \
        / torch.where(src_w == 0, 1.0, src_w)[:, None, None]
    return torch.bmm(hist[:, None, :], overlap)[:, 0]


def _update_rescaling_rows(state: RescalingHistogramState,
                           x: torch.Tensor) -> RescalingHistogramState:
    x = x.to(torch.float32)
    C = x.shape[0]
    bmin, bmax = x.amin(dim=1), x.amax(dim=1)
    all_zero = (bmin == 0) & (bmax == 0)
    bmax = torch.where(bmin == bmax, bmin + 0.01, bmax)

    cur_min = torch.where(state.initialized, state.min, bmin)
    cur_max = torch.where(state.initialized, state.max, bmax)
    new_min = torch.minimum(cur_min, bmin)
    new_max = torch.maximum(cur_max, bmax)

    needs_rescale = state.initialized & ((bmin < state.min)
                                         | (bmax > state.max))
    rescaled = _rescale_counts(state.hist, cur_min, cur_max, new_min,
                               new_max)
    hist = torch.where(needs_rescale[:, None], rescaled, state.hist)

    width = (new_max - new_min) / PDF_SIZE
    safe_w = torch.where(width == 0, 1.0, width)
    idx = ((x - new_min[:, None]) / safe_w[:, None]).to(torch.int32)
    flat = (idx.clamp(0, PDF_SIZE - 1).to(torch.int64)
            + torch.arange(C, device=x.device)[:, None] * PDF_SIZE)
    counts = torch.zeros(C * PDF_SIZE, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat.reshape(-1), torch.ones_like(flat).reshape(-1))
    hist = hist + counts.reshape(C, PDF_SIZE).to(torch.float32)

    active = state.initialized | ~all_zero
    return RescalingHistogramState(
        hist=torch.where(active[:, None], hist, state.hist),
        min=torch.where(active, new_min, state.min),
        max=torch.where(active, new_max, state.max),
        initialized=active, updated=torch.ones_like(state.updated))


def update_rescaling_histogram(state: RescalingHistogramState,
                               x: torch.Tensor) -> RescalingHistogramState:
    """updateTensorHistogram_cpu (math_functions.cpp:477-560) on a 0-dim
    state (``x`` flattened) or on the rows of x (C, L) against a (C,)
    state; on the device, without a host sync."""
    return _per_row(_update_rescaling_rows, state, x)


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


def _percentile_range(xleft, pdf, percentile):
    """_computePercentileRange (PercentileEncodingAnalyzer.cpp:133-196):
    the range from findOriginalRange (zero included, MIN_RANGE gated), the
    thresholds in float32 as the C++ has them (``float leftPercentile =
    1 - percentile / 100``): a float32 threshold admits cdf values sitting
    exactly on k/N boundaries."""
    mn, mx = _find_range_of_aggregate_stats(xleft, pdf)
    if percentile == 100.0:
        return mn, mx
    width = float(xleft[1] - xleft[0])
    pct_min = float(xleft[0])
    pct_max = float(xleft[-1]) + width
    cdf = np.cumsum(pdf)
    left_p = float(np.float32(1.0) - np.float32(percentile)
                   / np.float32(100.0))
    hit = np.nonzero(cdf >= left_p)[0]
    if hit.size:
        pct_min = float(xleft[hit[0]])
    right_p = float(np.float32(percentile) / np.float32(100.0))
    for i in range(PDF_SIZE - 1, -1, -1):
        if cdf[i] < right_p and xleft[i] < mx:
            pct_max = float(xleft[i]) + width
            break
    if pct_min == pct_max:
        pct_max += width
    return pct_min, pct_max


def _mse_search(xleft, pdf, bitwidth, symmetric, strict, unsigned):
    """_minimizeMSE (MseEncodingAnalyzer.cpp:136-264): every (min, max)
    pair of grid-aligned edges, the pdf-weighted fake-quant MSE of the bin
    centres, the first least."""
    width = float(xleft[1] - xleft[0])
    mn, mx = _find_range_of_aggregate_stats(xleft, pdf)
    mx = mx + width

    edges = [mn]
    e = float(xleft[0])
    hist_max = float(xleft[-1]) + width
    while e <= hist_max + 1e-12:
        if mn <= e <= mx:
            edges.append(e)
        e += width
    edges = np.asarray(edges, np.float64)

    min_cands = np.concatenate([edges[edges < 0], [0.0]])
    max_cands = np.concatenate([edges[edges > 0], [0.0]])
    cand_min, cand_max = np.meshgrid(min_cands, max_cands, indexing="ij")
    cand_min = cand_min.ravel()[:-1]            # drop the trailing {0, 0}
    cand_max = cand_max.ravel()[:-1]

    n_centers = len(edges) - 1
    centers = mn + width / 2 + np.arange(n_centers) * width
    pdf_idx = np.clip(np.floor((centers - xleft[0]) / width).astype(np.int64),
                      0, PDF_SIZE - 1)
    center_pdf = pdf[pdf_idx]

    enc = compute_encoding_from_min_max(
        torch.from_numpy(cand_min.astype(np.float32)),
        torch.from_numpy(cand_max.astype(np.float32)), bitwidth, symmetric,
        strict, unsigned)
    d = enc.delta.numpy().astype(np.float64)[:, None]
    o = enc.offset.numpy().astype(np.float64)[:, None]
    d = np.where(d == 0, 1e-30, d)
    clamped = np.clip(centers[None, :], cand_min[:, None], cand_max[:, None])
    deq = d * (np.round(clamped / d - o) + o)
    costs = np.sum(center_pdf[None, :] * (centers[None, :] - deq) ** 2,
                   axis=1)
    best = int(np.argmin(costs))
    return float(cand_min[best]), float(cand_max[best])


def _condition_histogram(h):
    """_conditionHistogram (EntropyEncodingAnalyzer.cpp:156-198): move a
    little mass onto the empty bins so the KL stays finite."""
    eps_zero = 0.0001
    if h.size == 0:
        return h
    is_zero = h == 0
    num_zeros = int(is_zero.sum())
    if num_zeros == h.size:
        return h
    eps_nonzero = eps_zero * num_zeros / (h.size - num_zeros)
    if eps_nonzero >= 1.0:
        return h
    out = h.copy()
    out[is_zero] += eps_zero
    out[~is_zero] -= eps_nonzero
    return out


def _compute_kl(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = (p > 0) & (q > 0)
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def _rescale_hist_np(src, smin, smax, dmin, dmax):
    """rescaleHistogram (math_functions.cpp:562-640), proportional
    overlap, in float64."""
    if src.size == 0 or (smin == dmin and smax == dmax):
        return src
    n = src.size
    sw = (smax - smin) / n
    dw = (dmax - dmin) / n
    i = np.arange(n)
    slo = smin + i * sw
    shi = slo + sw
    dlo = dmin + i * dw
    dhi = dlo + dw
    overlap = np.maximum(0.0, np.minimum(shi[:, None], dhi[None, :])
                         - np.maximum(slo[:, None], dlo[None, :])) \
        / (sw if sw != 0 else 1.0)
    return src @ overlap


def _merged_window(win_hist, nqb):
    """The window merged into ``nqb`` bins and spread back over its own:
    bin qi covers [ceil(qi * w / nqb), ceil((qi + 1) * w / nqb)), and each
    nonzero source bin takes its bin's sum over its nonzero count. The
    bins come in at most a few lengths; the sums of one length are taken
    row by row of one gathered array, which numpy sums as it sums each
    slice alone, so the result is the loop's to the bit."""
    win = win_hist.size
    edges = np.ceil(np.arange(nqb + 1) * (win / nqb)).astype(np.int64)
    edges[-1] = win
    lengths = np.diff(edges)
    sums = np.zeros(nqb)
    for n in np.unique(lengths):
        rows = np.nonzero(lengths == n)[0]
        sums[rows] = win_hist[edges[rows][:, None] + np.arange(n)].sum(axis=1)
    nonzero = win_hist != 0
    norm = np.add.reduceat(nonzero.astype(np.int64), edges[:-1])
    fill = np.where(norm > 0, sums / np.maximum(norm, 1), 0.0)
    return np.where(nonzero, np.repeat(fill, lengths), 0.0)


def _optimize_kl(hist, hist_min, hist_max, bitwidth, symmetric, strict,
                 unsigned):
    """_optimizeKL (EntropyEncodingAnalyzer.cpp:227-400): slide a window
    over the histogram, merge it to 2^bw - 1 bins, keep the window of least
    KL divergence. The reference fixes 255 bins (its entry point calls it
    at 8 bits only); 2^bw - 1, as in the JAX package, serves every
    bitwidth the histogram resolves."""
    hist = np.asarray(hist, np.float64)
    if symmetric and (hist_min < 0 or not unsigned):
        amax = max(abs(hist_max), abs(hist_min))
        hist = _rescale_hist_np(hist, hist_min, hist_max, -amax, amax)
        hist_min, hist_max = -amax, amax

    num_bins = hist.size
    nqb = (1 << bitwidth) - 1
    if num_bins == 0 or num_bins < nqb:
        if num_bins:
            warnings.warn(
                f"entropy (KL) calibration needs a histogram with at least "
                f"2^bw-1 = {nqb} bins (have {num_bins}); bitwidth="
                f"{bitwidth} falls back to the full observed range",
                stacklevel=3)
        return hist_min, hist_max

    bin_w = (hist_max - hist_min) / num_bins
    best_div = np.inf
    t_min, t_max = hist_min, hist_max
    start, stop = 0, num_bins - 1
    while stop - start + 1 >= nqb:
        win = stop - start + 1
        p = hist[start:stop + 1].copy()
        p[0] += hist[:start + 1].sum() - hist[start]
        p[-1] += hist[stop:].sum() - hist[stop]

        q = _merged_window(hist[start:stop + 1], nqb)
        if p.sum() == 0 or q.sum() == 0:
            break
        div = _compute_kl(_condition_histogram(p), _condition_histogram(q))
        if div < best_div:
            best_div = div
            t_min = hist_min + start * bin_w
            t_max = hist_min + (stop + 1) * bin_w
        if symmetric or strict:
            start += 1
            stop -= 1
        else:
            symm_loss = hist[start] + hist[stop]
            left_loss = hist[start] + hist[start + 1]
            right_loss = hist[stop] + hist[stop - 1]
            if symm_loss <= left_loss and symm_loss <= right_loss:
                start += 1
                stop -= 1
            elif left_loss < right_loss:
                start += 2
            else:
                stop -= 2
    return t_min, t_max


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

    ``scheme``: minmax / sqnr (TF-enhanced) / percentile / mse / entropy —
    the reference's ``QuantizationMode`` (Quantization.hpp:83-108).
    ``channel_axis``: None for per-tensor; an axis index for per-channel.
    ``percentile``: the clip of the ``percentile`` scheme, in [50, 100].
    """

    def __init__(self, scheme: str = "sqnr",
                 channel_axis: Optional[int] = None,
                 percentile: float = 100.0):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; expected one of "
                             f"{SCHEMES}")
        self.scheme = scheme
        self.channel_axis = channel_axis
        self.percentile = percentile

    def init_state(self, tensor_shape: Tuple[int, ...] = (), device=None):
        shape = ()
        if self.channel_axis is not None:
            shape = (tensor_shape[self.channel_axis],)
        if self.scheme == "minmax":
            return MinMaxState.init(shape, device)
        if self.scheme == "entropy":
            return RescalingHistogramState.init(shape, device)
        return HistogramState.init(shape, device)

    def _per_channel_view(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.movedim(x, self.channel_axis, 0)
        return x.reshape(x.shape[0], -1)

    def update(self, state, x: torch.Tensor):
        fn = {"minmax": update_min_max,
              "entropy": update_rescaling_histogram}.get(self.scheme,
                                                         update_histogram)
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
        if self.scheme == "minmax":
            # elementwise, every channel at once
            if not bool(np.all(st["updated"])):
                raise RuntimeError(
                    "compute_encodings called before any calibration data")
            enc = compute_encoding_from_min_max(
                *gate_min_max(torch.from_numpy(np.asarray(st["min"])),
                              torch.from_numpy(np.asarray(st["max"]))),
                *args)
            vals = [enc.min, enc.max, enc.delta, enc.offset]
        elif self.channel_axis is None:
            vals = [np.float32(v) for v in self._compute_one(st, *args)]
        elif self.scheme == "sqnr":
            # one call for every channel; a channel whose data was all
            # zeros takes the [-1, 1] fallback
            if not bool(np.all(st["updated"])):
                raise RuntimeError(
                    "compute_encodings called before any calibration data")
            out = native.sqnr_search_batch(st["xleft"], st["pdf"], *args)
            empty = ~np.asarray(st["initialized"], bool)
            if empty.any():
                out[empty] = _fallback_encoding(*args)
            vals = [out[:, j].astype(np.float32) for j in range(4)]
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
        """One PDF- or histogram-based encoding (a 0-dim state's fields)."""
        args = (bitwidth, symmetric, strict, unsigned)
        if not bool(st["initialized"]):
            if not bool(st["updated"]):
                raise RuntimeError(
                    "compute_encodings called before any calibration data")
            # saw data but it was all zeros: [-1, 1] fallback
            return _fallback_encoding(*args)
        if self.scheme == "entropy":
            mn, mx = _optimize_kl(st["hist"], float(st["min"]),
                                  float(st["max"]), *args)
        else:
            xleft = np.asarray(st["xleft"], np.float64)
            pdf = np.asarray(st["pdf"], np.float64)
            if self.scheme == "sqnr":
                return native.sqnr_search(xleft, pdf, *args)
            if self.scheme == "percentile":
                mn, mx = native.percentile_range(xleft, pdf, self.percentile)
            else:
                mn, mx = native.mse_search(xleft, pdf, *args)
        return _encoding_tuple_from_min_max(min(mn, 0.0), max(mx, 0.0),
                                            *args)
