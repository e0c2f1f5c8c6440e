// Host-side encoding search library (C++17, standard library only).
//
// The grid searches that run once per quantizer at the end of calibration,
// after the reference's DlQuantization analyzer core
// (TfEnhancedEncodingAnalyzer.cpp, PercentileEncodingAnalyzer.cpp,
// MseEncodingAnalyzer.cpp): the SQNR (TF-enhanced) search, alone and over
// a batch of channels, the percentile range and the MSE candidate search.
// The numpy versions in aimet_tpu_torch/quantization/encoding_analyzer.py
// are their plain versions; this library matches them up to floating-point
// rounding (tests/test_torch_native_search.py) and is what the analyzers
// call.
//
// Exposed via a plain C ABI (ctypes on the Python side, native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kPdfSize = 512;
constexpr double kMinRange = 0.01;
constexpr double kGamma = 3.0;

struct Encoding {
  double min, max, delta, offset;
};

double num_steps(int bw, bool symmetric, bool strict_symmetric) {
  double ns = std::pow(2.0, bw) - 1.0;
  if (symmetric && strict_symmetric) ns -= 1.0;
  return ns;
}

// Mirror of affine.compute_encoding_from_min_max (quantization_utils.cpp
// semantics).
Encoding compute_encoding(double mn, double mx, int bw, bool symmetric,
                          bool strict_symmetric, bool unsigned_symmetric) {
  Encoding e{};
  const double ns = num_steps(bw, symmetric, strict_symmetric);
  if (symmetric && (mn < 0.0 || !unsigned_symmetric)) {
    const double amax = std::max(std::abs(mx), std::abs(mn));
    const double n_pos = std::floor(ns / 2.0);
    e.delta = amax / n_pos;
    e.offset = -std::ceil(ns / 2.0);
    e.min = e.offset * e.delta;
    e.max = e.delta * n_pos;
    return e;
  }
  e.delta = (mx - mn) / ns;
  if (mn < 0.0 && mx > 0.0) {
    double b_zero = std::round(-mn / e.delta);
    b_zero = std::min(ns, std::max(0.0, b_zero));
    e.offset = -b_zero;
    e.min = e.delta * e.offset;
    e.max = mx - mn + e.min;
  } else {
    e.offset = std::round(mn / e.delta);
    e.min = mn;
    e.max = mx;
  }
  return e;
}

void find_range(const double* xleft, const double* pdf, double* mn,
                double* mx) {
  int first = -1, last = -1;
  for (int i = 0; i < kPdfSize; ++i) {
    if (pdf[i] > 0) {
      if (first < 0) first = i;
      last = i;
    }
  }
  if (first < 0) {
    *mn = xleft[0];
    *mx = xleft[kPdfSize - 1];
  } else {
    *mn = xleft[first];
    *mx = xleft[last];
  }
  *mn = std::min(*mn, 0.0);
  *mx = std::max(*mx, 0.0);
  *mx = std::max(*mx, *mn + kMinRange);
}

double quant_sat_cost(const double* xleft, const double* pdf, int bw,
                      double delta, double offset) {
  const double ns = std::pow(2.0, bw) - 1.0;
  const double pdf_start = xleft[0];
  const double pdf_step = xleft[1] - xleft[0];
  const double min_val = delta * offset;
  const double max_val = delta * (offset + ns);
  int min_ind = (int)std::floor((min_val - pdf_start) / pdf_step);
  min_ind = std::min(std::max(0, min_ind), kPdfSize - 1);
  int max_ind = (int)std::floor((max_val - pdf_start) / pdf_step);
  max_ind = std::min(std::max(0, max_ind), kPdfSize - 1);

  const double min_mid = pdf_start + min_ind * pdf_step + pdf_step / 2;
  const double max_mid = pdf_start + max_ind * pdf_step + pdf_step / 2;

  double sat_bottom = 0, sat_top = 0, quant = 0;
  for (int i = 0; i < kPdfSize; ++i) {
    const double mid = pdf_start + i * pdf_step + pdf_step / 2;
    if (i < min_ind) {
      sat_bottom += pdf[i] * (mid - min_mid) * (mid - min_mid);
    } else if (i >= max_ind) {
      sat_top += pdf[i] * (mid - max_mid) * (mid - max_mid);
    } else {
      const double q = std::round(mid / delta - offset);
      const double deq = delta * (q + offset);
      quant += pdf[i] * (mid - deq) * (mid - deq);
    }
  }
  return kGamma * (sat_bottom + sat_top) + quant;
}

}  // namespace

extern "C" {

// SQNR (TF-enhanced) grid search over a 512-bin averaged PDF.
// out4 = {min, max, delta, offset}. Returns 0 on success.
int aimet_sqnr_search(const double* xleft, const double* pdf, int bw,
                      int symmetric, int strict_symmetric,
                      int unsigned_symmetric, double* out4) {
  double mn, mx;
  find_range(xleft, pdf, &mn, &mx);
  const double ns = num_steps(bw, symmetric, strict_symmetric);

  std::vector<std::pair<double, double>> cands;  // (delta, offset)
  if (symmetric) {
    double delta_max, test_offset;
    if (mn == 0.0 && unsigned_symmetric) {
      delta_max = mx / ns;
      test_offset = 0.0;
    } else {
      delta_max = std::max(std::abs(mx), std::abs(mn)) / (ns / 2.0);
      test_offset = std::floor(-ns / 2.0);
    }
    for (int i = 1; i <= 101; ++i)
      cands.emplace_back(i / 100.0 * delta_max, test_offset);
  } else {
    const double observed_delta = (mx - mn) / ns;
    const double observed_offset = std::round(mn / observed_delta);
    const double obs_min = observed_delta * observed_offset;
    const double obs_max = observed_delta * (observed_offset + ns);
    for (int fi = 1; fi <= 17; ++fi) {
      const double f = fi / 16.0;
      for (int i = 0; i <= 20; ++i) {
        double test_delta = f * observed_delta;
        double test_offset = (double)(long long)(-ns + ns / 20.0 * i);
        double tmin = test_delta * test_offset;
        double tmax = test_delta * (test_offset + ns);
        if (tmin < obs_min && tmax > obs_max) continue;
        tmin = std::max(obs_min, tmin);
        tmax = std::min(obs_max, tmax);
        if (tmin == tmax) continue;
        test_delta = (tmax - tmin) / ns;
        test_offset = std::round(tmin / test_delta);
        cands.emplace_back(test_delta, test_offset);
      }
    }
    cands.emplace_back(observed_delta, observed_offset);
  }

  double best_cost = std::numeric_limits<double>::max();
  double best_delta = 0, best_offset = 0;
  for (const auto& c : cands) {
    const double cost = quant_sat_cost(xleft, pdf, bw, c.first, c.second);
    if (cost < best_cost) {
      best_cost = cost;
      best_delta = c.first;
      best_offset = c.second;
    }
  }
  out4[0] = best_delta * best_offset;
  out4[1] = best_delta * (best_offset + ns);
  out4[2] = best_delta;
  out4[3] = best_offset;
  return 0;
}

// Batched per-channel SQNR search: xleft/pdf are (n, 512) row-major;
// out is (n, 4).
int aimet_sqnr_search_batch(const double* xleft, const double* pdf, int n,
                            int bw, int symmetric, int strict_symmetric,
                            int unsigned_symmetric, double* out) {
  for (int i = 0; i < n; ++i) {
    aimet_sqnr_search(xleft + i * kPdfSize, pdf + i * kPdfSize, bw, symmetric,
                      strict_symmetric, unsigned_symmetric, out + i * 4);
  }
  return 0;
}

// Percentile range over the averaged PDF. out2 = {min, max}.
int aimet_percentile_range(const double* xleft, const double* pdf,
                           double percentile, double* out2) {
  int first = -1, last = -1;
  for (int i = 0; i < kPdfSize; ++i) {
    if (pdf[i] > 0) {
      if (first < 0) first = i;
      last = i;
    }
  }
  // findOriginalRange semantics (math_functions.cpp:404-430): zero-
  // included + MIN_RANGE floor (golden-vector checked)
  double mn = (first >= 0) ? xleft[first] : xleft[0];
  double mx = (last >= 0) ? xleft[last] : xleft[kPdfSize - 1];
  mn = std::min(mn, 0.0);
  mx = std::max(std::max(mx, 0.0), mn + kMinRange);
  if (percentile == 100.0) {
    out2[0] = mn;
    out2[1] = mx;
    return 0;
  }
  const double width = xleft[1] - xleft[0];
  double pmin = xleft[0];
  double pmax = xleft[kPdfSize - 1] + width;
  std::vector<double> cdf(kPdfSize);
  double acc = 0;
  for (int i = 0; i < kPdfSize; ++i) {
    acc += pdf[i];
    cdf[i] = acc;
  }
  // thresholds in FLOAT like the reference
  // (PercentileEncodingAnalyzer.cpp:178,190): a float32 threshold admits
  // cdf values sitting exactly on k/N boundaries
  const double left_p = (double)(1.0f - (float)percentile / 100.0f);
  for (int i = 0; i < kPdfSize; ++i) {
    if (cdf[i] >= left_p) {
      pmin = xleft[i];
      break;
    }
  }
  const double right_p = (double)((float)percentile / 100.0f);
  for (int i = kPdfSize - 1; i >= 0; --i) {
    if (cdf[i] < right_p && xleft[i] < mx) {
      pmax = xleft[i] + width;
      break;
    }
  }
  if (pmin == pmax) pmax += width;
  out2[0] = pmin;
  out2[1] = pmax;
  return 0;
}

// MSE candidate search. out2 = {min, max}.
int aimet_mse_search(const double* xleft, const double* pdf, int bw,
                     int symmetric, int strict_symmetric,
                     int unsigned_symmetric, double* out2) {
  const double width = xleft[1] - xleft[0];
  int first = -1, last = -1;
  for (int i = 0; i < kPdfSize; ++i) {
    if (pdf[i] > 0) {
      if (first < 0) first = i;
      last = i;
    }
  }
  // findOriginalRange semantics: zero-included + MIN_RANGE floor, THEN
  // one extra bin on the max side (MseEncodingAnalyzer.cpp:148-150)
  double mn = (first >= 0) ? xleft[first] : xleft[0];
  double mx = (last >= 0) ? xleft[last] : xleft[kPdfSize - 1];
  mn = std::min(mn, 0.0);
  mx = std::max(std::max(mx, 0.0), mn + kMinRange) + width;

  // aligned bin edges inside [mn, mx]
  std::vector<double> edges;
  edges.push_back(mn);
  const double hist_max = xleft[kPdfSize - 1] + width;
  for (double e = xleft[0]; e <= hist_max + 1e-12; e += width) {
    if (e >= mn && e <= mx) edges.push_back(e);
  }

  std::vector<double> neg, pos;
  for (double e : edges) {
    if (e < 0) neg.push_back(e);
    else if (e > 0) pos.push_back(e);
  }
  neg.push_back(0.0);
  pos.push_back(0.0);

  // bin centers + pdf
  const int n_centers = (int)edges.size() - 1;
  std::vector<double> centers(n_centers), cpdf(n_centers);
  for (int i = 0; i < n_centers; ++i) {
    centers[i] = mn + width / 2 + i * width;
    int idx = (int)std::floor((centers[i] - xleft[0]) / width);
    idx = std::min(std::max(0, idx), kPdfSize - 1);
    cpdf[i] = pdf[idx];
  }

  double best = std::numeric_limits<double>::max();
  double bmin = mn, bmax = mx;
  for (size_t a = 0; a < neg.size(); ++a) {
    for (size_t b = 0; b < pos.size(); ++b) {
      if (a == neg.size() - 1 && b == pos.size() - 1) continue;  // {0,0}
      const double cmin = neg[a], cmax = pos[b];
      Encoding e = compute_encoding(cmin, cmax, bw, symmetric,
                                    strict_symmetric, unsigned_symmetric);
      const double d = (e.delta == 0) ? 1e-30 : e.delta;
      double cost = 0;
      for (int i = 0; i < n_centers; ++i) {
        const double clamped = std::max(cmin, std::min(centers[i], cmax));
        const double q = std::round(clamped / d - e.offset);
        const double deq = d * (q + e.offset);
        cost += cpdf[i] * (centers[i] - deq) * (centers[i] - deq);
      }
      if (cost < best) {
        best = cost;
        bmin = cmin;
        bmax = cmax;
      }
    }
  }
  out2[0] = bmin;
  out2[1] = bmax;
  return 0;
}

int aimet_version() { return 1; }

}  // extern "C"
