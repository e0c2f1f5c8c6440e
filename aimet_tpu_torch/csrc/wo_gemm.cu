// KW4 / KW8 / KW4G: weight-only GEMM — bf16 or f32 activations x integer
// weights, f32 accumulators, times the per-column scale:
//   out[m,n] = (sum_k x[m,k] * W[k,n]) * sw[n], cast to the out dtype;
// or, grouped, one scale per (K-group, n):
//   out[m,n] = sum_g sw[g,n] * (sum_{k in g} x[m,k] * W[k,n]).
//
// Replaces aimet_tpu/ops/int_matmul.py:matmul_w4 / _w4_kernel (with the
// matmul_w4_decode tile policy), matmul_w8 / _w8_kernel and
// matmul_w4_grouped / _w4g_kernel, _w4g_acc_kernel. One source serves all
// three, templated on the weight format:
//   KW4 (aimet_w4_gemm): W split-half packed INT4, (K/2, N) int8;
//   KW8 (aimet_w8_gemm): W int8 codes, (K, N);
//   KW4G (aimet_w4g_gemm): W split-half packed INT4 with group scales
//   (K/group, N); each group's f32 sum is scaled once, as the TPU's
//   _w4g_acc_kernel does (the weights stay exact in bf16).
// f32 activations (the f32 lm_head of a lowered Llama) are not rounded to
// bf16: the tile splits each value into a bf16 high part and a bf16
// residual and multiplies both against the exact codes (2 MMAs a product;
// the result is within ~2^-16 of the f32 product).
// The INT4 nibbles are unpacked in registers to their signed values
// (lo = (p & 15) - 8, hi = p >> 4), exact in bf16, and the kernel computes
// x_lo . lo + x_hi . hi directly as the oracle matmul_w4_xla does; the
// TPU's AND-only planes, x_hi / 16 prescale and -8 * rowsum correction
// (Mosaic workarounds) are not carried over.
//
// Bound on the H100: at decode M (16..64) the weight bytes (K/2 x N for
// INT4, K x N for int8, at 3.35 TB/s); at prefill M the bf16 tensor-core
// rate (989 TFLOP/s dense).
// Design: the block tile aimet::bf_tile (gemm_tiles.cuh) on
// mma.sync.m16n8k16.bf16 with f32 accumulators, a 64 x 128 output tile a
// block. Where M x N tiles cannot fill 132 SMs (decode) the weight rows
// are split across blocks (the wrapper's decode_splits policy). Float
// partial sums are not order-free, so each split writes its own slice of
// a (splits, M, N) f32 workspace and an epilogue kernel adds the slices
// in split order: repeated calls give the same bits. A TMA + wgmma
// pipeline is later work.
#include <algorithm>

#include "gemm_tiles.cuh"

namespace {

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

// ws == nullptr: writes out = acc * sw (grouped: acc, already scaled);
// else writes the block's partial sums into slice blockIdx.z of ws
// (splits, M, N).
template <bool kW4, bool kF32X, bool kGrouped, typename OutT>
__global__ void __launch_bounds__(kTileThreads)
wo_gemm_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ sw, OutT* __restrict__ out,
               float* __restrict__ ws, int M, int N, int K, int split_rows,
               int group) {
  __shared__ __align__(16) aimet::BfTileX<kF32X> sm;
  const int Kw = kW4 ? K / 2 : K;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int r_begin = blockIdx.z * split_rows;
  const int r_end = min(Kw, r_begin + split_rows);
  float acc[2][4][4] = {};
  aimet::bf_tile<kW4, kF32X, kGrouped>(x, w, M, N, K, m0, n0, r_begin, r_end,
                                        sm, acc, sw, group);
  float* slice = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + aimet::acc_row(mi, c);
        const int n = n0 + aimet::acc_col(ni, c);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (slice != nullptr)
          slice[o] = acc[mi][ni][c];
        else if (kGrouped)
          out[o] = aimet::from_f32<OutT>(acc[mi][ni][c]);
        else
          out[o] = aimet::from_f32<OutT>(acc[mi][ni][c] * sw[n]);
      }
}

// sw == nullptr (grouped): the partial sums are already scaled
template <typename OutT>
__global__ void wo_reduce_kernel(const float* __restrict__ ws,
                                 const float* __restrict__ sw,
                                 OutT* __restrict__ out, int M, int N,
                                 int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * total + i];
    out[i] = aimet::from_f32<OutT>(sw == nullptr ? v : v * sw[i % N]);
  }
}

template <bool kW4, bool kF32X, bool kGrouped, typename OutT>
int run(const void* x, const void* w, const void* sw, void* out, void* ws,
        int M, int N, int K, int group, int splits, cudaStream_t s) {
  constexpr int R = aimet::bf_step_rows<kW4>();
  const int Kw = kW4 ? K / 2 : K;
  const int steps = (Kw + R - 1) / R;
  int per_split = (steps + splits - 1) / splits;
  if (kGrouped) {                       // whole groups a split
    const int unit = group % R == 0 ? group / R : 1;
    per_split = (per_split + unit - 1) / unit * unit;
  }
  const int nsplit = (steps + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  wo_gemm_kernel<kW4, kF32X, kGrouped, OutT><<<grid, kTileThreads, 0, s>>>(
      x, static_cast<const int8_t*>(w), static_cast<const float*>(sw),
      static_cast<OutT*>(out), split ? static_cast<float*>(ws) : nullptr, M,
      N, K, per_split * R, group);
  if (split) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total = (size_t)M * N;
    const int blocks =
        (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
    wo_reduce_kernel<OutT><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws),
        kGrouped ? nullptr : static_cast<const float*>(sw),
        static_cast<OutT*>(out), M, N, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kW4, bool kGrouped>
int dispatch(const void* x, const void* w, const void* sw, void* out,
             void* ws, int M, int N, int K, int group, int splits,
             int x_is_f32, int out_is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits <= 0 || (kW4 && K % 2 != 0) ||
      (kGrouped && (group <= 0 || group % 16 != 0 || (K / 2) % group != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32) {
    if (out_is_bf16)
      return run<kW4, true, kGrouped, __nv_bfloat16>(x, w, sw, out, ws, M, N,
                                                     K, group, splits, s);
    return run<kW4, true, kGrouped, float>(x, w, sw, out, ws, M, N, K, group,
                                           splits, s);
  }
  if (out_is_bf16)
    return run<kW4, false, kGrouped, __nv_bfloat16>(x, w, sw, out, ws, M, N,
                                                    K, group, splits, s);
  return run<kW4, false, kGrouped, float>(x, w, sw, out, ws, M, N, K, group,
                                          splits, s);
}

}  // namespace

// x (M, K) bf16 or f32; w (K/2, N) split-half INT4; sw (N,) f32; out (M, N)
// bf16 or f32; ws: (splits, M, N) f32, read only when splits > 1.
extern "C" int aimet_w4_gemm(const void* x, const void* w, const void* sw,
                             void* out, void* ws, int M, int N, int K,
                             int splits, int x_is_f32, int out_is_bf16,
                             void* stream) {
  return dispatch<true, false>(x, w, sw, out, ws, M, N, K, 0, splits,
                               x_is_f32, out_is_bf16, stream);
}

// As aimet_w4_gemm with w (K, N) int8 codes.
extern "C" int aimet_w8_gemm(const void* x, const void* w, const void* sw,
                             void* out, void* ws, int M, int N, int K,
                             int splits, int x_is_f32, int out_is_bf16,
                             void* stream) {
  return dispatch<false, false>(x, w, sw, out, ws, M, N, K, 0, splits,
                                x_is_f32, out_is_bf16, stream);
}

// As aimet_w4_gemm with group scales gs (K/group, N) f32 in place of sw;
// group a multiple of 16 dividing K/2.
extern "C" int aimet_w4g_gemm(const void* x, const void* w, const void* gs,
                              void* out, void* ws, int M, int N, int K,
                              int group, int splits, int x_is_f32,
                              int out_is_bf16, void* stream) {
  return dispatch<true, true>(x, w, gs, out, ws, M, N, K, group, splits,
                              x_is_f32, out_is_bf16, stream);
}
