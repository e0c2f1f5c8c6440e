// KW4 / KW8: weight-only GEMM — bf16 activations x integer weights, f32
// accumulators, times the per-column scale:
//   out[m,n] = (sum_k x[m,k] * W[k,n]) * sw[n], cast to the out dtype.
//
// Replaces aimet_tpu/ops/int_matmul.py:matmul_w4 / _w4_kernel (with the
// matmul_w4_decode tile policy) and matmul_w8 / _w8_kernel. One source
// serves both, templated on the weight format:
//   KW4 (aimet_w4_gemm): W split-half packed INT4, (K/2, N) int8;
//   KW8 (aimet_w8_gemm): W int8 codes, (K, N).
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

// ws == nullptr: writes out = acc * sw; else writes the block's partial
// sums into slice blockIdx.z of ws (splits, M, N).
template <bool kW4, typename OutT>
__global__ void __launch_bounds__(kTileThreads)
wo_gemm_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ sw, OutT* __restrict__ out,
               float* __restrict__ ws, int M, int N, int K, int split_rows) {
  __shared__ __align__(16) aimet::BfTile sm;
  const int Kw = kW4 ? K / 2 : K;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int r_begin = blockIdx.z * split_rows;
  const int r_end = min(Kw, r_begin + split_rows);
  float acc[2][4][4] = {};
  aimet::bf_tile<kW4>(x, w, M, N, K, m0, n0, r_begin, r_end, sm, acc);
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
        else
          out[o] = aimet::from_f32<OutT>(acc[mi][ni][c] * sw[n]);
      }
}

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
    out[i] = aimet::from_f32<OutT>(v * sw[i % N]);
  }
}

template <bool kW4, typename OutT>
int run(const void* x, const void* w, const void* sw, void* out, void* ws,
        int M, int N, int K, int splits, cudaStream_t s) {
  constexpr int R = aimet::bf_step_rows<kW4>();
  const int Kw = kW4 ? K / 2 : K;
  const int steps = (Kw + R - 1) / R;
  const int per_split = (steps + splits - 1) / splits;
  const int nsplit = (steps + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  wo_gemm_kernel<kW4, OutT><<<grid, kTileThreads, 0, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<OutT*>(out),
      split ? static_cast<float*>(ws) : nullptr, M, N, K, per_split * R);
  if (split) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total = (size_t)M * N;
    const int blocks =
        (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
    wo_reduce_kernel<OutT><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<const float*>(sw),
        static_cast<OutT*>(out), M, N, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kW4>
int dispatch(const void* x, const void* w, const void* sw, void* out,
             void* ws, int M, int N, int K, int splits, int out_is_bf16,
             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits <= 0 || (kW4 && K % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16)
    return run<kW4, __nv_bfloat16>(x, w, sw, out, ws, M, N, K, splits, s);
  return run<kW4, float>(x, w, sw, out, ws, M, N, K, splits, s);
}

}  // namespace

// x (M, K) bf16; w (K/2, N) split-half INT4; sw (N,) f32; out (M, N) bf16
// or f32; ws: (splits, M, N) f32, read only when splits > 1.
extern "C" int aimet_w4_gemm(const void* x, const void* w, const void* sw,
                             void* out, void* ws, int M, int N, int K,
                             int splits, int out_is_bf16, void* stream) {
  return dispatch<true>(x, w, sw, out, ws, M, N, K, splits, out_is_bf16,
                        stream);
}

// As aimet_w4_gemm with w (K, N) int8 codes.
extern "C" int aimet_w8_gemm(const void* x, const void* w, const void* sw,
                             void* out, void* ws, int M, int N, int K,
                             int splits, int out_is_bf16, void* stream) {
  return dispatch<false>(x, w, sw, out, ws, M, N, K, splits, out_is_bf16,
                         stream);
}
