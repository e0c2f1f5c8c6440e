// KQ8: the dynamic full-INT8 GEMM.
//
// KQ8 replaces aimet_tpu/ops/int_matmul.py:matmul_q8 (_w8a8_kernel and
// _w8a8_kernel_bias): already-quantized int8 activations x int8 weights,
// int32 sums, then
//   out[m,n] = (f32(acc) * sx[m]) * sw[n]              (no column bias)
//   out[m,n] = fma(f32(acc) * sx[m], sw[n], cb[n])     (with one)
// The second product and the bias add round once, as XLA contracts the TPU
// kernel's body into an FMA on the CPU, where the reference's tests run it
// in interpret mode; without a bias both products round, as there. Its
// int32 entry writes the raw sums: the direct integer conv of
// ops/int_conv.py (XLA's implicit GEMM in the JAX package) runs as a
// zero-point-filled int8 im2col and this entry.
//
// int_matmul.py:matmul_w8a8_fusedq (_w8a8_fusedq_kernel) has no kernel of
// its own here: ops/int_matmul.py runs K1 (act_quant.cu, the same f32 row
// quantizer bit for bit) and then KQ8. The TPU kernel quantized each row
// into VMEM so that the codes never went to HBM; a tile quantizing on its
// way into shared memory would redo each row's division for every
// 128-column block (224 times at N = 28672), while the int8 codes cost one
// extra write and read of M x K bytes. A quantizing prologue in a TMA +
// wgmma tile is later work.
//
// Bound on the H100: at prefill M the int8 tensor-core rate (1,979 TOP/s
// dense); at decode M the int8 weight bytes (K x N at 3.35 TB/s).
// Design: the block tile aimet::s8_tile<false> (gemm_tiles.cuh) on
// mma.sync.m16n8k32.s8 over any K, 128 k values a step, as KSQ
// (w8a8_staticq.cu). Where M x N tiles cannot fill 132 SMs the K range is
// split across blocks and the exact int32 partial sums are combined with
// integer atomics (order-free, so the result stays bit-exact), then an
// epilogue kernel applies the scales.
#include <algorithm>
#include <type_traits>

#include "gemm_tiles.cuh"

namespace {

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

// the f32 epilogue of one sum, in the JAX kernel's order
template <bool kBias>
__device__ __forceinline__ float epilogue(int acc, float sxm, float swn,
                                          float cbn) {
  const float a = __fmul_rn(__int2float_rn(acc), sxm);
  return kBias ? __fmaf_rn(a, swn, cbn) : __fmul_rn(a, swn);
}

template <typename OutT, bool kBias>
__device__ __forceinline__ void store(OutT* out, size_t o, int acc,
                                      const float* sx, const float* sw,
                                      const float* cb, int m, int n) {
  if constexpr (std::is_same<OutT, int>::value)
    out[o] = acc;
  else
    out[o] = aimet::from_f32<OutT>(
        epilogue<kBias>(acc, sx[m], sw[n], kBias ? cb[n] : 0.0f));
}

// ws == nullptr: writes `out`; else atomically adds the block's int32
// partial sums into `ws` (M, N), finished by q8_epilogue_kernel (an int32
// output is its own ws).
template <typename OutT, bool kBias>
__global__ void __launch_bounds__(kTileThreads)
q8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               const float* __restrict__ cb, OutT* __restrict__ out,
               int* __restrict__ ws, int M, int N, int K, int split_rows) {
  __shared__ __align__(16) aimet::S8Tile sm;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int k_begin = blockIdx.z * split_rows;
  const int k_end = min(K, k_begin + split_rows);
  int acc[2][4][4] = {};
  aimet::s8_tile<false>(xq, w, M, N, K, m0, n0, k_begin, k_end, sm, acc);
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
        if (ws != nullptr)
          atomicAdd(ws + o, acc[mi][ni][c]);
        else
          store<OutT, kBias>(out, o, acc[mi][ni][c], sx, sw, cb, m, n);
      }
}

template <typename OutT, bool kBias>
__global__ void q8_epilogue_kernel(const int* __restrict__ ws,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sw,
                                   const float* __restrict__ cb,
                                   OutT* __restrict__ out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    store<OutT, kBias>(out, i, ws[i], sx, sw, cb, (int)(i / N),
                       (int)(i % N));
}

int grid_for(size_t total) {
  return (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
}

template <typename OutT, bool kBias>
int gemm(const int8_t* xq, const int8_t* w, const float* sx, const float* sw,
         const float* cb, OutT* out, int* ws, int M, int N, int K, int splits,
         cudaStream_t s) {
  constexpr bool kInt = std::is_same<OutT, int>::value;
  constexpr int R = aimet::s8_step_rows<false>();
  const int steps = (K + R - 1) / R;
  const int per_split = (steps + splits - 1) / splits;
  const int nsplit = (steps + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  int* acc_ws = split ? (kInt ? reinterpret_cast<int*>(out) : ws) : nullptr;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  q8_gemm_kernel<OutT, kBias><<<grid, kTileThreads, 0, s>>>(
      xq, w, sx, sw, cb, out, acc_ws, M, N, K, per_split * R);
  if constexpr (!kInt) {
    if (split) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      q8_epilogue_kernel<OutT, kBias><<<grid_for((size_t)M * N), 256, 0,
                                        s>>>(ws, sx, sw, cb, out, M, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// KQ8. xq (M, K) int8; sx (M,) f32; w (K, N) int8; sw (N,) f32; cb (N,) f32
// or null; out (M, N) of out_kind (0 f32, 1 bf16, 2 int32: the raw sums,
// sx, sw and cb unused); ws an (M, N) int32 buffer of zeros, read
// only when splits > 1 and the output is not int32 (an int32 output must be
// zeros itself then).
extern "C" int aimet_q8_gemm(const void* xq, const void* sx, const void* w,
                             const void* sw, const void* cb, void* out,
                             void* ws, int M, int N, int K, int splits,
                             int out_kind, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits <= 0 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* cbp = static_cast<const float*>(cb);
  int* wsp = static_cast<int*>(ws);
  if (out_kind == 2)
    return gemm<int, false>(x, wp, sxp, swp, cbp, static_cast<int*>(out),
                            wsp, M, N, K, splits, s);
  if (out_kind == 1) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    return cbp ? gemm<__nv_bfloat16, true>(x, wp, sxp, swp, cbp, o, wsp, M,
                                           N, K, splits, s)
               : gemm<__nv_bfloat16, false>(x, wp, sxp, swp, cbp, o, wsp, M,
                                            N, K, splits, s);
  }
  auto* o = static_cast<float*>(out);
  return cbp ? gemm<float, true>(x, wp, sxp, swp, cbp, o, wsp, M, N, K,
                                 splits, s)
             : gemm<float, false>(x, wp, sxp, swp, cbp, o, wsp, M, N, K,
                                  splits, s);
}
