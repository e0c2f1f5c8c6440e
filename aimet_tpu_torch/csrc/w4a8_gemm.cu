// K2: W4A8 GEMM — per-row INT8 activations x split-half packed INT4 weights.
//
// Replaces the GEMM of both TPU W4A8 kernels:
//   aimet_tpu/ops/int_matmul.py:matmul_w4a8_fusedq / _w4a8_fusedq_kernel
//   (K unsplit) and matmul_w4a8 / _w4a8_kernel (K split). The TPU needed
//   two variants because a whole K row had to fit in VMEM; here a block
//   loops over K itself, so one kernel takes every K.
//
// Computes out[m,n] = ((float)sum_k xq[m,k] * W[k,n]) * sx[m] * sw[n], cast
// to the out dtype, with the integer sum exact in int32 and the epilogue in
// the reference's order (int_matmul.py:497). W is the split-half biased
// layout (int_matmul.py:85-105): packed byte p of row r holds
// W[r] + 8 in its low nibble and W[r + K/2] (signed) in its high nibble.
// The nibbles are unpacked to signed int8 in registers (lo = (p & 15) - 8,
// hi = p >> 4, arithmetic) on their way into shared memory; Hopper's MMA
// takes no int4.
//
// Bound on the H100: at prefill (M >= a few hundred) the int8 tensor-core
// rate (1,979 TOP/s dense); at decode (M = 16..32) the packed weight bytes
// (K/2 x N at 3.35 TB/s).
// Design: a simple tiled kernel on mma.sync.m16n8k32.s8.s8.s32 (the block
// tile aimet::s8_tile of gemm_tiles.cuh, shared with the whole-layer
// kernel). A block owns a 64 x 128 output tile and walks its K range 64
// packed rows (128 k values) at a time.
// For the decode shapes, where the M x N grid alone cannot fill 132 SMs,
// the K range is split across blocks and the exact int32 partial sums are
// combined with integer atomics (order-independent, so the result stays
// bit-exact), followed by a small epilogue kernel. A TMA + wgmma pipeline
// is later work.
#include <algorithm>

#include "gemm_tiles.cuh"

namespace {

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

template <typename OutT>
__device__ __forceinline__ void store_out(OutT* out, float v) {
  *out = aimet::from_f32<OutT>(v);
}

__device__ __forceinline__ float epilogue(int acc, float sxm, float swn) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), swn);
}

// splits == 1: writes `out`; splits > 1: atomically adds the block's int32
// partial sums into `ws` (M, N), finished by w4a8_epilogue_kernel.
template <typename OutT>
__global__ void __launch_bounds__(kTileThreads)
w4a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ wp, const float* __restrict__ sw,
                 OutT* __restrict__ out, int* __restrict__ ws, int M, int N,
                 int K2, int split_rows) {
  __shared__ __align__(16) aimet::S8Tile sm;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int p_begin = blockIdx.z * split_rows;
  const int p_end = min(K2, p_begin + split_rows);
  int acc[2][4][4] = {};
  aimet::s8_tile(xq, wp, M, N, K2, m0, n0, p_begin, p_end, sm, acc);
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
          store_out(out + o, epilogue(acc[mi][ni][c], sx[m], sw[n]));
      }
}

template <typename OutT>
__global__ void w4a8_epilogue_kernel(const int* __restrict__ ws,
                                     const float* __restrict__ sx,
                                     const float* __restrict__ sw,
                                     OutT* __restrict__ out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / N), n = (int)(i % N);
    store_out(out + i, epilogue(ws[i], sx[m], sw[n]));
  }
}

template <typename OutT>
int run(const int8_t* xq, const float* sx, const int8_t* wp, const float* sw,
        OutT* out, int* ws, int M, int N, int K2, int splits,
        cudaStream_t s) {
  const int ktiles = (K2 + aimet::kS8Step - 1) / aimet::kS8Step;
  const int per_split = (ktiles + splits - 1) / splits;
  const int nsplit = (ktiles + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  w4a8_gemm_kernel<OutT><<<grid, kTileThreads, 0, s>>>(
      xq, sx, wp, sw, out, split ? ws : nullptr, M, N, K2,
      per_split * aimet::kS8Step);
  if (split) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total = (size_t)M * N;
    const int blocks =
        (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
    w4a8_epilogue_kernel<OutT><<<blocks, 256, 0, s>>>(ws, sx, sw, out, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ws` is an (M, N) int32 buffer of zeros, read only when splits > 1.
extern "C" int aimet_w4a8_gemm(const void* xq, const void* sx, const void* wp,
                               const void* sw, void* out, void* ws, int M,
                               int N, int K2, int splits, int out_is_bf16,
                               void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || splits <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* sxp = static_cast<const float*>(sx);
  const int8_t* w = static_cast<const int8_t*>(wp);
  const float* swp = static_cast<const float*>(sw);
  int* wsp = static_cast<int*>(ws);
  if (out_is_bf16)
    return run(x, sxp, w, swp, static_cast<__nv_bfloat16*>(out), wsp, M, N,
               K2, splits, s);
  return run(x, sxp, w, swp, static_cast<float*>(out), wsp, M, N, K2, splits,
             s);
}
