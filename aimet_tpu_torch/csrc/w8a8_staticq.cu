// KSQ: static-encoding INT8 GEMM — activations quantized with a frozen
// calibration encoding, int8 x int8 weights, int32 sums, then
//   out[m,n] = (float)acc[m,n] * sv[n] + cb[n]
// (sv = Δx · sw, cb the zero-point correction and bias, both per column).
//
// Replaces aimet_tpu/ops/int_matmul.py:matmul_w8a8_staticq /
// _w8a8_staticq_kernel, the w8a8 target of quantsim lowering
// (aimet_tpu/quantsim/lowering.py:_make_static_q8_mm).
//
// The codes follow the TPU kernel's folded signed form, round half to even,
// clip:
//   xq = clip(rint(fma(x, inv_dx, shift)), -128, hi),  shift = -offset - 128,
//                                                      hi = num_steps - 128;
// out = fma(acc, sv, cb). Both multiply-adds are single-rounding FMAs, as
// XLA compiles the TPU kernel's body on the CPU, where the reference's
// tests run it in interpret mode; codes and outputs match the plain
// version (ops/int_matmul.matmul_w8a8_staticq_torch) bit for bit.
//
// Bound on the H100: at prefill M the int8 tensor-core rate (1,979 TOP/s
// dense); at decode M the int8 weight bytes (K x N at 3.35 TB/s).
// Design: the TPU kernel kept a whole K row of codes in VMEM and
// quantized it once per M block; here a first kernel writes the codes
// (M, K) int8 (one read of x, one byte written per element), then one of
// two GEMMs, picked by the wrapper from the shapes
// (ops/int_matmul.py, w8a8_staticq_tile_route):
// - prefill M (M > 64, K and N multiples of 16, at least the route's count
//   of 128 x 256 output tiles): staticq_tile_kernel, the persistent TMA +
//   wgmma tile of wgmma_wo_tile.cuh in its kW8Int8 format: the codes by
//   TMA as wgmma's B operand, the int8 weights by TMA, byte-transposed in
//   registers into wgmma's A operand (m64n128k32.s32.s8.s8), no split K,
//   exact int32 sums, this epilogue's FMA;
// - every other shape: the block tile aimet::s8_tile<false>
//   (gemm_tiles.cuh) on mma.sync.m16n8k32.s8 over any K, 128 k values a
//   step. Where M x N tiles cannot fill 132 SMs the K range is split
//   across blocks and the exact int32 partial sums are combined with
//   integer atomics (order-free, so the result stays bit-exact), then an
//   epilogue kernel applies sv and cb.
#include <algorithm>

#include "gemm_tiles.cuh"
#include "wgmma_wo_tile.cuh"

namespace {

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

template <typename XT>
__global__ void staticq_quant_kernel(const XT* __restrict__ x,
                                     int8_t* __restrict__ xq, size_t total,
                                     float inv_dx, float shift, float hi) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float q = rintf(__fmaf_rn(aimet::to_f32(x[i]), inv_dx, shift));
    q = fminf(fmaxf(q, -128.0f), hi);
    xq[i] = static_cast<int8_t>(q);
  }
}

__device__ __forceinline__ float epilogue(int acc, float svn, float cbn) {
  return __fmaf_rn(__int2float_rn(acc), svn, cbn);
}

// ws == nullptr: writes `out`; else atomically adds the block's int32
// partial sums into `ws` (M, N), finished by staticq_epilogue_kernel.
template <typename OutT>
__global__ void __launch_bounds__(kTileThreads)
staticq_gemm_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ w, const float* __restrict__ sv,
                    const float* __restrict__ cb, OutT* __restrict__ out,
                    int* __restrict__ ws, int M, int N, int K,
                    int split_rows) {
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
          out[o] = aimet::from_f32<OutT>(epilogue(acc[mi][ni][c], sv[n],
                                                  cb[n]));
      }
}

template <typename OutT>
__global__ void staticq_epilogue_kernel(const int* __restrict__ ws,
                                        const float* __restrict__ sv,
                                        const float* __restrict__ cb,
                                        OutT* __restrict__ out, int M,
                                        int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % N);
    out[i] = aimet::from_f32<OutT>(epilogue(ws[i], sv[n], cb[n]));
  }
}

int grid_for(size_t total) {
  return (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
}

template <typename OutT>
int gemm(const int8_t* xq, const int8_t* w, const float* sv, const float* cb,
         OutT* out, int* ws, int M, int N, int K, int splits,
         cudaStream_t s) {
  constexpr int R = aimet::s8_step_rows<false>();
  const int steps = (K + R - 1) / R;
  const int per_split = (steps + splits - 1) / splits;
  const int nsplit = (steps + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  staticq_gemm_kernel<OutT><<<grid, kTileThreads, 0, s>>>(
      xq, w, sv, cb, out, split ? ws : nullptr, M, N, K, per_split * R);
  if (split) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    staticq_epilogue_kernel<OutT><<<grid_for((size_t)M * N), 256, 0, s>>>(
        ws, sv, cb, out, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16 or f32 -> xq (M, K) int8 codes of the frozen encoding.
extern "C" int aimet_staticq_quant(const void* x, void* xq, int M, int K,
                                   float inv_dx, float shift, float hi,
                                   int x_is_bf16, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)M * K;
  if (x_is_bf16)
    staticq_quant_kernel<__nv_bfloat16><<<grid_for(total), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), total,
        inv_dx, shift, hi);
  else
    staticq_quant_kernel<float><<<grid_for(total), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), total, inv_dx,
        shift, hi);
  return static_cast<int>(cudaGetLastError());
}

// xq (M, K) int8; w (K, N) int8; sv, cb (N,) f32; out (M, N) bf16 or f32;
// ws an (M, N) int32 buffer of zeros, read only when splits > 1.
extern "C" int aimet_staticq_gemm(const void* xq, const void* w,
                                  const void* sv, const void* cb, void* out,
                                  void* ws, int M, int N, int K, int splits,
                                  int out_is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* svp = static_cast<const float*>(sv);
  const float* cbp = static_cast<const float*>(cb);
  int* wsp = static_cast<int*>(ws);
  if (out_is_bf16)
    return gemm(x, wp, svp, cbp, static_cast<__nv_bfloat16*>(out), wsp, M, N,
                K, splits, s);
  return gemm(x, wp, svp, cbp, static_cast<float*>(out), wsp, M, N, K, splits,
              s);
}

// KSQ's GEMM at prefill M (wgmma_wo_tile.cuh, kW8Int8): xq (M, K) int8
// codes, rows unit-stride, w (K, N) int8, K and N multiples of 16 (the
// codes' TMA boxes 16-byte aligned); xq, w, sv and cb 16-byte aligned; out
// (M, N) bf16 or f32, fma(f32(sum), sv[n], cb[n]).
extern "C" int aimet_staticq_tile_gemm(const void* xq, const void* w,
                                       const void* sv, const void* cb,
                                       void* out, int M, int N, int K,
                                       int out_is_bf16, void* stream) {
  namespace wot = aimet::wot;
  constexpr int kKind = aimet::dec::kW8Int8;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (K % 16 || N % 16 || !aimet::aligned16(xq) || !aimet::aligned16(w) ||
      !aimet::aligned16(sv) || !aimet::aligned16(cb))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  if (!aimet::encode_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, N,
                        wot::Stage<kKind>::kRows, 128) ||
      !aimet::encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, K,
                        wot::kBM, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* svp = static_cast<const float*>(sv);
  const float* cbp = static_cast<const float*>(cb);
  return out_is_bf16
             ? wot::launch_tile<kKind, __nv_bfloat16, false>(
                   mx, mw, nullptr, svp, cbp,
                   static_cast<__nv_bfloat16*>(out), M, N, K, K, 0, M, s)
             : wot::launch_tile<kKind, float, false>(
                   mx, mw, nullptr, svp, cbp, static_cast<float*>(out), M, N,
                   K, K, 0, M, s);
}
