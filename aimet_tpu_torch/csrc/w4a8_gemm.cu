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
// Design: a simple tiled kernel on mma.sync.m16n8k32.s8.s8.s32. A block
// owns a 64 x 128 output tile and walks its K range 64 packed rows (128
// k values) at a time; the next tile's global loads are issued into
// registers before the MMAs on the current tile, so loads overlap math.
// For the decode shapes, where the M x N grid alone cannot fill 132 SMs,
// the K range is split across blocks and the exact int32 partial sums are
// combined with integer atomics (order-independent, so the result stays
// bit-exact), followed by a small epilogue kernel. A TMA + wgmma pipeline
// is later work.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BP = 64;        // packed weight rows per step (= 2 x 64 k)
constexpr int LDS = BP + 16;  // shared row stride in bytes (conflict-free)
constexpr int kThreads = 256; // 8 warps: 2 (M) x 4 (N), 32 x 32 each

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Load 32 bytes from src[0..31]; bytes at index >= n_valid are `fill`.
__device__ __forceinline__ void load32(uint4 (&r)[2], const int8_t* src,
                                       int n_valid, bool vec_ok, int fill) {
  if (vec_ok && n_valid >= 32) {
    r[0] = *reinterpret_cast<const uint4*>(src);
    r[1] = *reinterpret_cast<const uint4*>(src + 16);
    return;
  }
  int8_t* b = reinterpret_cast<int8_t*>(r);
#pragma unroll
  for (int e = 0; e < 32; ++e) b[e] = e < n_valid ? src[e] : (int8_t)fill;
}

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
__global__ void __launch_bounds__(kThreads)
w4a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ wp, const float* __restrict__ sw,
                 OutT* __restrict__ out, int* __restrict__ ws, int M, int N,
                 int K2, int split_rows) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];   // [lo/hi k half][m][k]
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];   // [lo/hi plane][n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int p_begin = blockIdx.z * split_rows;
  const int p_end = min(K2, p_begin + split_rows);
  const size_t K = 2 * (size_t)K2;
  const bool a_vec = (K2 % 16) == 0;
  const bool b_vec = (N % 16) == 0;

  // this thread's share of each tile: 32 bytes of A, 32 bytes of B
  const int a_half = tid >> 7;              // lo (0) or hi (1) k half
  const int a_row = (tid & 127) >> 1;
  const int a_col = (tid & 1) * 32;
  const int b_prow = tid & 63;              // packed row within the tile
  const int b_col = (tid >> 6) * 32;        // 4 x 32 columns

  uint4 ar[2], br[2];
  auto load_tile = [&](int p0) {
    const int gm = m0 + a_row;
    const int gk = p0 + a_col;
    const int na = gm < M ? max(0, min(32, p_end - gk)) : 0;
    load32(ar, xq + (size_t)min(gm, M - 1) * K + (size_t)a_half * K2 +
                   min(gk, K2 - 1), na, a_vec, 0);
    const int gp = p0 + b_prow;
    const int gn = n0 + b_col;
    const int nb = gp < p_end ? max(0, min(32, N - gn)) : 0;
    // 0x08 unpacks to lo = 0, hi = 0: masked weights contribute nothing
    load32(br, wp + (size_t)min(gp, K2 - 1) * N + min(gn, N - 1), nb, b_vec,
           0x08);
  };
  auto store_tile = [&]() {
    *reinterpret_cast<uint4*>(&As[a_half][a_row][a_col]) = ar[0];
    *reinterpret_cast<uint4*>(&As[a_half][a_row][a_col + 16]) = ar[1];
    const int8_t* b = reinterpret_cast<const int8_t*>(br);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int8_t p = b[e];
      Bs[0][b_col + e][b_prow] = (int8_t)((p & 0xF) - 8);
      Bs[1][b_col + e][b_prow] = (int8_t)(p >> 4);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  if (p_begin < p_end) load_tile(p_begin);
  for (int p0 = p_begin; p0 < p_end; p0 += BP) {
    store_tile();
    __syncthreads();
    if (p0 + BP < p_end) load_tile(p0 + BP);   // in flight during the MMAs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < BP; kk += 32) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          a[mi][0] = ld32(&As[h][r][kk + t * 4]);
          a[mi][1] = ld32(&As[h][r + 8][kk + t * 4]);
          a[mi][2] = ld32(&As[h][r][kk + 16 + t * 4]);
          a[mi][3] = ld32(&As[h][r + 8][kk + 16 + t * 4]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn * 32 + ni * 8 + g;
          b[ni][0] = ld32(&Bs[h][n][kk + t * 4]);
          b[ni][1] = ld32(&Bs[h][n][kk + 16 + t * 4]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * 32 + mi * 16 + g + (c >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + ni * 8 + t * 2 + (c & 1);
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
  const int ktiles = (K2 + BP - 1) / BP;
  const int per_split = (ktiles + splits - 1) / splits;
  const int nsplit = (ktiles + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nsplit);
  w4a8_gemm_kernel<OutT><<<grid, kThreads, 0, s>>>(
      xq, sx, wp, sw, out, split ? ws : nullptr, M, N, K2, per_split * BP);
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
