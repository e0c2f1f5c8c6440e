// KFL / KSOL: the whole-layer decode kernels, one persistent cooperative
// kernel each.
//
// KFL (aimet_fused_layer with attn = 0) replaces
//   aimet_tpu/ops/fused_layer.py:fused_wo_mlp / _fused_kernel and
//   _fused_kernel_qkv (the phase-D variant);
// KSOL (attn = 1) replaces
//   aimet_tpu/ops/decode_layer_sol.py:sol_decode_layer / _sol_kernel,
// and, launched through ops/fused_layer.py:fused_decode_layer (KDL),
//   aimet_tpu/ops/fused_layer.py:fused_decode_layer /
//   _fused_kernel_layer_last and _fused_kernel_layer.
// The two TPU whole-layer kernels differ in how Mosaic moves the weights
// (a pipelined grid against manual DMA); here one persistent kernel with
// grid-wide barriers covers both, so KSOL and KDL run the same code.
//
// For M <= 64 rows (one token per decode slot), all weights split-half
// INT4 with per-column f32 scales and bf16 activations:
//   0 (KSOL)  ao = decode attention of K3 (decode_attention.cuh): rope,
//             INT8-KV quantize and in-place append, GQA over the cache
//   A         y   = bf16(ao @ W_o) + resid
//   B         h   = bf16(silu(g) * u),  g = rmsnorm(y, mlp_gamma) @ W_gate,
//                                       u = rmsnorm(y, mlp_gamma) @ W_up
//   C         out = bf16(h @ W_down) + y
//   D (opt.)  qkv = bf16(rmsnorm(out, attn_gamma) @ W_qkv)   (next layer)
// with rmsnorm(v, gamma) = bf16(bf16(v * rsqrt(mean(v^2) + eps)) * gamma)
// (fused_layer.py:94-96, 136-138); g and u stay f32 until the product.
// With int8_dots (KSOL in w4a8 mode) every GEMM input is first quantized
// per row in f32 (absmax / 127, as K1 does) and the GEMM runs on int8
// tensor cores with an exact int32 sum and a (acc * sx) * sw epilogue, as
// decode_layer_sol.py:_w4_block_i8 and K2.
//
// Bound on the H100: bytes. At M = 16 a Llama-3-8B layer streams 109 MB of
// packed weights (W_o, W_gate|up, W_down, next W_qkv) plus, for KSOL, the
// live K/V rows; its GEMMs do 64 operations per weight byte, below the
// ~295 a byte at which the bf16 tensor cores would bound it.
// Design: one launch per layer with cudaLaunchCooperativeKernel, no more
// blocks than can be co-resident (the occupancy API's blocks per SM x
// SMs), phases separated by cooperative_groups' grid-wide barrier
// (grid.sync(), no relocatable device code needed). Each GEMM phase deals
// (128-column tile, K split) work items over the blocks; a block runs the
// aimet::bf_tile / s8_tile loop (gemm_tiles.cuh), streaming its activation
// rows from global memory / L2 beside the weight chunks (h at 8B is
// 16 x 14336 bf16 = 458 KB, too large for shared memory), and writes its
// partial sums into its own slice of a workspace. A row phase then gives
// each of the M rows to one block: it adds the split slices in order (the
// result does not depend on the run), applies the epilogue, the residual,
// the next RMSNorm and, with int8_dots, the next per-row quantization.
// The intermediates y, h, out live in workspaces the wrapper allocates.
// Unlike the TPU kernel, no weight chunk is held in a manual DMA slot, so
// the W_o double-buffer race of decode_layer_sol.py:135 has no
// counterpart here.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_attention.cuh"
#include "gemm_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using aimet::kTileN;
constexpr int kThreads = aimet::kTileThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = aimet::kTileM;

// Pointers are device addresses; bf16 unless noted. Mirrored field for
// field by ops/fused_layer.py:_Args.
struct FusedLayerArgs {
  const void* attn_out;    // (M, A) KFL input; unused by KSOL
  const void* resid;       // (M, D)
  const void* mlp_gamma;   // (D,)
  const void* attn_gamma;  // (D,) next layer's attention norm, or null
  void* out;               // (M, D)
  void* qkv_next;          // (M, Nq), or null: no phase D
  const void* wo;          // (A/2, D) split-half INT4
  const void* so;          // (D,) f32
  const void* wg;          // (D/2, F) gate, rows ld_gu bytes apart
  const void* sg;          // (F,) f32
  const void* wu;          // (D/2, F) up, rows ld_gu bytes apart: its own
  const void* su;          // array, or columns F..2F of the gate's
  const void* wd;          // (F/2, D)
  const void* sd;          // (D,) f32
  const void* wq;          // (D/2, Nq), or null
  const void* sq;          // (Nq,) f32, or null
  void* ao;                // (M, A) workspace: attention output (KSOL)
  void* y;                 // (M, D) workspace
  void* xbuf;              // (M, max(D, F)) workspace: phase inputs
  void* xq;                // (M, max(A, D, F)) int8 workspace (int8_dots)
  void* sx;                // (4, M) f32 workspace (int8_dots)
  void* part;              // f32 / int32 partial sums, (split, M, N) a phase
  const void* qkv;         // (M, (H + 2 KH) HD): this layer's QKV (KSOL)
  const void* cosb;        // (M, HD/2) f32
  const void* sinb;        // (M, HD/2) f32
  void* kc;                // (M, S, KH, HD) int8, appended in place
  void* vc;
  const void* ks;          // (M, KH) f32
  const void* vs;
  const void* iks;         // 1 / ks, 1 / vs (f32, IEEE)
  const void* ivs;
  const void* pos;         // (M,) int32
  void* scores;            // (M, KH, H / KH, S) f32 score rows, or null:
                           // in shared memory (aimet_fused_layer_smem)
  int M, A, D, F, Nq;
  int ld_gu;               // row stride of W_gate and W_up (F or 2F)
  int split_a, split_b, split_c, split_d;
  int S, H, KH, HD;
  float eps, sqrt_d;
};

__device__ __forceinline__ float bf(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Block-wide sum or max; every thread gets the result, in a fixed order.
__device__ float block_reduce(float v, bool is_max, float* red) {
  v = is_max ? aimet::warp_max(v) : aimet::warp_sum(v);
  __syncthreads();                       // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Per-row INT8 quantization of the K values at xr (as K1): codes to qr,
// scale to *sx. `amax` is this thread's share of the row's absmax.
__device__ void quantize_row(const bf16* xr, int K, float amax, int8_t* qr,
                             float* sx, float* red) {
  amax = block_reduce(amax, true, red);
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
  if (threadIdx.x == 0) *sx = scale;
  for (int k = threadIdx.x; k < K; k += kThreads)
    qr[k] = aimet::quant_i8(__fdiv_rn(bf(xr, k), scale));
}

// The split sums of output element o of a GEMM phase, times its scales.
template <bool kInt8>
__device__ __forceinline__ float phase_value(const void* part, int splits,
                                             size_t mn, size_t o, float sxm,
                                             float swn) {
  if constexpr (kInt8) {
    const int* p = static_cast<const int*>(part);
    int acc = p[o];
    for (int s = 1; s < splits; ++s) acc += p[s * mn + o];
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), swn);
  } else {
    const float* p = static_cast<const float*>(part);
    float acc = p[o];
    for (int s = 1; s < splits; ++s) acc += p[s * mn + o];
    return __fmul_rn(acc, swn);
  }
}

// This thread's accumulators of the tile at column n0 into slice (M, N),
// whose rows lie ld elements apart.
template <typename Acc>
__device__ __forceinline__ void store_partials(Acc* slice,
                                               const Acc (&acc)[2][4][4],
                                               int M, int N, int ld, int n0) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = aimet::acc_row(mi, c);
        const int n = n0 + aimet::acc_col(ni, c);
        if (m < M && n < N) slice[(size_t)m * ld + n] = acc[mi][ni][c];
      }
}

// (M, K) @ (K/2, N) split-half INT4 -> partial sums (splits, M, N). With
// a second weight w2 (phase B: gate, then up) the phase makes 2N columns,
// w2's at N.. of each partial row; both weights' rows lie ldw bytes apart.
template <bool kInt8>
__device__ void gemm_phase(const bf16* x, const int8_t* xq, const void* w,
                           const void* w2, int ldw, int M, int N, int K,
                           int splits, void* part, unsigned char* smem) {
  constexpr int R = kInt8 ? aimet::kS8Step : aimet::bf_step_rows<true>();
  const int K2 = K / 2;
  const int per = ((K2 + R - 1) / R + splits - 1) / splits * R;
  const int tiles = (N + kTileN - 1) / kTileN;
  const int halves = w2 ? 2 : 1;
  const int NP = halves * N;                 // partial row width
  for (int item = blockIdx.x; item < halves * tiles * splits;
       item += gridDim.x) {
    const int t = item % (halves * tiles), s = item / (halves * tiles);
    const int h = t / tiles, n0 = (t % tiles) * kTileN;
    const int8_t* wp = static_cast<const int8_t*>(h ? w2 : w);
    const int r_begin = s * per, r_end = min(K2, r_begin + per);
    const size_t slice = (size_t)s * M * NP + (size_t)h * N;
    if constexpr (kInt8) {
      int acc[2][4][4] = {};
      aimet::s8_tile(xq, wp, M, N, K2, 0, n0, r_begin, r_end,
                     *reinterpret_cast<aimet::S8Tile*>(smem), acc, ldw);
      store_partials(static_cast<int*>(part) + slice, acc, M, N, NP, n0);
    } else {
      float acc[2][4][4] = {};
      aimet::bf_tile<true>(reinterpret_cast<const uint16_t*>(x), wp, M, N, K,
                           0, n0, r_begin, r_end,
                           *reinterpret_cast<aimet::BfTile*>(smem), acc,
                           nullptr, 0, ldw);
      store_partials(static_cast<float*>(part) + slice, acc, M, N, NP, n0);
    }
  }
}

// Row m of rmsnorm(v, gamma) with v at vr (already written by this block)
// to dst; returns this thread's share of the result's absmax.
__device__ float norm_row(const bf16* vr, float sumsq, const bf16* gamma,
                          int D, float eps, bf16* dst, float* red) {
  sumsq = block_reduce(sumsq, false, red);
  const float r = rsqrtf(sumsq / (float)D + eps);
  float amax = 0.0f;
  for (int n = threadIdx.x; n < D; n += kThreads) {
    const float v = round_bf(round_bf(bf(vr, n) * r) * bf(gamma, n));
    dst[n] = __float2bfloat16_rn(v);
    amax = fmaxf(amax, fabsf(v));
  }
  return amax;
}

template <bool kAttn, bool kInt8>
__global__ void __launch_bounds__(kThreads)
fused_layer_kernel(const FusedLayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int M = a.M, A = a.A, D = a.D, F = a.F, Nq = a.Nq;
  const bf16* resid = static_cast<const bf16*>(a.resid);
  bf16* y = static_cast<bf16*>(a.y);
  bf16* xbuf = static_cast<bf16*>(a.xbuf);
  bf16* out = static_cast<bf16*>(a.out);
  int8_t* xq = static_cast<int8_t*>(a.xq);
  float* sx = static_cast<float*>(a.sx);   // [phase A..D][M]
  const float* so = static_cast<const float*>(a.so);
  const float* sg = static_cast<const float*>(a.sg);
  const float* su = static_cast<const float*>(a.su);
  const float* sd = static_cast<const float*>(a.sd);

  // --- phase 0 (KSOL): attention, one (row, kv head) at a time
  const bf16* x_a = static_cast<const bf16*>(a.attn_out);
  if constexpr (kAttn) {
    bf16* ao = static_cast<bf16*>(a.ao);
    for (int item = blockIdx.x; item < M * a.KH; item += gridDim.x)
      aimet::attention_body<bf16, kThreads>(
          static_cast<const bf16*>(a.qkv), static_cast<const float*>(a.cosb),
          static_cast<const float*>(a.sinb), static_cast<int8_t*>(a.kc),
          static_cast<int8_t*>(a.vc), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const float*>(a.iks),
          static_cast<const float*>(a.ivs), static_cast<const int*>(a.pos),
          ao, item / a.KH, item % a.KH, a.S, a.H, a.KH, a.HD, a.sqrt_d,
          reinterpret_cast<float*>(smem), static_cast<float*>(a.scores));
    grid.sync();
    x_a = ao;
  }
  if constexpr (kInt8) {
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      const bf16* xr = x_a + (size_t)m * A;
      float amax = 0.0f;
      for (int k = threadIdx.x; k < A; k += kThreads)
        amax = fmaxf(amax, fabsf(bf(xr, k)));
      quantize_row(xr, A, amax, xq + (size_t)m * A, sx + m, red);
    }
    grid.sync();
  }

  // --- phase A: y = bf16(ao @ W_o) + resid; then rmsnorm(y) -> xbuf
  gemm_phase<kInt8>(x_a, xq, a.wo, nullptr, D, M, D, A, a.split_a, a.part,
                    smem);
  grid.sync();
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t row = (size_t)m * D;
    const float sxm = kInt8 ? sx[m] : 1.0f;
    float ss = 0.0f;
    for (int n = threadIdx.x; n < D; n += kThreads) {
      const float v = phase_value<kInt8>(a.part, a.split_a, (size_t)M * D,
                                         row + n, sxm, so[n]);
      const float yv = round_bf(round_bf(v) + bf(resid, row + n));
      y[row + n] = __float2bfloat16_rn(yv);
      ss += yv * yv;
    }
    const float amax = norm_row(y + row, ss,
                                static_cast<const bf16*>(a.mlp_gamma), D,
                                a.eps, xbuf + row, red);
    if (kInt8) quantize_row(xbuf + row, D, amax, xq + row, sx + M + m, red);
  }
  grid.sync();

  // --- phase B: h = bf16(silu(g) * u) -> xbuf
  gemm_phase<kInt8>(xbuf, xq, a.wg, a.wu, a.ld_gu, M, F, D, a.split_b,
                    a.part, smem);
  grid.sync();
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t row = (size_t)m * 2 * F;
    const float sxm = kInt8 ? sx[M + m] : 1.0f;
    bf16* hr = xbuf + (size_t)m * F;
    float amax = 0.0f;
    for (int n = threadIdx.x; n < F; n += kThreads) {
      const float g = phase_value<kInt8>(a.part, a.split_b, (size_t)M * 2 * F,
                                         row + n, sxm, sg[n]);
      const float u = phase_value<kInt8>(a.part, a.split_b, (size_t)M * 2 * F,
                                         row + F + n, sxm, su[n]);
      const float sig = 1.0f / (1.0f + expf(-g));
      const float h = round_bf(__fmul_rn(__fmul_rn(g, sig), u));
      hr[n] = __float2bfloat16_rn(h);
      amax = fmaxf(amax, fabsf(h));
    }
    if (kInt8)
      quantize_row(hr, F, amax, xq + (size_t)m * F, sx + 2 * M + m, red);
  }
  grid.sync();

  // --- phase C: out = bf16(h @ W_down) + y; then rmsnorm(out) -> xbuf
  gemm_phase<kInt8>(xbuf, xq, a.wd, nullptr, D, M, D, F, a.split_c, a.part,
                    smem);
  grid.sync();
  const bool has_next = a.qkv_next != nullptr;
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t row = (size_t)m * D;
    const float sxm = kInt8 ? sx[2 * M + m] : 1.0f;
    float ss = 0.0f;
    for (int n = threadIdx.x; n < D; n += kThreads) {
      const float v = phase_value<kInt8>(a.part, a.split_c, (size_t)M * D,
                                         row + n, sxm, sd[n]);
      const float o = round_bf(round_bf(v) + bf(y, row + n));
      out[row + n] = __float2bfloat16_rn(o);
      ss += o * o;
    }
    if (!has_next) continue;
    const float amax = norm_row(out + row, ss,
                                static_cast<const bf16*>(a.attn_gamma), D,
                                a.eps, xbuf + row, red);
    if (kInt8)
      quantize_row(xbuf + row, D, amax, xq + row, sx + 3 * M + m, red);
  }
  if (!has_next) return;                  // the same for every block
  grid.sync();

  // --- phase D: the next layer's qkv = bf16(rmsnorm(out) @ W_qkv)
  gemm_phase<kInt8>(xbuf, xq, a.wq, nullptr, Nq, M, Nq, D, a.split_d,
                    a.part, smem);
  grid.sync();
  const float* sq = static_cast<const float*>(a.sq);
  bf16* qn = static_cast<bf16*>(a.qkv_next);
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t row = (size_t)m * Nq;
    const float sxm = kInt8 ? sx[3 * M + m] : 1.0f;
    for (int n = threadIdx.x; n < Nq; n += kThreads)
      qn[row + n] = __float2bfloat16_rn(phase_value<kInt8>(
          a.part, a.split_d, (size_t)M * Nq, row + n, sxm, sq[n]));
  }
}

using Kernel = void (*)(const FusedLayerArgs);

Kernel pick(int attn, int int8) {
  if (!attn) return &fused_layer_kernel<false, false>;
  if (int8) return &fused_layer_kernel<true, true>;
  return &fused_layer_kernel<true, false>;
}

// Set the kernel's dynamic shared memory limit when above the default.
cudaError_t prepare(Kernel k, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Dynamic shared memory of the kernel, in bytes: the larger of a GEMM
// tile and (KSOL) the attention phase's scratch; at least the row phases'.
// S = 0 when the score rows go to the global workspace `scores`.
extern "C" int aimet_fused_layer_smem(int attn, int int8, int rep, int HD,
                                      int S) {
  size_t b = int8 ? sizeof(aimet::S8Tile) : sizeof(aimet::BfTile);
  if (attn)
    b = std::max(b, sizeof(float) *
                        aimet::attention_smem_floats(rep, HD, S, kWarps));
  return (int)std::max(b, sizeof(float) * kWarps);
}

// The cooperative grid: co-resident blocks of the kernel, at most 4 a SM.
extern "C" int aimet_fused_layer_grid(int attn, int int8, int smem,
                                      void* blocks) {
  Kernel k = pick(attn, int8);
  cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, k, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  *static_cast<int*>(blocks) = std::min(per_sm, 4) * sms;
  return 0;
}

// args: a FusedLayerArgs; grid from aimet_fused_layer_grid with the same
// attn, int8 and smem. Requires 1 <= M <= 64; A, D, F even; ld_gu >= F.
extern "C" int aimet_fused_layer(const void* args, int attn, int int8,
                                 int grid, int smem, void* stream) {
  FusedLayerArgs a = *static_cast<const FusedLayerArgs*>(args);
  if (a.M <= 0 || a.M > kMaxRows || a.A % 2 || a.D % 2 || a.F % 2 ||
      a.ld_gu < a.F || grid <= 0 || (int8 && !attn))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k = pick(attn, int8);
  cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k), dim3(grid),
                                  dim3(kThreads), kargs, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
