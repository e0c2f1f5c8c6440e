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
// Routes, picked by the wrapper (ops/int_matmul.py) from the shapes alone:
// - decode M (bf16 x, M <= 64; K, for INT4 K/2, and N multiples of 16):
//   KW8 and KW4 stream their weights through the decode routine
//   (wo_decode_kernel below), KW4G through its own ring
//   (w4g_decode_kernel);
// - KW4, KW8 and KW4G at prefill M (M > 64, operands TMA can map, at
//   least the route's count of output tiles; KW4G a group that is a
//   multiple of 64): the persistent TMA + wgmma tile of wgmma_wo_tile.cuh,
//   the weights unpacked in registers as wgmma's A operand, no split K
//   (KW4G: its own kind, kW4Grouped, 128 x 128 tiles, the group scales
//   folded into the f32 sums a stage at a time);
// - the rest (KW4, KW8 and KW4G with fewer tiles, KW4G's other groups,
//   ragged shapes): the block tile
//   aimet::bf_tile (gemm_tiles.cuh) on mma.sync.m16n8k16.bf16 with f32
//   accumulators, a 64 x 128 output tile a block. Where M x N tiles cannot
//   fill 132 SMs the weight rows are split across blocks (the wrapper's
//   decode_splits policy). Float partial sums are not order-free, so each
//   split writes its own slice of a (splits, M, N) f32 workspace and an
//   epilogue kernel adds the slices in split order: repeated calls give
//   the same bits.
//
// KW4G takes any group dividing K/2. In the tile, a group of 16 or a
// multiple covers whole 16-wide k slices; a smaller or straddling one
// (8, 24) gets one MMA per group that meets a slice, with the x values of
// the slice's other groups masked to 0 (a separate instantiation, so the
// common groups keep their code). With a bf16 x of at most 64 rows it
// takes a weight-streaming route instead (w4g_decode_kernel): the tile's
// 64-row M block would load and multiply 48 masked rows at M = 16, and its
// one 16-byte weight load a thread a step keeps ~4 KB a block in flight.
// There a block owns 128 columns and a range of packed rows; cp.async
// feeds a 4-stage shared-memory ring of 64 packed rows (8 KB) and of the
// matching x columns of both planes; the M tile is 16, 32 or 64 rows, as
// M needs. Each warp takes 32 columns of one nibble plane. It unpacks 4
// packed bytes of a column quad from two rows in registers straight into
// B fragments (a byte permute, then 0x4300 | nibble - 136 as bf16x2: the
// MMA's column g of n8 block c is tile column 4g + c, so one 32-bit load
// feeds 4 blocks), keeps one running group sum beside its accumulators
// (the planes' groups differ, the warps' planes do not) and folds it with
// the group's scales, read once a group into registers, when the group
// changes. The planes meet through shared memory in a fixed order.
//
// KW8 and KW4 with a bf16 x of at most 64 rows (decode M) take the decode
// weight-streaming route (wo_decode_kernel, decode_gemm.cuh's kW8Bf16 and
// kW4Bf16 kinds): one block an SM, a producer warp keeping copies of 64
// weight rows x 256 columns in flight into a shared-memory ring, the M
// tile 16..64 rows, every block an equal share of the weight bytes. A
// slice that one block holds whole goes straight to out; the pieces of a
// slice split across blocks go to a workspace, and the block that brings
// the last one (an atomic count a slice, put back to 0 by that block) adds
// them in K order and writes out: one launch, the same bits on every run.
#include <algorithm>

#include "decode_gemm.cuh"
#include "wgmma_wo_tile.cuh"

namespace {

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

// ws == nullptr: writes out = acc * sw (grouped: acc, already scaled);
// else writes the block's partial sums into slice blockIdx.z of ws
// (splits, M, N).
template <bool kW4, bool kF32X, bool kGrouped, typename OutT,
          bool kAnyGroup = false>
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
  aimet::bf_tile<kW4, kF32X, kGrouped, kAnyGroup>(
      x, w, M, N, K, m0, n0, r_begin, r_end, sm, acc, sw, group);
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

// ------------------------------------------------------ KW4G at decode M
// The weight-streaming route of KW4G for bf16 x at M <= 64 (see the note
// at the top). A block owns 128 columns and a range of packed rows; 8
// warps: warp w takes the 32 columns cq = w & 3 and the lo (w < 4) or hi
// nibble plane, so each warp keeps one running group sum beside its
// accumulators.
constexpr int kDecN = 128;               // columns a block
constexpr int kDecR = 64;                // packed rows a stage
constexpr int kDecStages = 4;            // cp.async ring
constexpr int kDecThreads = 256;
// shared row strides: 144 bytes of weights (the 4 rows a fragment load
// touches land in distinct banks), 272 bytes of x (the 8 rows likewise)
constexpr int kDecLdw = kDecN + 16;
constexpr int kDecLdx = 2 * kDecR + 8;   // bf16

template <int MT>                        // m16 row blocks: M <= 16 MT
struct DecStage {
  int8_t w[kDecR][kDecLdw];              // packed rows [s0, s0 + R)
  uint16_t x[16 * MT][kDecLdx];          // x[m, s0..] | x[m, K/2 + s0..]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// out = sum_g gs[g, n] * (sum_{k in g} x[m, k] W[k, n]) over packed rows
// [blockIdx.y * split_rows, ...) for columns [blockIdx.x * 128, ...);
// ws == nullptr: written to out, else to slice blockIdx.y of ws.
template <int MT, typename OutT, bool kAnyGroup>
__global__ void __launch_bounds__(kDecThreads, MT <= 2 ? 2 : 1)
w4g_decode_kernel(const uint16_t* __restrict__ x,
                  const int8_t* __restrict__ w, const float* __restrict__ gs,
                  OutT* __restrict__ out, float* __restrict__ ws, int M,
                  int N, int K, int group, int split_rows) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  auto* stages = reinterpret_cast<DecStage<MT>*>(dsmem);
  const int K2 = K / 2;
  const int n0 = blockIdx.x * kDecN;
  const int r_begin = blockIdx.y * split_rows;
  const int r_end = min(K2, r_begin + split_rows);
  const int nst = (r_end - r_begin + kDecR - 1) / kDecR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cq = warp & 3, half = warp >> 2;

  auto load_stage = [&](int st) {
    DecStage<MT>& sm = stages[st % kDecStages];
    const int s0 = r_begin + st * kDecR;
    // weights: 64 rows x 8 chunks of 16 bytes; rows past r_end are zeros
#pragma unroll
    for (int i = 0; i < kDecR * 8 / kDecThreads; ++i) {
      const int c = tid + i * kDecThreads, row = c >> 3, col = (c & 7) * 16;
      const int p = s0 + row;
      const bool ok = p < r_end && n0 + col < N;
      cp_async16(&sm.w[row][col],
                 w + (size_t)(ok ? p : r_begin) * N + (ok ? n0 + col : 0),
                 ok ? 16 : 0);
    }
    // x: 16 MT rows x (8 lo + 8 hi chunks of 8 values); values past r_end
    // and rows past M are zeros, so zero-filled weights add nothing
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int c = tid + i * kDecThreads, m = c >> 4, h = (c >> 3) & 1;
      const int e = (c & 7) * 8;
      const int valid = m < M ? max(0, min(8, r_end - (s0 + e))) : 0;
      const size_t off = (size_t)(valid ? m : 0) * K + (size_t)h * K2 +
                         (valid ? s0 + e : 0);
      cp_async16(&sm.x[m][h * kDecR + e], x + off, 2 * valid);
    }
  };

  float acc[MT][4][4], tmp[MT][4][4];
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][c][e] = tmp[mb][c][e] = 0.0f;
  // this thread's 8 columns, n0 + cq * 32 + 8t + [0, 8): accumulator
  // (c, e) holds column 8t + 4 (e & 1) + c (the B fragment's column g of
  // n8 block c is tile column 4g + c, so one 32-bit load feeds 4 blocks)
  const int ncol = n0 + cq * 32 + 8 * t;
  const bool col_ok = ncol < N;
  float4 sc[2];                     // the current group's scales
  int cur = -1;
  const int kbase = half * K2;      // k of packed row 0 in this plane
  auto set_group = [&](int gi) {
    const float* sp = gs + (size_t)gi * N + ncol;
    sc[0] = col_ok ? __ldg(reinterpret_cast<const float4*>(sp))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[1] = col_ok ? __ldg(reinterpret_cast<const float4*>(sp + 4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    cur = gi;
  };
  auto fold = [&]() {
    const float s8[8] = {sc[0].x, sc[0].y, sc[0].z, sc[0].w,
                         sc[1].x, sc[1].y, sc[1].z, sc[1].w};
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mb][c][e] = fmaf(tmp[mb][c][e], s8[4 * (e & 1) + c],
                               acc[mb][c][e]);
          tmp[mb][c][e] = 0.0f;
        }
  };

#pragma unroll
  for (int st = 0; st < kDecStages - 1; ++st) {
    if (st < nst) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();
    if (st + kDecStages - 1 < nst) load_stage(st + kDecStages - 1);
    cp_async_commit();
    const DecStage<MT>& sm = stages[st % kDecStages];
    const int s0 = r_begin + st * kDecR;
    // B of slice j: rows 16j + 2t, +1, +8, +9 at columns cq * 32 + 4g ..
    auto load_w = [&](int j, uint32_t (&wv)[4]) {
      const int8_t* wr = &sm.w[16 * j + 2 * t][cq * 32 + 4 * g];
      wv[0] = aimet::ld_u32(wr);
      wv[1] = aimet::ld_u32(wr + kDecLdw);
      wv[2] = aimet::ld_u32(wr + 8 * kDecLdw);
      wv[3] = aimet::ld_u32(wr + 9 * kDecLdw);
    };
    // the words' nibbles of this plane as the B fragments of 4 n8 blocks
    auto unpack = [&](const uint32_t (&wv)[4], uint32_t (&b)[4][2]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
        const uint32_t p01 = __byte_perm(wv[0], wv[1], sel);
        const uint32_t p23 = __byte_perm(wv[2], wv[3], sel);
        if (half) {
          b[c][0] = aimet::dec::nibbles_bf16x2<true>(p01 >> 4);
          b[c][1] = aimet::dec::nibbles_bf16x2<true>(p23 >> 4);
        } else {
          b[c][0] = aimet::dec::nibbles_bf16x2<false>(p01);
          b[c][1] = aimet::dec::nibbles_bf16x2<false>(p23);
        }
      }
    };
    // A of slice j: x rows 16 mb + g (+8), columns 2t (+8) of this plane
    auto load_x = [&](int j, uint32_t (&a)[MT][4]) {
#pragma unroll
      for (int mb = 0; mb < MT; ++mb) {
        const uint16_t* xr =
            &sm.x[16 * mb + g][half * kDecR + 16 * j + 2 * t];
        a[mb][0] = aimet::ld_u32(xr);
        a[mb][1] = aimet::ld_u32(xr + 8 * kDecLdx);
        a[mb][2] = aimet::ld_u32(xr + 8);
        a[mb][3] = aimet::ld_u32(xr + 8 * kDecLdx + 8);
      }
    };
    const int s_end = min(s0 + kDecR, r_end);
    if (!kAnyGroup && s_end == s0 + kDecR &&
        (kbase + s0) / group == (kbase + s_end - 1) / group) {
      // the whole stage in one group: its loads first, then the MMAs,
      // with no branch between the slices
      const int gi = (kbase + s0) / group;
      if (gi != cur) {
        if (cur >= 0) fold();
        set_group(gi);
      }
      uint32_t wv[kDecR / 16][4];
#pragma unroll
      for (int j = 0; j < kDecR / 16; ++j) load_w(j, wv[j]);
#pragma unroll
      for (int j = 0; j < kDecR / 16; ++j) {
        uint32_t a[MT][4], b[4][2];
        load_x(j, a);
        unpack(wv[j], b);
#pragma unroll
        for (int mb = 0; mb < MT; ++mb)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            aimet::mma_bf16(tmp[mb][c], a[mb], b[c]);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kDecR / 16; ++j) {
      const int p0 = s0 + 16 * j;
      if (p0 >= r_end) break;                       // block-uniform
      uint32_t wv[4], b[4][2], a[MT][4];
      load_w(j, wv);
      unpack(wv, b);
      load_x(j, a);
      const int k_first = kbase + p0;
      if constexpr (!kAnyGroup) {
        // a group of 16 or a multiple covers the whole slice
        const int gi = k_first / group;
        if (gi != cur) {
          if (cur >= 0) fold();
          set_group(gi);
        }
#pragma unroll
        for (int mb = 0; mb < MT; ++mb)
#pragma unroll
          for (int c = 0; c < 4; ++c) aimet::mma_bf16(tmp[mb][c], a[mb], b[c]);
        continue;
      }
      // any group: one MMA per group that meets the slice, the x values of
      // the slice's other groups masked to 0
      const int k_last = kbase + min(p0 + 16, r_end) - 1;
      for (int gi = k_first / group; gi <= k_last / group; ++gi) {
        if (gi != cur) {
          if (cur >= 0) fold();
          set_group(gi);
        }
        const int k0 = max(gi * group - k_first, 0);
        const int k1 = min((gi + 1) * group - k_first, 16);
        uint32_t keep[2] = {0xFFFFFFFFu, 0xFFFFFFFFu};
        if (k0 > 0 || k1 < 16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ka = 2 * t + 8 * h;
            keep[h] = (ka >= k0 && ka < k1 ? 0x0000FFFFu : 0u) |
                      (ka + 1 >= k0 && ka + 1 < k1 ? 0xFFFF0000u : 0u);
          }
        }
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          const uint32_t am[4] = {a[mb][0] & keep[0], a[mb][1] & keep[0],
                                  a[mb][2] & keep[1], a[mb][3] & keep[1]};
#pragma unroll
          for (int c = 0; c < 4; ++c) aimet::mma_bf16(tmp[mb][c], am, b[c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (cur >= 0) fold();
  // the hi plane's warps hand their sums to the lo plane's through shared
  // memory (the ring is free): a fixed order of addition
  __syncthreads();
  float* red = reinterpret_cast<float*>(dsmem);
  constexpr int kVals = MT * 16;
  if (half) {
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((cq * 32 + lane) * kVals) + mb * 16 + c * 4 + e] =
              acc[mb][c][e];
  }
  __syncthreads();
  if (half) return;
  float* slice = ws == nullptr ? nullptr : ws + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * mb + g + (e >= 2 ? 8 : 0);
      const int n = ncol + 4 * (e & 1);
      if (m >= M || !col_ok) continue;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = acc[mb][c][e] +
               red[((cq * 32 + lane) * kVals) + mb * 16 + c * 4 + e];
      const size_t o = (size_t)m * N + n;
      if (slice != nullptr) {
        *reinterpret_cast<float4*>(slice + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[o + c] = aimet::from_f32<OutT>(v[c]);
      }
    }
}

template <int MT>
constexpr size_t smem_of() {
  return kDecStages * sizeof(DecStage<MT>);
}

template <typename OutT>
int run_w4g_decode(const void* x, const void* w, const void* gs, void* out,
                   void* ws, int M, int N, int K, int group, int splits,
                   cudaStream_t s) {
  const int K2 = K / 2;
  const int steps = (K2 + kDecR - 1) / kDecR;
  const int per_split = (steps + splits - 1) / splits;
  const int nsplit = (steps + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  const int mt = M <= 16 ? 1 : M <= 32 ? 2 : 4;
  dim3 grid((N + kDecN - 1) / kDecN, nsplit);
  auto launch = [&](auto kern, size_t smem) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kDecThreads, smem, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(gs), static_cast<OutT*>(out),
        split ? static_cast<float*>(ws) : nullptr, M, N, K, group,
        per_split * kDecR);
    return cudaGetLastError();
  };
  const bool any = group % 16 != 0;
  cudaError_t e;
  if (mt == 1)
    e = any ? launch(w4g_decode_kernel<1, OutT, true>, smem_of<1>())
            : launch(w4g_decode_kernel<1, OutT, false>, smem_of<1>());
  else if (mt == 2)
    e = any ? launch(w4g_decode_kernel<2, OutT, true>, smem_of<2>())
            : launch(w4g_decode_kernel<2, OutT, false>, smem_of<2>());
  else
    e = any ? launch(w4g_decode_kernel<4, OutT, true>, smem_of<4>())
            : launch(w4g_decode_kernel<4, OutT, false>, smem_of<4>());
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  const size_t total = (size_t)M * N;
  const int blocks =
      (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
  wo_reduce_kernel<OutT><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), nullptr, static_cast<OutT*>(out), M, N,
      nsplit);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- KW8 and KW4 at decode M
// out = (x @ W) * sw for bf16 x (M <= 64) and, as kKind says, int8 W
// (K, N) or split-half INT4 W (K/2, N); see the note at the top. cnt: one
// int a slice, 0 on entry and on exit.
template <int kKind, typename OutT>
__global__ void __launch_bounds__(aimet::dec::kThreads, 1)
wo_decode_kernel(const int8_t* __restrict__ w,
                 const __grid_constant__ CUtensorMap map_x,
                 const float* __restrict__ sw, OutT* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ cnt, int M, int N,
                 int K) {
  namespace dec = aimet::dec;
  constexpr int kW = dec::kW;
  constexpr bool kW4 = dec::Fmt<kKind>::kW4;
  extern __shared__ __align__(128) unsigned char dsmem[];
  int* flag = reinterpret_cast<int*>(dsmem + 512);
  const int mt = (M + 15) / 16;
  dec::Ring ring = dec::make_ring<kKind>(dsmem, mt);
  __syncthreads();
  const dec::Geo g(M, kW4 ? K / 2 : K, N, 1, gridDim.x);
  const dec::Operand op{w, nullptr, N, &map_x, kW4 ? K / 2 : 0};
  dec::stream_gemm<kKind>(
      op, g, mt, ring, [&](const dec::Piece& p, const auto& acc) {
        const int n0 = p.j * kW, ncols = min(kW, N - n0);
        const int b0 = g.first_block(p.j), b1 = g.last_block(p.j);
        if (b0 == b1) {                      // the slice whole: to out
          const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
          const int t = lane & 3, gq = lane >> 2;
          constexpr int kMT = sizeof(acc) / sizeof(acc[0]);
#pragma unroll
          for (int mb = 0; mb < kMT; ++mb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int m = 16 * mb + gq + 8 * (e >> 1);
              const int c = warp * 32 + 8 * t + 4 * (e & 1);
              if (m >= M || c >= ncols) continue;
              OutT* o = out + (size_t)m * N + n0 + c;
#pragma unroll
              for (int i = 0; i < 4; ++i)
                o[i] = aimet::from_f32<OutT>(acc[mb][i][e] * sw[n0 + c + i]);
            }
          return;
        }
        dec::store_piece(ws + (size_t)(p.j + blockIdx.x) * M * kW, acc, M,
                         ncols);
        // the consumers' barrier, then one thread's fence, release the
        // piece (as row_done in fused_layer.cu)
        dec::consumer_sync();
        if (threadIdx.x == 0) {
          __threadfence();
          const bool last = atomicAdd(&cnt[p.j], 1) == b1 - b0;
          if (last) {
            cnt[p.j] = 0;                    // ready for the next call
            __threadfence();
          }
          *flag = last;
        }
        dec::consumer_sync();
        if (!*flag) return;
        // 4 columns a thread at a time: ncols is a multiple of 16
        for (int i = 4 * threadIdx.x; i < M * ncols;
             i += 4 * 32 * dec::kConsumerWarps) {
          const int m = i / ncols, c = i % ncols;
          const float4 v = dec::slice_sum4<float>(ws, g, p.j, m, c);
          OutT* o = out + (size_t)m * N + n0 + c;
          const float* s4 = sw + n0 + c;
          o[0] = aimet::from_f32<OutT>(v.x * s4[0]);
          o[1] = aimet::from_f32<OutT>(v.y * s4[1]);
          o[2] = aimet::from_f32<OutT>(v.z * s4[2]);
          o[3] = aimet::from_f32<OutT>(v.w * s4[3]);
        }
      });
}

template <int kKind, typename OutT>
int run_wo_decode(const void* x, const void* w, const void* sw, void* out,
                  void* ws, void* cnt, int M, int N, int K, int blocks,
                  cudaStream_t s) {
  namespace dec = aimet::dec;
  CUtensorMap mx;
  if (!dec::x_map<kKind>(&mx, x, M, K, (M + 15) / 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wo_decode_kernel<kKind, OutT>;
  static bool ready = false;                 // the smem limit, once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dec::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  kern<<<blocks, dec::kThreads, dec::kSmemBytes, s>>>(
      static_cast<const int8_t*>(w), mx, static_cast<const float*>(sw),
      static_cast<OutT*>(out),
      static_cast<float*>(ws), static_cast<int*>(cnt), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The decode routes' shared checks and dispatch: K (INT4: K/2 packed
// rows) and N multiples of 16, workspace and counters no shorter than
// the split needs.
template <int kKind>
int wo_decode(const void* x, const void* w, const void* sw, void* out,
              void* ws, void* cnt, int M, int N, int K, int blocks,
              long long ws_values, int cnt_values, int out_is_bf16,
              void* stream) {
  namespace dec = aimet::dec;
  const int rows = dec::Fmt<kKind>::kW4 ? K / 2 : K;
  if (M <= 0 || M > 16 * dec::kMaxMT || K <= 0 || N <= 0 ||
      (dec::Fmt<kKind>::kW4 && K % 2) || rows % 16 || N % 16 ||
      blocks <= 0 || !aimet::aligned16(x) || !aimet::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const dec::Geo g(M, rows, N, 1, blocks);
  if (ws_values < g.ws_values() || cnt_values < g.nslices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16
             ? run_wo_decode<kKind, __nv_bfloat16>(x, w, sw, out, ws, cnt, M,
                                                   N, K, blocks, s)
             : run_wo_decode<kKind, float>(x, w, sw, out, ws, cnt, M, N, K,
                                           blocks, s);
}

// ------------------------------------- KW4 and KW8 at prefill M: wgmma
// (wgmma_wo_tile.cuh)

// x (M, K) f32 -> xs (2M rows, ld apart) bf16: row 2m the bf16 high part
// of x[m], row 2m + 1 its bf16 residual; k < cut at column k, the rest at
// hi0 + k - cut, the columns between cut and hi0 0 (INT4: cut K/2, hi0
// pair_hi; int8 weights: cut = hi0 = K); K % 4 == 0
__global__ void split_pairs_kernel(const float* __restrict__ x,
                                   uint16_t* __restrict__ xs, int M, int K,
                                   int cut, int hi0, long long ld) {
  const size_t q = (size_t)K / 4, total = (size_t)M * q;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / q;
    const int c = (int)(i % q) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint16_t* row = xs + 2 * m * (size_t)ld;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16 b = __float2bfloat16_rn(f[e]);
      const int col = c + e < cut ? c + e : hi0 + c + e - cut;
      row[col] = __bfloat16_as_ushort(b);
      row[ld + col] = aimet::bf16_bits(__fsub_rn(f[e], __bfloat162float(b)));
    }
    if (c == 0)
      for (int col = cut; col < hi0; ++col) row[col] = row[ld + col] = 0;
  }
}

// Writes the pairs of an f32 x into ws (bytes ws_bytes, at least 2M x ld
// bf16) with split_pairs_kernel and maps them for the tile (cols: the
// map's columns); false if ws is short or unaligned or the map fails.
inline bool pairs_map(CUtensorMap* mx, const float* x, void* ws,
                      long long ws_bytes, int M, int K, int cut, int hi0,
                      long long ld, int cols, cudaStream_t s) {
  if (ws == nullptr || !aimet::aligned16(ws) ||
      ws_bytes < 2LL * M * ld * 2 ||
      !aimet::encode_2d(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ws, 2 * M,
                        cols, ld * 2, aimet::wot::kBM, 128))
    return false;
  const size_t total = (size_t)M * (K / 4);
  const int blocks =
      (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
  split_pairs_kernel<<<blocks, 256, 0, s>>>(
      x, static_cast<uint16_t*>(ws), M, K, cut, hi0, ld);
  return true;
}

// The tile's C entries: x (M, K) bf16 or f32, rows unit-stride; w (K/2, N)
// split-half INT4 (kKind kW4Bf16, kW4Grouped) or (K, N) int8 (kW8Bf16), N
// % 16; x, w and sw 16-byte aligned; a bf16 x's boxes 16-byte aligned
// (INT4: K % 16, its high half; int8: K % 8), an f32 x K % 4. An f32 x is
// first written as bf16 pairs into ws (ws_bytes: at least 2M rows of the
// pair layout). kW4Grouped: sw the group scales (K/group, N), group a
// multiple of 64 (whole stages) dividing K/2.
template <int kKind>
int wo_tile(const void* x, const void* w, const void* sw, void* out,
            void* ws, int M, int N, int K, int group, int x_is_f32,
            int out_is_bf16, long long ws_bytes, void* stream) {
  namespace wot = aimet::wot;
  constexpr bool kGrouped = kKind == aimet::dec::kW4Grouped;
  constexpr bool kW4 = kKind == aimet::dec::kW4Bf16 || kGrouped;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if ((kW4 && K % 2) || N % 16 || K % (x_is_f32 ? 4 : kW4 ? 16 : 8) ||
      (kGrouped && (group <= 0 || group % wot::Stage<kKind>::kRows ||
                    (K / 2) % group)) ||
      !aimet::aligned16(x) || !aimet::aligned16(w) || !aimet::aligned16(sw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = kW4 ? K / 2 : K;
  const float* swp = static_cast<const float*>(sw);
  CUtensorMap mx, mw;
  if (!aimet::encode_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, R, N, N,
                        wot::Stage<kKind>::kRows, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_f32) {
    // INT4: x's high half from pair_hi, the columns between 0; int8: x's
    // columns as they are
    const long long ld = kW4 ? wot::pair_ld(K) : wot::pair_ld_w8(K);
    const int hi0 = kW4 ? (int)wot::pair_hi(K) : K;
    if (!pairs_map(&mx, static_cast<const float*>(x), ws, ws_bytes, M, K,
                   kW4 ? K / 2 : K, hi0, ld, kW4 ? hi0 + K / 2 : K, s))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return out_is_bf16
               ? wot::launch_tile<kKind, __nv_bfloat16, true>(
                     mx, mw, nullptr, swp, nullptr,
                     static_cast<__nv_bfloat16*>(out), M, N, R, hi0, group,
                     2 * M, s)
               : wot::launch_tile<kKind, float, true>(
                     mx, mw, nullptr, swp, nullptr, static_cast<float*>(out),
                     M, N, R, hi0, group, 2 * M, s);
  }
  if (!aimet::encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K,
                        2LL * K, wot::kBM, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return out_is_bf16
             ? wot::launch_tile<kKind, __nv_bfloat16, false>(
                   mx, mw, nullptr, swp, nullptr,
                   static_cast<__nv_bfloat16*>(out), M, N, R, R, group, M, s)
             : wot::launch_tile<kKind, float, false>(
                   mx, mw, nullptr, swp, nullptr, static_cast<float*>(out),
                   M, N, R, R, group, M, s);
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
  auto kern = wo_gemm_kernel<kW4, kF32X, kGrouped, OutT>;
  if constexpr (kGrouped)                // groups not a multiple of 16
    if (group % 16) kern = wo_gemm_kernel<kW4, kF32X, true, OutT, true>;
  kern<<<grid, kTileThreads, 0, s>>>(
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
      (kGrouped && (group <= 0 || (K / 2) % group != 0)))
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

// KW8's decode route: x (M, K) bf16 with 1 <= M <= 64, w (K, N) int8, K
// and N multiples of 16, x and w 16-byte aligned; a grid of `blocks`
// blocks (the SMs) streaming slices of 256 columns. ws holds ws_values
// f32 and cnt cnt_values ints, all 0 (and left 0): refused when short of
// what the split (decode_gemm.cuh, Geo) needs, a slot of M x 256 for each
// (slice, block) meeting and a count a slice.
extern "C" int aimet_w8_decode_gemm(const void* x, const void* w,
                                    const void* sw, void* out, void* ws,
                                    void* cnt, int M, int N, int K,
                                    int blocks, long long ws_values,
                                    int cnt_values, int out_is_bf16,
                                    void* stream) {
  return wo_decode<aimet::dec::kW8Bf16>(x, w, sw, out, ws, cnt, M, N, K,
                                        blocks, ws_values, cnt_values,
                                        out_is_bf16, stream);
}

// KW4's decode route: as aimet_w8_decode_gemm with w (K/2, N) split-half
// INT4, K/2 and N multiples of 16.
extern "C" int aimet_w4_decode_gemm(const void* x, const void* w,
                                    const void* sw, void* out, void* ws,
                                    void* cnt, int M, int N, int K,
                                    int blocks, long long ws_values,
                                    int cnt_values, int out_is_bf16,
                                    void* stream) {
  return wo_decode<aimet::dec::kW4Bf16>(x, w, sw, out, ws, cnt, M, N, K,
                                        blocks, ws_values, cnt_values,
                                        out_is_bf16, stream);
}

// KW4's route at prefill M (wgmma_wo_tile.cuh): x (M, K) bf16 (K % 16:
// x's high half 16-byte aligned) or f32 (K % 4), rows unit-stride; w (K/2,
// N) split-half INT4, N % 16; x, w and sw 16-byte aligned; out (M, N)
// bf16 or f32. An f32 x is first written as bf16 pairs into ws, which must
// hold ws_bytes >= 2 M x pair_ld(K) x 2 (unused for bf16 x).
extern "C" int aimet_w4_tile_gemm(const void* x, const void* w,
                                  const void* sw, void* out, void* ws, int M,
                                  int N, int K, int x_is_f32,
                                  int out_is_bf16, long long ws_bytes,
                                  void* stream) {
  return wo_tile<aimet::dec::kW4Bf16>(x, w, sw, out, ws, M, N, K, 0,
                                      x_is_f32, out_is_bf16, ws_bytes,
                                      stream);
}

// KW8's route at prefill M: as aimet_w4_tile_gemm with w (K, N) int8
// codes; a bf16 x needs K % 8 (16-byte rows), and an f32 x's pairs take
// ws_bytes >= 2 M x pair_ld_w8(K) x 2 (K rounded up to a multiple of 8).
extern "C" int aimet_w8_tile_gemm(const void* x, const void* w,
                                  const void* sw, void* out, void* ws, int M,
                                  int N, int K, int x_is_f32,
                                  int out_is_bf16, long long ws_bytes,
                                  void* stream) {
  return wo_tile<aimet::dec::kW8Bf16>(x, w, sw, out, ws, M, N, K, 0,
                                      x_is_f32, out_is_bf16, ws_bytes,
                                      stream);
}

// As aimet_w4_gemm with group scales gs (K/group, N) f32 in place of sw;
// any group dividing K/2. decode = 1 takes the weight-streaming route:
// bf16 x, M <= 64, K and N multiples of 16, x and w 16-byte aligned; ws
// then (splits, M, N) for splits of 64-row steps of K/2.
extern "C" int aimet_w4g_gemm(const void* x, const void* w, const void* gs,
                              void* out, void* ws, int M, int N, int K,
                              int group, int splits, int x_is_f32,
                              int out_is_bf16, int decode, void* stream) {
  if (!decode)
    return dispatch<true, true>(x, w, gs, out, ws, M, N, K, group, splits,
                                x_is_f32, out_is_bf16, stream);
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (x_is_f32 || M > 64 || K % 16 || N % 16 || splits <= 0 ||
      group <= 0 || (K / 2) % group != 0 || !aimet::aligned16(x) ||
      !aimet::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16)
    return run_w4g_decode<__nv_bfloat16>(x, w, gs, out, ws, M, N, K, group,
                                         splits, s);
  return run_w4g_decode<float>(x, w, gs, out, ws, M, N, K, group, splits, s);
}

// KW4G's route at prefill M (wgmma_wo_tile.cuh, kW4Grouped): as
// aimet_w4_tile_gemm with group scales gs (K/group, N) f32 in place of sw,
// group a multiple of 64 dividing K/2; the f32 pairs' ws as KW4's.
extern "C" int aimet_w4g_tile_gemm(const void* x, const void* w,
                                   const void* gs, void* out, void* ws,
                                   int M, int N, int K, int group,
                                   int x_is_f32, int out_is_bf16,
                                   long long ws_bytes, void* stream) {
  return wo_tile<aimet::dec::kW4Grouped>(x, w, gs, out, ws, M, N, K, group,
                                         x_is_f32, out_is_bf16, ws_bytes,
                                         stream);
}
