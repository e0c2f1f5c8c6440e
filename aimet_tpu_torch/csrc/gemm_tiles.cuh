// Block-level GEMM tiles shared by the GEMM kernels (w4a8_gemm.cu,
// wo_gemm.cu, w8a8_staticq.cu) and the whole-layer decode kernel
// (fused_layer.cu).
//
// A block of kTileThreads threads owns a kTileM x kTileN output tile and
// walks a range of weight rows, step by step; each thread keeps a 32 x 32
// warp tile of accumulators (8 warps: 2 along M, 4 along N). The next
// step's global loads are issued into registers before the MMAs on the
// current step, so loads overlap math. The weight tile is staged
// k-contiguous ([n][k]) in shared memory, the layout mma.sync's col-major B
// operand reads with one 32-bit load per register.
//
// Two tiles, each templated on the weight format:
//   s8_tile: int8 activations x (split-half INT4 | int8) weights, int32
//            accumulators (mma.sync.m16n8k32.s8), exact. A step is 128 k
//            values: 64 packed INT4 rows (their lo and hi halves) or 128
//            int8 rows.
//   bf_tile: bf16 (or f32) activations x (split-half INT4 | int8) weights,
//            f32 accumulators (mma.sync.m16n8k16.bf16). A step is 64 k
//            values: 32 packed INT4 rows (their lo and hi halves) or 64
//            int8 rows. f32 activations are split into a bf16 high part
//            and a bf16 residual, both multiplied against the exact bf16
//            weight codes (2 MMAs a product, ~2^-16 relative error). With
//            group scales (INT4 only) each K-group's sum is kept apart and
//            added into the accumulators times its (group, n) scale.
// Weight codes are unpacked in registers on their way into shared memory:
// INT4 lo = (p & 15) - 8, hi = p >> 4 (arithmetic), both exact in bf16.
#pragma once
#include "common.cuh"

namespace aimet {

constexpr int kTileM = 64;
constexpr int kTileN = 128;
constexpr int kTileThreads = 256;

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes from src; bytes at index >= n_valid are `fill`.
__device__ __forceinline__ void load16(uint4& r, const int8_t* src,
                                       int n_valid, bool vec_ok, int fill) {
  if (vec_ok && n_valid >= 16) {
    r = *reinterpret_cast<const uint4*>(src);
    return;
  }
  int8_t* b = reinterpret_cast<int8_t*>(&r);
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = e < n_valid ? src[e] : (int8_t)fill;
}

// 16 bf16 values from src; values at index >= n_valid are 0.
__device__ __forceinline__ void load16_bf(uint4 (&r)[2], const uint16_t* src,
                                          int n_valid, bool vec_ok) {
  if (vec_ok && n_valid >= 16) {
    r[0] = *reinterpret_cast<const uint4*>(src);
    r[1] = *reinterpret_cast<const uint4*>(src + 8);
    return;
  }
  uint16_t* b = reinterpret_cast<uint16_t*>(r);
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = e < n_valid ? src[e] : (uint16_t)0;
}

// Output coordinates of accumulator element (mi, ni, c) of this thread.
__device__ __forceinline__ int acc_row(int mi, int c) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  return (warp >> 2) * 32 + mi * 16 + g + (c >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int ni, int c) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  return (warp & 3) * 32 + ni * 8 + t * 2 + (c & 1);
}


// ---------------------------------------------------------------- s8 tile
constexpr int kS8Step = 64;             // packed rows (= 2 x 64 k) a step
constexpr int kS8Lds = kS8Step + 16;    // shared row stride in bytes

// weight rows a step: 64 packed INT4 rows or 128 int8 rows hold 128 k
template <bool kW4>
__host__ __device__ constexpr int s8_step_rows() {
  return kW4 ? kS8Step : 2 * kS8Step;
}

struct S8Tile {
  int8_t a[2][kTileM][kS8Lds];   // [k half][m][k]
  int8_t b[2][kTileN][kS8Lds];   // [k half (INT4: lo/hi plane)][n][k]
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += xq[m0.., k] . W[k, n0..] over weight rows [p_begin, p_end).
// kW4: xq (M, 2 Kw) int8, wp (Kw, N) split-half INT4, packed row p holding
// k = p and k = p + Kw; else xq (M, Kw) int8, wp (Kw, N) int8 codes.
// W's rows lie ldw bytes apart (0: N), so W may be a column range of a
// wider array.
template <bool kW4 = true>
__device__ __forceinline__ void s8_tile(const int8_t* __restrict__ xq,
                                        const int8_t* __restrict__ wp, int M,
                                        int N, int Kw, int m0, int n0,
                                        int p_begin, int p_end, S8Tile& sm,
                                        int (&acc)[2][4][4], int ldw = 0) {
  constexpr int R = s8_step_rows<kW4>();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const size_t K = kW4 ? 2 * (size_t)Kw : (size_t)Kw;
  const int ld = ldw ? ldw : N;
  const bool a_vec = (Kw % 16) == 0;
  const bool b_vec = (ld % 16) == 0 && aligned16(wp);
  // this thread's share of each step: 32 bytes of A; 32 bytes of B a
  // k half (INT4: one packed row feeds both halves)
  const int a_half = tid >> 7;              // k half (0 or 1)
  const int a_row = (tid & 127) >> 1;
  const int a_col = (tid & 1) * 32;
  const int b_prow = tid & 63;              // row within the k half
  const int b_col = (tid >> 6) * 32;        // 4 x 32 columns

  uint4 ar[2], br[kW4 ? 2 : 4];
  auto load_step = [&](int p0) {
    const int gm = m0 + a_row;
    // INT4: halves at x columns p and Kw + p; int8: at p and p + 64
    const int gk = kW4 ? p0 + a_col : p0 + a_half * kS8Step + a_col;
    const int na = gm < M ? max(0, min(32, p_end - gk)) : 0;
    const int8_t* asrc = xq + (size_t)min(gm, M - 1) * K +
                         (kW4 ? (size_t)a_half * Kw : 0) + min(gk, Kw - 1);
    load16(ar[0], asrc, na, a_vec, 0);
    load16(ar[1], asrc + 16, na - 16, a_vec, 0);
    const int gn = n0 + b_col;
#pragma unroll
    for (int h = 0; h < (kW4 ? 1 : 2); ++h) {
      const int gp = p0 + h * kS8Step + b_prow;
      const int nb = gp < p_end ? max(0, min(32, N - gn)) : 0;
      // INT4 0x08 unpacks to lo = 0, hi = 0; int8 0 is 0: masked weights
      // contribute nothing
      const int8_t* bsrc =
          wp + (size_t)min(gp, Kw - 1) * ld + min(gn, N - 1);
      load16(br[2 * h], bsrc, nb, b_vec, kW4 ? 0x08 : 0);
      load16(br[2 * h + 1], bsrc + 16, nb - 16, b_vec, kW4 ? 0x08 : 0);
    }
  };
  auto store_step = [&]() {
    *reinterpret_cast<uint4*>(&sm.a[a_half][a_row][a_col]) = ar[0];
    *reinterpret_cast<uint4*>(&sm.a[a_half][a_row][a_col + 16]) = ar[1];
    const int8_t* b = reinterpret_cast<const int8_t*>(br);
    if constexpr (kW4) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int8_t p = b[e];
        sm.b[0][b_col + e][b_prow] = (int8_t)((p & 0xF) - 8);
        sm.b[1][b_col + e][b_prow] = (int8_t)(p >> 4);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) sm.b[h][b_col + e][b_prow] = b[32 * h + e];
    }
  };

  if (p_begin < p_end) load_step(p_begin);
  for (int p0 = p_begin; p0 < p_end; p0 += R) {
    store_step();
    __syncthreads();
    if (p0 + R < p_end) load_step(p0 + R);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < kS8Step; kk += 32) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          a[mi][0] = ld_u32(&sm.a[h][r][kk + t * 4]);
          a[mi][1] = ld_u32(&sm.a[h][r + 8][kk + t * 4]);
          a[mi][2] = ld_u32(&sm.a[h][r][kk + 16 + t * 4]);
          a[mi][3] = ld_u32(&sm.a[h][r + 8][kk + 16 + t * 4]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn * 32 + ni * 8 + g;
          b[ni][0] = ld_u32(&sm.b[h][n][kk + t * 4]);
          b[ni][1] = ld_u32(&sm.b[h][n][kk + 16 + t * 4]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (m0 + wm * 32 + mi * 16 >= M) continue;   // warp-uniform
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- bf tile
constexpr int kBfStepK = 64;            // k values a step
constexpr int kBfLds = kBfStepK + 8;    // shared row stride in bf16 (144 B)

// kSplitX: f32 activations, staged as a bf16 high part (a[0]) and a bf16
// residual (a[1])
template <bool kSplitX>
struct BfTileX {
  uint16_t a[kSplitX ? 2 : 1][kTileM][kBfLds];   // bf16 bits, [part][m][k]
  uint16_t b[kTileN][kBfLds];                    // bf16 bits, [n][k]
};
using BfTile = BfTileX<false>;

// weight rows a step: 32 packed INT4 rows hold 64 k values
template <bool kW4>
__host__ __device__ constexpr int bf_step_rows() {
  return kW4 ? kBfStepK / 2 : kBfStepK;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 16 f32 values from src; values at index >= n_valid are 0.
__device__ __forceinline__ void load16_f32(uint4 (&r)[4], const float* src,
                                           int n_valid, bool vec_ok) {
  if (vec_ok && n_valid >= 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = reinterpret_cast<const uint4*>(src)[i];
    return;
  }
  float* f = reinterpret_cast<float*>(r);
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = e < n_valid ? src[e] : 0.0f;
}

// acc += x[m0.., k] . W[k, n0..] over weight rows [r_begin, r_end):
// x (M, K) row-major, bf16 (kSplitX false) or f32 (kSplitX true); kW4: w
// (K/2, N) split-half INT4, packed row p holding k = p and k = p + K/2;
// else w (K, N) int8, row r holding k = r.
// kGrouped (kW4 only): gs (K/group, N) f32 holds one scale per (K-group,
// n), the group a multiple of 16 dividing K/2 (kAnyGroup: any group
// dividing K/2); each group's f32 sum is added into acc times its scale
// once the group is done.
// W's rows lie ldw bytes apart (0: N), as in s8_tile.
template <bool kW4, bool kSplitX = false, bool kGrouped = false,
          bool kAnyGroup = false>
__device__ __forceinline__ void bf_tile(const void* __restrict__ xv,
                                        const int8_t* __restrict__ w, int M,
                                        int N, int K, int m0, int n0,
                                        int r_begin, int r_end,
                                        BfTileX<kSplitX>& sm,
                                        float (&acc)[2][4][4],
                                        const float* __restrict__ gs = nullptr,
                                        int group = 0, int ldw = 0) {
  static_assert(kW4 || !kGrouped, "group scales need INT4 weights");
  constexpr int R = bf_step_rows<kW4>();
  constexpr int kParts = kSplitX ? 2 : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int Kw = kW4 ? K / 2 : K;          // weight rows
  const int ld = ldw ? ldw : N;
  const bool a_vec = (Kw % 8) == 0;        // 16-byte aligned x segments
  const bool b_vec = (ld % 16) == 0 && aligned16(w);
  // A: 64 rows x 64 k; a thread loads 16 values of one row. Columns
  // [0, 32) of a W4 step are the lo k half, [32, 64) the hi half.
  const int a_row = tid >> 2, a_q = tid & 3;
  // B (W4): 32 packed rows x 128 columns, 16 bytes a thread;
  // B (W8): 64 rows x 128 columns, 32 bytes a thread.
  const int b_r = kW4 ? (tid & 31) : (tid & 63);
  const int b_col = kW4 ? (tid >> 5) * 16 : (tid >> 6) * 32;

  uint4 ar[kSplitX ? 4 : 2], br[2];
  auto load_step = [&](int r0) {
    const int gm = m0 + a_row;
    int c, lim;                            // x column and its valid limit
    if (kW4) {
      const int p = r0 + (a_q & 1) * 16;   // packed row = lo k index
      c = (a_q >> 1) * Kw + p;
      lim = (a_q >> 1) * Kw + r_end;
    } else {
      c = r0 + a_q * 16;
      lim = r_end;
    }
    const int na = gm < M ? max(0, min(16, lim - c)) : 0;
    const size_t xo = (size_t)min(gm, M - 1) * K + min(c, K - 1);
    if constexpr (kSplitX)
      load16_f32(ar, static_cast<const float*>(xv) + xo, na, a_vec);
    else
      load16_bf(ar, static_cast<const uint16_t*>(xv) + xo, na, a_vec);
    const int gr = r0 + b_r;
    const int gn = n0 + b_col;
    const int nb = gr < r_end ? max(0, min(kW4 ? 16 : 32, N - gn)) : 0;
    const int8_t* bsrc = w + (size_t)min(gr, Kw - 1) * ld + min(gn, N - 1);
    // masked bytes: 0x08 unpacks to INT4 (0, 0); 0 is int8 0
    load16(br[0], bsrc, nb, b_vec, kW4 ? 0x08 : 0);
    if (!kW4) load16(br[1], bsrc + 16, nb - 16, b_vec, 0);
  };
  auto store_step = [&]() {
    if constexpr (kSplitX) {
      const float* f = reinterpret_cast<const float*>(ar);
      uint4 hi[2], lo[2];
      uint16_t* h16 = reinterpret_cast<uint16_t*>(hi);
      uint16_t* l16 = reinterpret_cast<uint16_t*>(lo);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const __nv_bfloat16 h = __float2bfloat16_rn(f[e]);
        h16[e] = __bfloat16_as_ushort(h);
        l16[e] = bf16_bits(__fsub_rn(f[e], __bfloat162float(h)));
      }
      *reinterpret_cast<uint4*>(&sm.a[0][a_row][a_q * 16]) = hi[0];
      *reinterpret_cast<uint4*>(&sm.a[0][a_row][a_q * 16 + 8]) = hi[1];
      *reinterpret_cast<uint4*>(&sm.a[1][a_row][a_q * 16]) = lo[0];
      *reinterpret_cast<uint4*>(&sm.a[1][a_row][a_q * 16 + 8]) = lo[1];
    } else {
      *reinterpret_cast<uint4*>(&sm.a[0][a_row][a_q * 16]) = ar[0];
      *reinterpret_cast<uint4*>(&sm.a[0][a_row][a_q * 16 + 8]) = ar[1];
    }
    const int8_t* b = reinterpret_cast<const int8_t*>(br);
    if (kW4) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int8_t p = b[e];
        sm.b[b_col + e][b_r] = bf16_bits((float)((p & 0xF) - 8));
        sm.b[b_col + e][R + b_r] = bf16_bits((float)(p >> 4));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sm.b[b_col + e][b_r] = bf16_bits((float)b[e]);
    }
  };

  // kGrouped: the running sums of the current group of each k half
  float tlo[2][4][4] = {}, thi[2][4][4] = {};
  int cur_lo = -1, cur_hi = -1;            // current group within the half
  auto fold = [&](float (&tmp)[2][4][4], int grow) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + acc_col(ni, c);
        const float s = n < N ? gs[(size_t)grow * N + n] : 0.0f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][c] += tmp[mi][ni][c] * s;
          acc[mi][ni][c + 2] += tmp[mi][ni][c + 2] * s;
          tmp[mi][ni][c] = 0.0f;
          tmp[mi][ni][c + 2] = 0.0f;
        }
      }
  };

  if (r_begin < r_end) load_step(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += R) {
    store_step();
    __syncthreads();
    if (r0 + R < r_end) load_step(r0 + R);
#pragma unroll
    for (int kk = 0; kk < kBfStepK; kk += 16) {
      uint32_t a[kParts][2][4], b[4][2];
#pragma unroll
      for (int part = 0; part < kParts; ++part)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          a[part][mi][0] = ld_u32(&sm.a[part][r][kk + 2 * t]);
          a[part][mi][1] = ld_u32(&sm.a[part][r + 8][kk + 2 * t]);
          a[part][mi][2] = ld_u32(&sm.a[part][r][kk + 2 * t + 8]);
          a[part][mi][3] = ld_u32(&sm.a[part][r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        b[ni][0] = ld_u32(&sm.b[n][kk + 2 * t]);
        b[ni][1] = ld_u32(&sm.b[n][kk + 2 * t + 8]);
      }
      auto mma_into = [&](float (&d)[2][4][4]) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (m0 + wm * 32 + mi * 16 >= M) continue;   // warp-uniform
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int part = 0; part < kParts; ++part)
              mma_bf16(d[mi][ni], a[part][mi], b[ni]);
        }
      };
      if constexpr (kGrouped && !kAnyGroup) {
        // this 16-wide k slice: packed rows r0 + (kk & 31) .. + 15 of the
        // lo (kk < 32) or hi half; a group never straddles a slice
        const int prow = r0 + (kk & 31);
        if (prow >= r_end) continue;                   // warp-uniform
        const int gi = prow / group;
        if (kk < 32) {
          if (gi != cur_lo) {
            if (cur_lo >= 0) fold(tlo, cur_lo);
            cur_lo = gi;
          }
          mma_into(tlo);
        } else {
          if (gi != cur_hi) {
            if (cur_hi >= 0) fold(thi, Kw / group + cur_hi);
            cur_hi = gi;
          }
          mma_into(thi);
        }
      } else if constexpr (kGrouped) {
        // any group: each group that meets the slice gets one MMA with
        // the x values of the slice's other groups masked to 0 (a group
        // of 8 meets two of a slice, one of 24 straddles slices)
        const int prow = r0 + (kk & 31);
        if (prow >= r_end) continue;                   // warp-uniform
        auto slice_groups = [&](float (&tmp)[2][4][4], int& cur, int gbase) {
          // rows past r_end hold no weights: no group of theirs is met
          const int g_end = (min(prow + 16, r_end) - 1) / group;
          for (int gi = prow / group; gi <= g_end; ++gi) {
            if (gi != cur) {
              if (cur >= 0) fold(tmp, gbase + cur);
              cur = gi;
            }
            const int k0 = max(gi * group - prow, 0);
            const int k1 = min((gi + 1) * group - prow, 16);
            if (k0 == 0 && k1 == 16) {
              mma_into(tmp);
              continue;
            }
            // mask: this thread's A values sit at slice k 2t, 2t+1 (regs
            // 0, 1) and 2t+8, 2t+9 (regs 2, 3)
            uint32_t keep[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ka = 2 * t + 8 * h;
              keep[h] = (ka >= k0 && ka < k1 ? 0x0000FFFFu : 0u) |
                        (ka + 1 >= k0 && ka + 1 < k1 ? 0xFFFF0000u : 0u);
            }
            uint32_t am[kParts][2][4];
#pragma unroll
            for (int part = 0; part < kParts; ++part)
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  am[part][mi][e] = a[part][mi][e] & keep[e >> 1];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (m0 + wm * 32 + mi * 16 >= M) continue;   // warp-uniform
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int part = 0; part < kParts; ++part)
                  mma_bf16(tmp[mi][ni], am[part][mi], b[ni]);
            }
          }
        };
        if (kk < 32)
          slice_groups(tlo, cur_lo, 0);
        else
          slice_groups(thi, cur_hi, Kw / group);
      } else {
        mma_into(acc);
      }
    }
    __syncthreads();
  }
  if constexpr (kGrouped) {
    if (cur_lo >= 0) fold(tlo, cur_lo);
    if (cur_hi >= 0) fold(thi, Kw / group + cur_hi);
  }
}

}  // namespace aimet
