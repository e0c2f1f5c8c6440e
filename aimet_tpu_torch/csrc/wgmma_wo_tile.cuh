// The weight-only GEMM tile for prefill M on Hopper: KW4's route at M > 64
// (wo_gemm.cu, aimet_w4_tile_gemm), in place of aimet::bf_tile. KW4
// replaces aimet_tpu/ops/int_matmul.py:1023 (matmul_w4).
//
//   out[m, n] = (sum_k x[m, k] W[k, n]) * sw[n]
// for x (M, K) bf16 or f32 and W split-half packed INT4, (K/2, N) int8:
// packed row p holds k = p (low nibble, stored + 8) and k = p + K/2 (high
// nibble, two's complement).
//
// Bound on the H100: the bf16 tensor-core rate (989 TFLOP/s dense); an
// f32 x is two bf16 operands, so twice the operations. The design aims at
// keeping wgmma busy while the INT4 weights, which wgmma cannot take, are
// unpacked beside it:
// - out^T = W^T x^T. The unpacked weights are wgmma's A operand, from
//   registers (wgmma ... .bf16 with A in registers), 64 weight columns an
//   instruction; x, K-major as it lies in memory, is B from shared memory,
//   128 rows of x an instruction (m64n128k16). So the nibbles go from
//   shared memory to registers once and never back.
// - A persistent grid, one block an SM, walks 128 x 256 output tiles
//   (x rows x weight columns): bands of kBand M tiles, M fastest within a
//   band, so the tiles a wave runs together read few x tiles and weight
//   slabs (8 x 1 MB and ~17 x 0.5 MB at K = 4096: L2-resident).
// - A producer warp keeps a 4-stage shared-memory ring fed with TMA loads,
//   a full / empty mbarrier pair a stage. A stage is 64 packed weight rows:
//   two x boxes (128 rows x 64 k, 128-byte swizzle: x[:, p..] and
//   x[:, K/2 + p..], the halves each packed byte meets) and two weight
//   boxes (64 rows x 128 columns, 128-byte swizzle, so the fragment loads
//   meet no bank conflicts), 48 KB. Rows and k past the matrices arrive
//   as zeros. The producer runs on into the next tile while the consumers
//   store, so one tile's epilogue overlaps the next one's loads.
// - Two consumer warpgroups, 128 weight columns each (two m64 slices), 128
//   f32 sums a thread. A 32-bit shared load takes 4 columns of one packed
//   row; the thread's A rows g and g + 8 of both slices are those 4
//   columns (the slices' rows are permuted onto the weight columns, and the
//   epilogue follows the permutation), so 4 loads (rows 2t, 2t + 1, 2t + 8,
//   2t + 9 of 16) feed the A fragments of 16 packed rows for both slices
//   and both nibble planes: a byte permute, then 0x4300 | nibble - 136 as
//   bf16x2 (decode_gemm.cuh's nibbles_bf16x2), exact. A warpgroup unpacks
//   a whole stage (64 registers of A fragments), then issues its 16
//   wgmmas (4 groups of 16 rows x 2 slices x 2 planes) and waits for them
//   before it releases the stage: ptxas serializes wgmmas whose register
//   operands other instructions define while earlier ones are in flight
//   (its C7513 report), so the unpack overlaps the other warpgroup's
//   MMAs, not the warpgroup's own.
// - Packed rows past K/2 in the last stage are set to 0x08 bytes, which
//   unpack to 0 in both planes: the low plane's x box there holds x's high
//   half, not zeros.
// - x's high half must start 16-byte aligned in memory: a TMA box whose
//   first column is not hangs the load (measured: K/2 = 100 bf16 values).
//   So a bf16 x needs K/2 % 8 == 0.
// - f32 x: a prologue pass of the kernel's own writes x as pairs of bf16
//   rows, 2M rows of pair_ld(K): row 2m the bf16 high part of x[m], row
//   2m + 1 its bf16 residual (as bf_tile splits it: within ~2^-16 of the
//   f32 product), x's high half from column pair_hi(K), 16-byte aligned,
//   the columns between the halves 0. The tile then runs unchanged on 64
//   rows of x a tile; columns 2i and 2i + 1 of a thread's sums are one
//   row's two parts, added in the epilogue.
// - No split K: at prefill M the tiles fill the SMs, so each output is one
//   fixed sum and repeated calls give the same bits. The epilogue scales
//   each column once and stores 4 columns (8 or 16 bytes) a row from
//   registers.
// The weight format enters only through the weight boxes and the unpack
// (kKind); INT4 (dec::kW4Bf16) is the one instantiated.
#pragma once
#include "decode_gemm.cuh"
#include "tma_wgmma.cuh"

namespace aimet {
namespace wot {

constexpr int kBM = 128;                  // rows of x (of pairs: 64 rows)
constexpr int kBN = 256;                  // weight columns a tile
constexpr int kP = 64;                    // packed weight rows a stage
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;         // 2 warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kXBox = kBM * 128;          // 128 rows x 64 bf16
constexpr int kWBox = kP * 128;           // 64 packed rows x 128 columns
constexpr int kStageBytes = 2 * kXBox + 2 * kWBox;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment
constexpr int kGroups = kP / 16;          // 16 packed rows a group
constexpr int kBand = 8;                  // M tiles a band of the tile order

// d += A . B for one warpgroup: A 64 x 16 bf16 in registers (a, the
// fragment of mma.m16n8k16's A, warp w holding rows 16 w..), B 128 x 16
// bf16, K-major in shared memory (descriptor db); f32 sums (the scale-d
// predicate is 1: accumulate)
__device__ __forceinline__ void wgmma_bf16_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the tile of index `tile`: bands of kBand M tiles, M fastest in a band
__device__ __forceinline__ void tile_at(int tile, int tiles_m, int tiles_n,
                                        int& mt, int& nt) {
  const int b = tile / (kBand * tiles_n);
  const int rows = min(kBand, tiles_m - b * kBand);
  const int local = tile - b * kBand * tiles_n;
  mt = b * kBand + local % rows;
  nt = local / rows;
}

// out (M, N) = (x @ W) * sw; map_x: x (M rows) or its pairs (kPairX: 2M
// rows), bf16, boxes of 128 rows x 64 values, x's high half from column
// x_hi (16-byte aligned); map_w: the packed weights (K2 rows), boxes of 64
// rows x 128 columns; tiles_m tiles of 128 map rows, tiles_n of 256
// columns
template <int kKind, typename OutT, bool kPairX>
__global__ void __launch_bounds__(kThreads, 1)
w4_tile_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const float* __restrict__ sw, OutT* __restrict__ out, int M,
               int N, int K2, int x_hi, int tiles_m, int tiles_n) {
  static_assert(kKind == dec::kW4Bf16, "the tile unpacks INT4 weights");
  extern __shared__ unsigned char wot_smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wot_smem) + 1023) & ~(uintptr_t)1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ksteps = (K2 + kP - 1) / kP;
  const int tiles = tiles_m * tiles_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {                    // the producer
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mt, nt;
      tile_at(tile, tiles_m, tiles_n, mt, nt);
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = base + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load(st, &map_x, ks * kP, mt * kBM, &full[stage]);
        tma_load(st + kXBox, &map_x, x_hi + ks * kP, mt * kBM,
                 &full[stage]);
        tma_load(st + 2 * kXBox, &map_w, nt * kBN, ks * kP, &full[stage]);
        tma_load(st + 2 * kXBox + kWBox, &map_w, nt * kBN + 128, ks * kP,
                 &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes weight columns 128 wg.. of each tile
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // this thread's 4 columns: byte 4g.. of chunk 2 wl + g / 4 of a row
  const int chunk = 2 * wl + (g >> 2), cbyte = (g & 3) * 4;
  int stage = 0;
  uint32_t phase = 0;
  float acc[2][64];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt;
    tile_at(tile, tiles_m, tiles_n, mt, nt);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[s][i] = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = base + stage * kStageBytes;
      const unsigned char* wb = st + 2 * kXBox + wg * kWBox;
      const int rows = K2 - ks * kP;               // valid packed rows
      // A fragments of the stage: [group][slice][plane][register]; group
      // q is packed rows 16 q.., byte 2s (+1) of a word slice s's row g
      // (g + 8)
      uint32_t a[kGroups][2][2][4];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        // packed rows 16 q + 2t, +1, +8, +9 (128-byte swizzled boxes)
        uint32_t wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * q + 2 * t + (i & 1) + 8 * (i >> 1);
          wv[i] = ld_u32(wb + r * 128 + ((chunk ^ (r & 7)) << 4) + cbyte);
          if (rows < kP && r >= rows) wv[i] = 0x08080808u;
        }
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t c = 2 * s + e;
            const uint32_t sel = c | (c << 4) | ((4 + c) << 8) |
                                 ((4 + c) << 12);
            const uint32_t p01 = __byte_perm(wv[0], wv[1], sel);
            const uint32_t p89 = __byte_perm(wv[2], wv[3], sel);
            a[q][s][0][e] = dec::nibbles_bf16x2<false>(p01);
            a[q][s][0][2 + e] = dec::nibbles_bf16x2<false>(p89);
            a[q][s][1][e] = dec::nibbles_bf16x2<true>(p01 >> 4);
            a[q][s][1][2 + e] = dec::nibbles_bf16x2<true>(p89 >> 4);
          }
      }
      // then the stage's 16 wgmmas (4 groups x 2 planes x 2 slices), and
      // the wait for them: ptxas serializes wgmmas whose register operands
      // other instructions define while earlier wgmmas are in flight, so
      // one warpgroup's unpack overlaps the other's MMAs, not its own
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t db = sw128_desc(st + h * kXBox + 32 * q);
          wgmma_bf16_rs_n128(acc[0], a[q][0][h], db);
          wgmma_bf16_rs_n128(acc[1], a[q][1][h], db);
        }
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // acc[s][4j + 2h + e]: weight column 128 wg + 32 wl + 4g + 2s + h, map
    // row 8j + 2t + e of the tile
    const int n = nt * kBN + wg * 128 + 32 * wl + 4 * g;
    if (n >= N) continue;                          // N % 16: whole quads
    const float4 s4 = *reinterpret_cast<const float4*>(sw + n);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < (kPairX ? 1 : 2); ++e) {
        const int m = kPairX ? mt * (kBM / 2) + 4 * j + t
                             : mt * kBM + 8 * j + 2 * t + e;
        if (m >= M) continue;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + 2 * (c & 1);
          v[c] = kPairX ? acc[c >> 1][i] + acc[c >> 1][i + 1]
                        : acc[c >> 1][i + e];
        }
        v[0] *= s4.x;
        v[1] *= s4.y;
        v[2] *= s4.z;
        v[3] *= s4.w;
        OutT* o = out + (size_t)m * N + n;
        if constexpr (sizeof(OutT) == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&lo);
          u.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(o) = u;
        }
      }
  }
}

// the column of x's high half in the pair rows of an f32 x (16-byte
// aligned), and the bf16 values a pair row holds (16-byte rows)
__host__ __device__ constexpr long long pair_hi(int K) {
  return (K / 2 + 7) / 8 * 8;
}
__host__ __device__ constexpr long long pair_ld(int K) {
  return (pair_hi(K) + K / 2 + 7) / 8 * 8;
}

// x (M, K) f32 -> xs (2M rows, pair_ld(K) apart) bf16: row 2m the bf16
// high part of x[m], row 2m + 1 its bf16 residual; k < K/2 at column k,
// the rest at pair_hi(K) + k - K/2, the columns between 0; K % 4 == 0
__global__ void split_pairs_kernel(const float* __restrict__ x,
                                   uint16_t* __restrict__ xs, int M, int K) {
  const int K2 = K / 2, hi0 = (int)pair_hi(K);
  const size_t ld = (size_t)pair_ld(K);
  const size_t q = (size_t)K / 4, total = (size_t)M * q;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / q;
    const int c = (int)(i % q) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint16_t* row = xs + 2 * m * ld;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16 b = __float2bfloat16_rn(f[e]);
      const int col = c + e < K2 ? c + e : hi0 + c + e - K2;
      row[col] = __bfloat16_as_ushort(b);
      row[ld + col] = bf16_bits(__fsub_rn(f[e], __bfloat162float(b)));
    }
    if (c == 0)
      for (int col = K2; col < hi0; ++col) row[col] = row[ld + col] = 0;
  }
}

}  // namespace wot
}  // namespace aimet
