// The GEMM tile for prefill M on Hopper, one structure for six weight
// formats (decode_gemm.cuh's kinds), in place of aimet::bf_tile and
// aimet::s8_tile:
//   dec::kW4Bf16: KW4 (wo_gemm.cu, aimet_w4_tile_gemm; replaces
//     aimet_tpu/ops/int_matmul.py:1023, matmul_w4): x bf16 or f32, W
//     split-half packed INT4, (K/2, N) int8: packed row p holds k = p (low
//     nibble, stored + 8) and k = p + K/2 (high nibble, two's complement);
//     out = (x @ W) * sw, f32 sums;
//   dec::kW8Bf16: KW8 (wo_gemm.cu, aimet_w8_tile_gemm; replaces
//     int_matmul.py:245, matmul_w8): x bf16 or f32, W int8 codes (K, N);
//     out = (x @ W) * sw, f32 sums;
//   dec::kW4Int8: K2 (w4a8_gemm.cu, aimet_w4a8_tile_gemm; replaces the
//     GEMM of int_matmul.py:692 and :767): x the per-row int8 codes (M,
//     K), W split-half INT4; out = (f32(sum) * sx[m]) * sw[n], exact int32
//     sums, so bit-exact;
//   dec::kW8Int8: KSQ (w8a8_staticq.cu, aimet_staticq_tile_gemm; replaces
//     int_matmul.py:593, matmul_w8a8_staticq): x the static int8 codes (M,
//     K), W int8 codes (K, N); out = fma(f32(sum), sv[n], cb[n]), exact
//     int32 sums, so bit-exact;
//   dec::kQ8: KQ8's f32 / bf16 entries (w8a8_gemm.cu, aimet_q8_tile_gemm;
//     replaces int_matmul.py:378, matmul_q8, and through it the GEMM of
//     :456, matmul_w8a8_fusedq): KSQ's operands and stage, x the per-row
//     dynamic int8 codes with row scales sx; out = (f32(sum) * sx[m]) *
//     sw[n], or fma(f32(sum) * sx[m], sw[n], cb[n]) with a column bias,
//     bit-exact;
//   dec::kW4Grouped: KW4G (wo_gemm.cu, aimet_w4g_tile_gemm; replaces
//     int_matmul.py:960, matmul_w4_grouped): x bf16 or f32, W split-half
//     INT4 with one f32 scale a (K-group, column), gs (K/group, N); out =
//     sum_g (x_g @ W_g) * gs[g, n], f32 sums, the codes exact in bf16.
//
// Bound on the H100: the tensor-core rate (bf16 989 TFLOP/s dense, int8
// 1,979 TOP/s; an f32 x is two bf16 operands, twice the operations). The
// design keeps wgmma busy while the weights, which wgmma cannot take in
// their stored form (INT4) or as bf16 (int8 codes), are unpacked beside
// it:
// - out^T = W^T x^T. The unpacked weights are wgmma's A operand, from
//   registers, 64 weight columns an instruction; x, K-major as it lies in
//   memory, is B from shared memory, 128 rows of x an instruction
//   (m64n128k16 bf16, m64n128k32 s8). So the weights go from shared memory
//   to registers once and never back.
// - A persistent grid, one block an SM, walks 128 x 256 output tiles
//   (x rows x weight columns; KW4G 128 x 128): bands of kBand M tiles, M fastest within a
//   band, so the tiles a wave runs together read few x tiles and weight
//   slabs (8 x 1 MB and ~17 x 0.5 MB at K = 4096: L2-resident).
// - A producer warpgroup (one thread issues) keeps a shared-memory ring
//   fed with TMA loads, a full / empty mbarrier pair a stage. A stage
//   (Stage<kKind>) is kRows weight rows (packed rows for INT4) in two
//   weight boxes (KW4G one; kRows rows x 128 columns, 128-byte swizzle, so the
//   fragment loads meet no bank conflicts), and kXBoxes x boxes of 128
//   rows x 128 bytes (128-byte swizzle): for INT4 two, x[:, p..] and
//   x[:, K/2 + p..], the halves each packed byte meets; for int8 weights
//   one. Rows and k past the matrices arrive as zeros. The stages are
//   sized so the ring holds about 192 KB: KW4 4 stages of 64 packed rows
//   (128 k, 48 KB), KW8 6 of 64 rows (64 k, 32 KB: int8 weights stream
//   twice the bytes a k, so a stage holds half the k of KW4's in fewer
//   bytes, and the ring keeps 6 in flight), K2 3 of 128 packed rows (256
//   k, 64 KB: a 128-byte x box row is 128 int8 k, four s8 k-steps, the
//   descriptor stride of the bf16 tile), KSQ and KQ8 4 of 128 rows (128
//   k, 48 KB), KW4G 5 of 64 packed rows (128 k, 40 KB: one weight box). The
//   producer runs on into the next tile while the consumers store, so one
//   tile's epilogue overlaps the next one's loads.
// - Two consumer warpgroups, 128 weight columns each (two m64 slices), 128
//   sums a thread (kW4Grouped: 64 columns each, see below). A 32-bit
//   shared load takes 4 columns of one weight row;
//   the thread's A rows g and g + 8 of both slices are those 4 columns
//   (slice s's row g is column 2s, row g + 8 column 2s + 1 of the word;
//   the epilogue follows the permutation), so one load serves both
//   slices:
//   - bf16 A (m64n128k16: rows 2t, 2t + 1, 2t + 8, 2t + 9 of 16 k): a byte
//     permute pairs two rows' bytes, then INT4 0x4300 | nibble - 136
//     (decode_gemm.cuh's nibbles_bf16x2) or int8 (v & 0x7F) | 0x4300 minus
//     (v & 0x80) | 0x4300 (int8_bf16x2), both exact;
//   - s8 A (m64n128k32: 4 consecutive k a register, k 4t.. and 16 + 4t..
//     of 32): 4 loads of packed rows 4t.. (and 16 + 4t..), the plane's
//     nibbles sign-extended to int8 (nibbles_s8x4), then a 4 x 4 byte
//     transpose (transpose4) gives each column its 4 k; int8 weights
//     (kW8Int8, kQ8) are the same loads and transpose without the nibble
//     step.
//   A warpgroup unpacks a whole stage (64 registers of A fragments for
//   INT4, 32 for int8 weights), then issues the stage's wgmmas and waits
//   for them before it releases the stage: ptxas serializes wgmmas whose
//   register operands other instructions define while earlier ones are in
//   flight (its C7513 report), so the unpack overlaps the other
//   warpgroup's MMAs, not the warpgroup's own.
// - Registers: 128 sums, a stage's A fragments and the unpack need ~200 a
//   thread; ptxas gives a 384-thread block 168 (and 288 threads no more),
//   where the tiles spill or serialize. setmaxnreg moves the producer
//   warpgroup's registers to the consumers: 40 and 232.
// - Packed rows past K/2 in the last stage are set to 0x08 bytes, which
//   unpack to 0 in both planes: the low plane's x box there holds x's high
//   half, not zeros. (int8 weight rows past K arrive as zeros, as do x's
//   k past K.)
// - x's boxes must start 16-byte aligned in memory: a TMA box whose first
//   column is not hangs the load (measured: K/2 = 100 bf16 values). So a
//   bf16 x needs K/2 % 8 == 0 under INT4 weights and K % 8 == 0 under
//   int8 ones, and K2's int8 codes K/2 % 16 == 0.
// - f32 x (KW4, KW8, KW4G): a prologue pass (wo_gemm.cu) writes x as
//   pairs of bf16 rows, 2M rows of pair_ld values: row 2m the bf16 high
//   part of x[m], row 2m + 1 its bf16 residual (as bf_tile splits it:
//   within ~2^-16 of the f32 product). Under INT4 weights x's high half
//   starts at column pair_hi(K), 16-byte aligned, the columns between the
//   halves 0; under int8 weights the columns are x's, rows 16-byte
//   aligned. The tile then runs unchanged on 64 rows of x a tile; columns
//   2i and 2i + 1 of a thread's sums are one row's two parts, added in
//   the epilogue.
// - kW4Grouped keeps the port's numerics: the codes stay exact, and each
//   plane's f32 sums over a stage are folded into the running sums once,
//   times their group's f32 scale (a stage lies in one group of each
//   plane: group % 64 == 0, so the fold per stage is the fold per group
//   of bf_tile cut into 64-k parts; folding two stages at a time, once a
//   group of 128, spilled and measured no faster at the lowered forward's
//   shapes). The stage's sums of one plane need a second set of registers
//   beside the running ones, and 128 + 128 do not fit in 232: so this
//   kind's tile is 128 map rows x 128 columns, one m64 slice (64 columns)
//   a warpgroup, 64 + 64 sums a thread. A thread's A rows g and g + 8 are
//   columns 2g and 2g + 1 of its warp's 16 (a 16-bit load of a weight
//   row). The warpgroup unpacks both planes of its stage, issues the low
//   plane's wgmmas into the stage sums (scale-d 0 on the first, so no
//   zeroing pass), waits, folds acc = fma(G, gs[g, n], acc), then the
//   high plane's the same way; the scales are read before the stage's
//   wait.
// - No split K: at prefill M the tiles fill the SMs, so each output is one
//   fixed sum and repeated calls give the same bits. The epilogue scales
//   each column once and stores 4 columns (KW4G 2) a row from registers.
#pragma once
#include <algorithm>

#include "decode_gemm.cuh"
#include "tma_wgmma.cuh"

namespace aimet {
namespace wot {

constexpr int kBM = 128;                  // rows of x (of pairs: 64 rows)
constexpr int kConsumerWarps = 8;         // 2 warpgroups
// the producer: a warpgroup, so that setmaxnreg can move its registers to
// the consumers (one thread issues the loads)
constexpr int kProducerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + kProducerWarps);
// registers a thread: ptxas gives a 384-thread block 168; the producer
// gives back all but 40, the consumers take 232 (128 sums, a stage's A
// fragments, the unpack)
constexpr bool kSetMaxNReg = true;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kXBox = kBM * 128;          // 128 rows x 128 bytes
constexpr int kBand = 8;                  // M tiles a band of the tile order

// A ring stage of each format: kRows weight rows (packed for INT4) in
// kBN / 128 boxes of kRows x 128 columns, kXBoxes x boxes; kStages of
// them; groups of kGroup weight rows feed one wgmma k-step; Acc the sums'
// type; kBN the tile's weight columns (kSlices m64 slices a warpgroup).
template <int kKind>
struct Stage;
template <>
struct Stage<dec::kW4Bf16> {
  using Acc = float;
  static constexpr int kRows = 64, kXBoxes = 2, kStages = 4, kGroup = 16;
  static constexpr int kBN = 256;
};
template <>
struct Stage<dec::kW8Bf16> {
  using Acc = float;
  static constexpr int kRows = 64, kXBoxes = 1, kStages = 6, kGroup = 16;
  static constexpr int kBN = 256;
};
template <>
struct Stage<dec::kW4Int8> {
  using Acc = int;
  static constexpr int kRows = 128, kXBoxes = 2, kStages = 3, kGroup = 32;
  static constexpr int kBN = 256;
};
// KSQ: 128 k a stage (one 128-byte x box row of int8 codes), 48 KB
template <>
struct Stage<dec::kW8Int8> {
  using Acc = int;
  static constexpr int kRows = 128, kXBoxes = 1, kStages = 4, kGroup = 32;
  static constexpr int kBN = 256;
};
// KQ8: KSQ's stage (the same operands; only the epilogue differs)
template <>
struct Stage<dec::kQ8> : Stage<dec::kW8Int8> {};
// KW4G: KW4's stage on half the columns (40 KB), one slice a warpgroup
template <>
struct Stage<dec::kW4Grouped> {
  using Acc = float;
  static constexpr int kRows = 64, kXBoxes = 2, kStages = 5, kGroup = 16;
  static constexpr int kBN = 128;
};
template <int kKind>
__host__ __device__ constexpr int slices() {
  return Stage<kKind>::kBN / 128;
}
template <int kKind>
__host__ __device__ constexpr int stage_bytes() {
  return Stage<kKind>::kXBoxes * kXBox +
         slices<kKind>() * Stage<kKind>::kRows * 128;
}
// the ring, and 1024 bytes to align it
template <int kKind>
__host__ __device__ constexpr int smem_bytes() {
  return Stage<kKind>::kStages * stage_bytes<kKind>() + 1024;
}

// d += A . B for one warpgroup: A 64 x 16 bf16 in registers (a, the
// fragment of mma.m16n8k16's A, warp w holding rows 16 w..), B 128 x 16
// bf16, K-major in shared memory (descriptor db); f32 sums (scale_d 1:
// accumulate; 0: d = A . B)
__device__ __forceinline__ void wgmma_bf16_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db,
                                                   int scale_d = 1) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The same for int8: A 64 x 32 s8 in registers (mma.m16n8k32's A
// fragment a warp: 4 consecutive k a register), B 128 x 32 s8 K-major in
// shared memory; exact int32 sums
__device__ __forceinline__ void wgmma_s8_rs_n128(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
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

// One warpgroup's MMAs on the stage at st (x boxes first), its weight box
// at wb, `rows` weight rows of the stage valid; (chunk, cbyte): the
// thread's 4 columns in a 128-byte box row. Unpacks the whole stage, then
// issues its wgmmas and waits for them (see the header).
template <int kKind>
__device__ __forceinline__ void stage_mma(
    const unsigned char* st, const unsigned char* wb, int rows, int chunk,
    int cbyte, int t, typename Stage<kKind>::Acc (&acc)[2][64]) {
  using S = Stage<kKind>;
  constexpr int kGroups = S::kRows / S::kGroup;
  // the word of weight row r (128-byte swizzled box)
  auto word = [&](int r) {
    return ld_u32(wb + r * 128 + ((chunk ^ (r & 7)) << 4) + cbyte);
  };
  if constexpr (kKind == dec::kW8Int8 || kKind == dec::kQ8) {
    // a[group][slice][register]: group q is weight rows 32 q..; register
    // 0 (1) is slice s's row g (g + 8), column 2s (2s + 1) of the word, k
    // 4t..; registers 2, 3 the same at k 16 + 4t.. (K2's fragments without
    // the nibble step; rows past K arrive as zeros)
    uint32_t a[kGroups][2][4];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      uint32_t wv[8];                  // weight rows 32q + 4t + i (+ 16)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 32 * q + 4 * t + (i & 3) + 16 * (i >> 2);
        wv[i] = word(r);
      }
      uint32_t u0[4] = {wv[0], wv[1], wv[2], wv[3]};
      uint32_t u1[4] = {wv[4], wv[5], wv[6], wv[7]};
      uint32_t b0[4], b1[4];
      dec::transpose4(u0, b0);         // b0[c]: column c's k 4t..4t+3
      dec::transpose4(u1, b1);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        a[q][s][0] = b0[2 * s];
        a[q][s][1] = b0[2 * s + 1];
        a[q][s][2] = b1[2 * s];
        a[q][s][3] = b1[2 * s + 1];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const uint64_t db = sw128_desc(st + 32 * q);
      wgmma_s8_rs_n128(acc[0], a[q][0], db);
      wgmma_s8_rs_n128(acc[1], a[q][1], db);
    }
  } else if constexpr (kKind == dec::kW4Int8) {
    // a[group][slice][plane]: group q is packed rows 32 q..; register 0
    // (1) is slice s's row g (g + 8), column 2s (2s + 1) of the word, k
    // 4t..; registers 2, 3 the same at k 16 + 4t..
    uint32_t a[kGroups][2][2][4];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      uint32_t wv[8];                  // packed rows 32q + 4t + i (+ 16)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 32 * q + 4 * t + (i & 3) + 16 * (i >> 2);
        wv[i] = word(r);
        if (rows < S::kRows && r >= rows) wv[i] = 0x08080808u;
      }
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        uint32_t u0[4], u1[4], b0[4], b1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u0[i] = pl ? dec::nibbles_s8x4<true>(wv[i])
                     : dec::nibbles_s8x4<false>(wv[i]);
          u1[i] = pl ? dec::nibbles_s8x4<true>(wv[4 + i])
                     : dec::nibbles_s8x4<false>(wv[4 + i]);
        }
        dec::transpose4(u0, b0);       // b0[c]: column c's k 4t..4t+3
        dec::transpose4(u1, b1);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          a[q][s][pl][0] = b0[2 * s];
          a[q][s][pl][1] = b0[2 * s + 1];
          a[q][s][pl][2] = b1[2 * s];
          a[q][s][pl][3] = b1[2 * s + 1];
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t db = sw128_desc(st + h * kXBox + 32 * q);
        wgmma_s8_rs_n128(acc[0], a[q][0][h], db);
        wgmma_s8_rs_n128(acc[1], a[q][1][h], db);
      }
  } else {
    // bf16 A: a[group][slice][plane][register]; group q is weight rows
    // 16 q.., byte 2s (+1) of a word slice s's row g (g + 8)
    constexpr int kPlanes = kKind == dec::kW4Bf16 ? 2 : 1;
    uint32_t a[kGroups][2][kPlanes][4];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      // weight rows 16 q + 2t, +1, +8, +9
      uint32_t wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * q + 2 * t + (i & 1) + 8 * (i >> 1);
        wv[i] = word(r);
        if (kPlanes == 2 && rows < S::kRows && r >= rows)
          wv[i] = 0x08080808u;
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
          if constexpr (kPlanes == 2) {
            a[q][s][0][e] = dec::nibbles_bf16x2<false>(p01);
            a[q][s][0][2 + e] = dec::nibbles_bf16x2<false>(p89);
            a[q][s][1][e] = dec::nibbles_bf16x2<true>(p01 >> 4);
            a[q][s][1][2 + e] = dec::nibbles_bf16x2<true>(p89 >> 4);
          } else {
            a[q][s][0][e] = dec::int8_bf16x2(p01);
            a[q][s][0][2 + e] = dec::int8_bf16x2(p89);
          }
        }
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
#pragma unroll
      for (int h = 0; h < kPlanes; ++h) {
        const uint64_t db = sw128_desc(st + h * kXBox + 32 * q);
        wgmma_bf16_rs_n128(acc[0], a[q][0][h], db);
        wgmma_bf16_rs_n128(acc[1], a[q][1][h], db);
      }
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// kW4Grouped: one warpgroup's stage at st (x boxes, then the weight box),
// its m64 slice of weight columns at (chunk, cbyte): bytes 2g, 2g + 1 of
// the box row's 16-byte chunk `chunk` (A rows g and g + 8 of the thread's
// warp). For each plane: its wgmmas into the stage's group sums gsum
// (scale-d 0 on the first), a wait, then acc = fma(gsum, the column's
// scale, acc); sc[plane] holds the thread's two columns' scales of the
// plane's group. (R % 64 == 0: no stage is partial.)
__device__ __forceinline__ void stage_mma_grouped(
    const unsigned char* st, int chunk, int cbyte, int t,
    const float2 (&sc)[2], float (&acc)[64], float (&gsum)[64]) {
  using S = Stage<dec::kW4Grouped>;
  constexpr int kGroups = S::kRows / S::kGroup;
  const unsigned char* wb = st + S::kXBoxes * kXBox;
  // two columns of weight row r (128-byte swizzled box), in bits 0-15
  auto word = [&](int r) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
        wb + r * 128 + ((chunk ^ (r & 7)) << 4) + cbyte));
  };
  // a[group][plane][register]: group q is packed rows 16 q..; registers
  // 0 (1) and 2 (3) are the thread's row g (g + 8): column 2g (2g + 1)
  uint32_t a[kGroups][2][4];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    uint32_t wv[4];                    // packed rows 16q + 2t, +1, +8, +9
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * q + 2 * t + (i & 1) + 8 * (i >> 1);
      wv[i] = word(r);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t sel = e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12);
      const uint32_t p01 = __byte_perm(wv[0], wv[1], sel);
      const uint32_t p89 = __byte_perm(wv[2], wv[3], sel);
      a[q][0][e] = dec::nibbles_bf16x2<false>(p01);
      a[q][0][2 + e] = dec::nibbles_bf16x2<false>(p89);
      a[q][1][e] = dec::nibbles_bf16x2<true>(p01 >> 4);
      a[q][1][2 + e] = dec::nibbles_bf16x2<true>(p89 >> 4);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
      wgmma_bf16_rs_n128(gsum, a[q][h], sw128_desc(st + h * kXBox + 32 * q),
                         q > 0);
    wgmma_commit();
    wgmma_wait<0>();
    // gsum[i]: column 2g + ((i >> 1) & 1) of the warp's 16
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = __fmaf_rn(gsum[i], (i & 2) ? sc[h].y : sc[h].x, acc[i]);
  }
}

// out (M, N) = (x @ W) * sw (K2: (f32(x @ W) * sx[m]) * sw[n]; KSQ:
// fma(f32(x @ W), sw[n], cb[n]); KQ8: K2's, or fma(f32(x @ W) * sx[m],
// sw[n], cb[n]) where cb is given; KW4G: sum_g (x_g @ W_g) * sw[g, n], sw
// then (2R / group, N)); map_x: x
// (M rows) or its pairs (kPairX: 2M rows), boxes of 128 rows x 128 bytes,
// box b of a stage from column b * x_hi (INT4: x's high half, 16-byte
// aligned); map_w: the weights (R rows), boxes of Stage::kRows rows x 128
// columns; tiles_m tiles of 128 map rows, tiles_n of Stage::kBN columns.
// Each format's kernel below is this body under its own name.
template <int kKind, typename OutT, bool kPairX>
__device__ __forceinline__ void tile_body(
    const CUtensorMap& map_x, const CUtensorMap& map_w,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ cb, OutT* __restrict__ out, int M, int N,
    int R, int x_hi, int group, int tiles_m, int tiles_n,
    unsigned char* smem, uint64_t* full, uint64_t* empty) {
  using S = Stage<kKind>;
  constexpr int kSlices = slices<kKind>();
  constexpr bool kGrouped = kKind == dec::kW4Grouped;
  constexpr int kStage = stage_bytes<kKind>();
  constexpr int kWBox = S::kRows * 128;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~(uintptr_t)1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ksteps = (R + S::kRows - 1) / S::kRows;
  const int tiles = tiles_m * tiles_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kConsumerWarps) {                    // the producer
    if constexpr (kSetMaxNReg)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (warp != kConsumerWarps || lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mt, nt;
      tile_at(tile, tiles_m, tiles_n, mt, nt);
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = base + stage * kStage;
        mbar_arrive_expect_tx(&full[stage], kStage);
#pragma unroll
        for (int b = 0; b < S::kXBoxes; ++b)
          tma_load(st + b * kXBox, &map_x, b * x_hi + ks * S::kRows,
                   mt * kBM, &full[stage]);
        unsigned char* wdst = st + S::kXBoxes * kXBox;
#pragma unroll
        for (int b = 0; b < kSlices; ++b)
          tma_load(wdst + b * kWBox, &map_w, nt * S::kBN + 128 * b,
                   ks * S::kRows, &full[stage]);
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes weight columns kBN / 2 * wg.. of each
  // tile
  if constexpr (kSetMaxNReg)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // this thread's columns: two slices, 4 columns: byte 4g.. of chunk
  // 2 wl + g / 4 of a row of the warpgroup's box; one slice (KW4G), 2
  // columns: bytes 2g, 2g + 1 of chunk 4 wg + wl of the one box
  const int chunk = kSlices == 2 ? 2 * wl + (g >> 2) : 4 * wg + wl;
  const int cbyte = kSlices == 2 ? (g & 3) * 4 : 2 * g;
  const int wbox = kSlices == 2 ? wg * kWBox : 0;
  // the thread's first column within a tile
  const int col0 = kSlices == 2 ? wg * 128 + 32 * wl + 4 * g
                                : wg * 64 + 16 * wl + 2 * g;
  int stage = 0;
  uint32_t phase = 0;
  typename S::Acc acc[kSlices][64];
  float gsum[kGrouped ? 64 : 1];       // KW4G: a stage's sums of one plane
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt;
    tile_at(tile, tiles_m, tiles_n, mt, nt);
    const int n = nt * S::kBN + col0;
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[s][i] = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      if constexpr (kGrouped) {
        // the two columns' scales of the stage's group in each plane,
        // read before the stage's wait (N % 16: both columns or neither)
        float2 sc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if (n < N) {
          const int g_lo = ks * S::kRows / group;
          sc[0] = __ldg(reinterpret_cast<const float2*>(
              sw + (size_t)g_lo * N + n));
          sc[1] = __ldg(reinterpret_cast<const float2*>(
              sw + (size_t)(R / group + g_lo) * N + n));
        }
        mbar_wait(&full[stage], phase);
        stage_mma_grouped(base + stage * kStage, chunk, cbyte, t, sc, acc[0],
                          gsum);
      } else {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = base + stage * kStage;
        stage_mma<kKind>(st, st + S::kXBoxes * kXBox + wbox,
                         R - ks * S::kRows, chunk, cbyte, t, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // acc[s][4j + 2h + e]: map row 8j + 2t + e of the tile, weight column
    // n + 2s + h (two slices) or n + h (one)
    if (n >= N) continue;                          // N % 16: whole quads
    constexpr int kCols = 2 * kSlices;
    // the columns' scales (KSQ, and KQ8 with a bias: and biases), one
    // vector load each
    auto cols = [&](const float* p, float (&d)[kCols]) {
      if constexpr (kCols == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(p + n);
        d[0] = v4.x, d[1] = v4.y, d[2] = v4.z, d[3] = v4.w;
      } else {
        const float2 v2 = *reinterpret_cast<const float2*>(p + n);
        d[0] = v2.x, d[1] = v2.y;
      }
    };
    float s_[kCols] = {}, c_[kCols] = {};
    if constexpr (!kGrouped) cols(sw, s_);
    if constexpr (kKind == dec::kW8Int8) cols(cb, c_);
    if constexpr (kKind == dec::kQ8)
      if (cb != nullptr) cols(cb, c_);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < (kPairX ? 1 : 2); ++e) {
        const int m = kPairX ? mt * (kBM / 2) + 4 * j + t
                             : mt * kBM + 8 * j + 2 * t + e;
        if (m >= M) continue;
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = 4 * j + 2 * (c & 1);
          const int sl = c >> 1;
          if constexpr (kKind == dec::kW4Int8)
            v[c] = __fmul_rn(__fmul_rn(__int2float_rn(acc[sl][i + e]), sx[m]),
                             s_[c]);
          else if constexpr (kKind == dec::kW8Int8)
            v[c] = __fmaf_rn(__int2float_rn(acc[sl][i + e]), s_[c], c_[c]);
          else if constexpr (kKind == dec::kQ8) {
            const float a = __fmul_rn(__int2float_rn(acc[sl][i + e]), sx[m]);
            v[c] = cb != nullptr ? __fmaf_rn(a, s_[c], c_[c])
                                 : __fmul_rn(a, s_[c]);
          } else if constexpr (kGrouped)
            v[c] = kPairX ? acc[sl][i] + acc[sl][i + 1] : acc[sl][i + e];
          else
            v[c] = __fmul_rn(kPairX ? acc[sl][i] + acc[sl][i + 1]
                                    : acc[sl][i + e],
                             s_[c]);
        }
        OutT* o = out + (size_t)m * N + n;
        if constexpr (kCols == 4 && sizeof(OutT) == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else if constexpr (kCols == 2 && sizeof(OutT) == 4) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
          uint32_t u[kCols / 2];
#pragma unroll
          for (int c = 0; c < kCols / 2; ++c) {
            const __nv_bfloat162 b =
                __floats2bfloat162_rn(v[2 * c], v[2 * c + 1]);
            u[c] = *reinterpret_cast<const uint32_t*>(&b);
          }
          if constexpr (kCols == 4)
            *reinterpret_cast<uint2*>(o) = make_uint2(u[0], u[1]);
          else
            *reinterpret_cast<uint32_t*>(o) = u[0];
        }
      }
  }
}

#define AIMET_TILE_KERNEL(NAME, KIND)                                       \
  template <typename OutT, bool kPairX>                                     \
  __global__ void __launch_bounds__(kThreads, 1)                            \
      NAME(const __grid_constant__ CUtensorMap map_x,                       \
           const __grid_constant__ CUtensorMap map_w,                       \
           const float* __restrict__ sx, const float* __restrict__ sw,      \
           const float* __restrict__ cb, OutT* __restrict__ out, int M,     \
           int N, int R, int x_hi, int group, int tiles_m, int tiles_n) {   \
    extern __shared__ unsigned char wot_smem[];                             \
    __shared__ __align__(8) uint64_t full[Stage<KIND>::kStages];            \
    __shared__ __align__(8) uint64_t empty[Stage<KIND>::kStages];           \
    tile_body<KIND, OutT, kPairX>(map_x, map_w, sx, sw, cb, out, M, N, R,   \
                                  x_hi, group, tiles_m, tiles_n, wot_smem,  \
                                  full, empty);                             \
  }
AIMET_TILE_KERNEL(w4_tile_kernel, dec::kW4Bf16)     // KW4
AIMET_TILE_KERNEL(w8_tile_kernel, dec::kW8Bf16)     // KW8
AIMET_TILE_KERNEL(w4a8_tile_kernel, dec::kW4Int8)   // K2
AIMET_TILE_KERNEL(staticq_tile_kernel, dec::kW8Int8)  // KSQ
AIMET_TILE_KERNEL(w4g_tile_kernel, dec::kW4Grouped)   // KW4G
AIMET_TILE_KERNEL(q8_tile_kernel, dec::kQ8)           // KQ8
#undef AIMET_TILE_KERNEL

// format kKind's kernel
template <int kKind, typename OutT, bool kPairX>
auto tile_kernel() {
  if constexpr (kKind == dec::kW4Bf16)
    return w4_tile_kernel<OutT, kPairX>;
  else if constexpr (kKind == dec::kW8Bf16)
    return w8_tile_kernel<OutT, kPairX>;
  else if constexpr (kKind == dec::kW4Int8)
    return w4a8_tile_kernel<OutT, kPairX>;
  else if constexpr (kKind == dec::kW8Int8)
    return staticq_tile_kernel<OutT, kPairX>;
  else if constexpr (kKind == dec::kQ8)
    return q8_tile_kernel<OutT, kPairX>;
  else
    return w4g_tile_kernel<OutT, kPairX>;
}

// Launches format kKind's tile on stream s: a persistent grid of
// min(tiles, SMs) blocks over ceil(xrows / 128) x ceil(N / Stage::kBN)
// tiles. mx maps x (xrows = M) or its pairs (xrows = 2M) in boxes of 128
// rows x 128 bytes; mw the weights (R rows) in boxes of Stage::kRows rows
// x 128 columns; x_hi: the x column of a stage's second box (INT4: K/2 or
// the pairs' pair_hi); sx: K2's and KQ8's row scales, cb: KSQ's column
// bias (KQ8's, or null), group: KW4G's group (else unused).
template <int kKind, typename OutT, bool kPairX>
int launch_tile(const CUtensorMap& mx, const CUtensorMap& mw,
                const float* sx, const float* sw, const float* cb, OutT* out,
                int M, int N, int R, int x_hi, int group, int xrows,
                cudaStream_t s) {
  static int sms = 0;                        // the card's SMs, once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return static_cast<int>(e);
  }
  auto kern = tile_kernel<kKind, OutT, kPairX>();
  static bool ready = false;                 // the smem limit, once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<kKind>());
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int tiles_m = (xrows + kBM - 1) / kBM;
  const int tiles_n = (N + Stage<kKind>::kBN - 1) / Stage<kKind>::kBN;
  const int grid = std::min(tiles_m * tiles_n, sms);
  kern<<<grid, kThreads, smem_bytes<kKind>(), s>>>(mx, mw, sx, sw, cb, out,
                                                   M, N, R, x_hi, group,
                                                   tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

// The pair rows of an f32 x under INT4 weights: the column of x's high
// half (16-byte aligned), and the bf16 values a row holds (16-byte rows)
__host__ __device__ constexpr long long pair_hi(int K) {
  return (K / 2 + 7) / 8 * 8;
}
__host__ __device__ constexpr long long pair_ld(int K) {
  return (pair_hi(K) + K / 2 + 7) / 8 * 8;
}
// under int8 weights: x's K columns, rows of a multiple of 8 values
__host__ __device__ constexpr long long pair_ld_w8(int K) {
  return (K + 7LL) / 8 * 8;
}

}  // namespace wot
}  // namespace aimet
