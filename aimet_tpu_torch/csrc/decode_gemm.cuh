// The decode weight-streaming GEMM: a block-level device routine shared by
// KW8's and KW4's decode routes (wo_gemm.cu, wo_decode_kernel), K2's
// (w4a8_gemm.cu, w4a8_decode_kernel) and the GEMM phases of the
// whole-layer decode kernel (fused_layer.cu: KFL, KSOL, KDL).
//
// It computes x (M <= 64 rows) @ W, partial sums over a range of W's rows,
// for three weight formats:
//   kW4Bf16: split-half INT4 weights, bf16 x, bf16 MMAs
//            (mma.sync.m16n8k16), f32 sums;
//   kW4Int8: split-half INT4 weights, per-row int8 x, int8 MMAs
//            (mma.sync.m16n8k32.s8), exact int32 sums;
//   kW8Bf16: int8 weight codes, bf16 x, bf16 MMAs, f32 sums.
// A split-half packed row p holds k = p (low nibble, stored + 8) and
// k = p + K/2 (high nibble, two's complement); x's two halves meet it.
//
// Bound on the H100: bytes. A decode GEMM does 2 M operations a weight
// (4 M a packed INT4 byte, 32 to 256 at M = 16..64), below the ~295 a byte
// at which the bf16 tensor cores would bound it; so the design aims at
// HBM bytes per second alone:
// - A deep asynchronous weight ring. A block is 8 consumer warps and one
//   producer warp, one block an SM. The producer keeps copies in flight
//   into a shared-memory ring of stages of kR weight rows x kW columns
//   (16 KB) and the matching x columns, an mbarrier pair a
//   stage (full / empty): the weight rows as 16-byte cp.async by its 32
//   lanes, each lane arriving on the full barrier once its copies land
//   (cp.async.mbarrier.arrive.noinc), and the x columns as one TMA tile a
//   half (cp.async.bulk.tensor from a tensor map, 128-byte swizzled,
//   64-byte for int8 x; rows past M filled with zeros), whose
//   arrive.expect_tx is the stage's last arrival. The ring takes what
//   shared memory holds after the stage size, 6 to 11 stages, so
//   80-180 KB are in flight an SM (HBM's 3.35 TB/s x ~1 us over 132 SMs
//   asks for 25 KB). Weights go by cp.async, not TMA: TMA tiles of them
//   (128-byte boxes swizzled, or 256-byte boxes plain) streamed slower at
//   decode M, and one bulk copy a 256-byte row was issue-bound (PERF.md,
//   the whole-layer kernel's findings). Weight rows sit kW + 16 bytes
//   apart, so the fragment loads meet no bank conflicts (the int8-dot
//   ones 2-way).
// - The weights of a GEMM need nothing from the phase before it: a kernel
//   with several GEMMs issues a phase's first stages ahead (issue_ahead).
// - Rows past M are never multiplied: the M tile is 16, 32, 48 or 64 rows
//   (mt m16 blocks), a compile-time MT from the consumers' dispatch on.
// - Every block streams the same number of weight bytes: the (column
//   slice, stage) units of the whole GEMM, slices of kW = 256 columns (the
//   last one may be narrower: its columns past N are neither loaded nor
//   stored) and stages of kR rows, are cut into `blocks`
//   contiguous ranges of equal length (within one unit). A range may end
//   in one slice and go on in the next: each (slice, block) meeting is a
//   piece, whose partial sums go to workspace slot (slice + block)
//   (unique: along the ranges each new piece steps the slice, the block
//   or both). A caller adds a slice's pieces in block order, i.e. in K
//   order, so the result does not depend on the run (int32 sums are
//   exact in any order anyway).
// - Consumer warp w takes the 32 columns 32 w.. of the slice. B fragments come from the staged bytes in
//   registers: a 32-bit shared load takes 4 columns of one row, and a byte
//   permute puts byte c of two rows into n8 block c (the MMA's column g of
//   n8 block c is slice column 4g + c), so one load feeds 4 MMAs. INT4 to
//   bf16: 0x4300 | n is the bf16 128 + n, minus 136 (lo) or sign-folded
//   (hi); int8 to bf16: (v & 0x7F) | 0x4300 minus (v & 0x80) | 0x4300 (128
//   or 256), exact; INT4 to int8: sign-extend the nibble (x | (x & 8) *
//   0x1E a byte), then a 4 x 4 byte transpose so a register holds 4
//   consecutive k. A fragments come from the staged x by ldmatrix.
// - mma.sync, not wgmma: wgmma takes 64-row A tiles, and at M = 16 a
//   decode GEMM is far from the tensor cores' rate.
//
// Requirements (the callers check them): 1 <= M <= 64; K a multiple of 16
// rows of W (INT4: K/2 packed rows a multiple of 16); N, and the row
// strides of W and x in bytes, multiples of 16; W and x 16-byte aligned
// (x: the tensor map's rules). The host encodes the x maps (x_map).
#pragma once
#include <cuda.h>

#include <type_traits>

#include "gemm_tiles.cuh"
#include "tma_wgmma.cuh"

namespace aimet {
namespace dec {

constexpr int kR = 64;                    // weight rows a stage
constexpr int kW = 256;                   // columns a slice
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kMaxStages = 16;
constexpr int kMaxMT = 4;                 // m16 blocks: M <= 64
// shared memory: barriers (and the caller's scratch) first, then the ring
// from the next 1024-byte boundary (the swizzled boxes' alignment)
constexpr int kHeaderBytes = 1024;
constexpr int kSmemBytes = 220 * 1024;
constexpr int kRingBytes = kSmemBytes - kHeaderBytes - 1024;

// The weight formats. The first three are this routine's (Fmt); the last
// three only the prefill tile's (wgmma_wo_tile.cuh): int8 weights x the
// static int8 codes of x (KSQ), split-half INT4 with one scale a
// (K-group, column) under a bf16 x (KW4G), and int8 weights x the per-row
// dynamic int8 codes of x (KQ8: KSQ's stage, row scales in the epilogue).
enum Kind { kW4Bf16 = 0, kW4Int8 = 1, kW8Bf16 = 2, kW8Int8 = 3,
            kW4Grouped = 4, kQ8 = 5 };

template <int kKind>
struct Fmt {
  static_assert(kKind <= kW8Bf16, "not a kind of the decode routine");
  static constexpr bool kW4 = kKind != kW8Bf16;
  static constexpr bool kInt8 = kKind == kW4Int8;
  static constexpr int kPlanes = kW4 ? 2 : 1;      // x halves a stage
  static constexpr int kXBytes = kInt8 ? 1 : 2;    // bytes an x value
  static constexpr int kXRow = kR * kXBytes;       // bytes of an x box row
  using Acc = typename std::conditional<kInt8, int, float>::type;
};

// shared bytes of an x box (16 mt rows), of a stage (an x box a half,
// then kR weight rows of kW + 16 bytes: the pad puts the rows a fragment
// load touches in distinct banks; 1024-byte multiples, the boxes'
// alignment), and the ring's stages
template <int kKind>
__host__ __device__ constexpr int x_box_bytes(int mt) {
  return 16 * mt * Fmt<kKind>::kXRow;
}
template <int kKind>
__host__ __device__ constexpr int stage_bytes(int mt) {
  return (Fmt<kKind>::kPlanes * x_box_bytes<kKind>(mt) + kR * (kW + 16) +
          1023) / 1024 * 1024;
}
template <int kKind>
__host__ __device__ constexpr int ring_stages(int mt) {
  return kRingBytes / stage_bytes<kKind>(mt) < kMaxStages
             ? kRingBytes / stage_bytes<kKind>(mt)
             : kMaxStages;
}

// The split of one GEMM's (slice, stage) units over `blocks` blocks.
struct Geo {
  int M, K2, N;        // rows of x; rows of W; columns of one weight
  int halves;          // weights side by side (phase B: gate, up)
  int nsl1, nslices;   // slices of one weight; of all
  int steps;           // stages a slice
  int blocks;          // blocks that stream (<= the grid)
  long long total;     // nslices * steps units

  __host__ __device__ Geo(int M_, int K2_, int N_, int halves_, int grid) {
    M = M_, K2 = K2_, N = N_, halves = halves_;
    nsl1 = (N + kW - 1) / kW;
    nslices = halves * nsl1;
    steps = (K2 + kR - 1) / kR;
    total = (long long)nslices * steps;
    // at least two stages a block
    const long long most = total / 2 > 0 ? total / 2 : 1;
    blocks = (int)(grid < most ? grid : most);
  }
  __host__ __device__ long long start(int b) const {
    return (long long)b * total / blocks;
  }
  // the block whose range holds unit u
  __host__ __device__ int block_of(long long u) const {
    return (int)(((u + 1) * blocks - 1) / total);
  }
  // the blocks that hold pieces of slice j
  __host__ __device__ int first_block(int j) const {
    return block_of((long long)j * steps);
  }
  __host__ __device__ int last_block(int j) const {
    return block_of((long long)(j + 1) * steps - 1);
  }
  // values of the partial-sum workspace: a slot of M x kW for each
  // (slice, block) meeting, at slice + block
  __host__ __device__ long long ws_values() const {
    return (long long)(nslices + blocks - 1) * M * kW;
  }
};

// The operands of one GEMM: weights W (K2 rows of N bytes, ldw bytes
// apart) and, for phase B, W2 supplying slices nsl1.. (the same stride);
// x as a tensor map in kernel parameter space (M rows, K values, boxes of
// kR values x 16 mt rows). For INT4 the k of a packed row's high nibble
// lies x_hi values after its low one (K/2).
struct Operand {
  const int8_t* w;
  const int8_t* w2;
  int ldw;
  const CUtensorMap* x;
  int x_hi;
};

// The ring: barriers in the header, `stages` slots after it; `it` counts
// the stages this thread has passed, the same in every thread.
// pre: stages of the next GEMM whose weight rows the producer already
// issued (its own count; issue_ahead).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;
  int stages, stage_bytes;
  uint32_t it;
  int pre;
};

// the mbarrier, TMA and tensor-map helpers are tma_wgmma.cuh's; other
// kernels reach these two as dec::
using aimet::fence_proxy_async;
using aimet::smem_addr;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// one arrival on bar once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the consumer warps' own barrier (the producer does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// Sum or max over the consumer warps (red: kConsumerWarps floats of
// shared memory); each of them gets the result, in a fixed order.
__device__ __forceinline__ float consumer_reduce(float v, bool is_max,
                                                 float* red) {
  v = is_max ? warp_max(v) : warp_sum(v);
  consumer_sync();                       // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  consumer_sync();
  float r = red[0];
  for (int w = 1; w < kConsumerWarps; ++w)
    r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The ring in a block's shared memory `smem` (header first); make_ring
// also has one thread initialise the barriers (init_ring), after which the
// caller needs a block barrier.
template <int kKind>
__device__ __forceinline__ Ring ring_of(unsigned char* smem, int mt) {
  Ring r;
  r.full = reinterpret_cast<uint64_t*>(smem);
  r.empty = r.full + kMaxStages;
  r.base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + kHeaderBytes + 1023) &
      ~(uintptr_t)1023);
  r.stages = ring_stages<kKind>(mt);
  r.stage_bytes = stage_bytes<kKind>(mt);
  r.it = 0;
  r.pre = 0;
  return r;
}
__device__ __forceinline__ void init_ring(const Ring& r) {
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kMaxStages; ++s) {
    mbar_init(&r.full[s], 33);        // the producer's lanes, and x's TMA
    mbar_init(&r.empty[s], kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
template <int kKind>
__device__ __forceinline__ Ring make_ring(unsigned char* smem, int mt) {
  Ring r = ring_of<kKind>(smem, mt);
  init_ring(r);
  return r;
}

// bf16x2 of two nibbles, in bits 0-3 and 16-19 of v: n - 8 (lo), or with
// kSigned the two's-complement nibble (hi); exact: 0x4300 | n is 128 + n
template <bool kSigned>
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) | 0x43004300u;
  if (kSigned) r ^= 0x00080008u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&r);
  h = __hsub2(h, __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<uint32_t*>(&h);
}
// bf16x2 of two int8 values in bits 0-7 and 16-23 of v, exact:
// 128 + (v & 0x7F), minus 128 (v >= 0) or 256 (v < 0)
__device__ __forceinline__ uint32_t int8_bf16x2(uint32_t v) {
  uint32_t a = (v & 0x007F007Fu) | 0x43004300u;
  uint32_t c = (v & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&h);
}
// the 4 nibbles of one plane of a word of packed bytes as int8: lo
// (p & 15) - 8, hi p >> 4 (arithmetic)
template <bool kHi>
__device__ __forceinline__ uint32_t nibbles_s8x4(uint32_t w) {
  const uint32_t x = kHi ? (w >> 4) & 0x0F0F0F0Fu
                         : (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  return x | ((x & 0x08080808u) * 0x1Eu);
}
// 4 x 4 byte transpose: out[c] byte i = byte c of r[i]
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t u01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t u23 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t01, t23, 0x5410);
  out[1] = __byte_perm(t01, t23, 0x7632);
  out[2] = __byte_perm(u01, u23, 0x5410);
  out[3] = __byte_perm(u01, u23, 0x7632);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// One piece of this block's range: slice j, weight rows [r0, r1).
struct Piece {
  int j, r0, r1;
};

// Calls f(piece) for each piece of block b's range, in order.
template <typename F>
__device__ __forceinline__ void for_pieces(const Geo& g, int b, F&& f) {
  if (b >= g.blocks) return;
  long long u = g.start(b);
  const long long u1 = g.start(b + 1);
  while (u < u1) {
    const int j = (int)(u / g.steps);
    const long long ue = min(u1, (long long)(j + 1) * g.steps);
    const int s0 = (int)(u - (long long)j * g.steps);
    const int s1 = (int)(ue - (long long)j * g.steps);
    f(Piece{j, s0 * kR, min(s1 * kR, g.K2)});
    u = ue;
  }
}

// The producer warp's copy of a stage's weight rows (piece p, rows r..)
// into ring slot `slot`, in 16-byte chunks, lane-strided so the loop does
// no division (kW / 16 chunks a row); each lane then arrives on the slot's
// full barrier once its copies land (the x box's TMA brings the last
// arrival). Weight rows sit after the x boxes, kW + 16 bytes apart: the
// pad puts the rows a fragment load touches in distinct banks.
template <int kKind>
__device__ __forceinline__ void copy_weights(const Ring& ring,
                                             const Operand& o, const Geo& g,
                                             const Piece& p, int r,
                                             uint32_t slot, int mt) {
  constexpr int kCpr = kW / 16, kLdw = kW + 16;
  const int lane = threadIdx.x & 31;
  const bool second = p.j >= g.nsl1;
  const int n0 = (second ? p.j - g.nsl1 : p.j) * kW;
  const int rows = min(kR, p.r1 - r);
  const int c = lane % kCpr;
  const bool on = 16 * c < g.N - n0;
  const int8_t* src = (second ? o.w2 : o.w) + n0 +
                      (size_t)(r + lane / kCpr) * o.ldw + 16 * c;
  unsigned char* dst = ring.base + (size_t)slot * ring.stage_bytes +
                       Fmt<kKind>::kPlanes * x_box_bytes<kKind>(mt) +
                       (lane / kCpr) * kLdw + 16 * c;
  const size_t step = (size_t)(32 / kCpr) * o.ldw;
#pragma unroll 4
  for (int rr = lane / kCpr; rr < rows; rr += 32 / kCpr) {
    if (on) cp_async16(dst, src);
    src += step;
    dst += (32 / kCpr) * kLdw;
  }
  cp_async_arrive(&ring.full[slot]);
}

// The producer warp issues the weight rows of the first `most` stages of
// a coming GEMM (op, g) into the ring's next slots, as they free; that
// GEMM's stream_gemm then adds only the x boxes (ring.pre). A GEMM's
// weights need nothing from the phase before it, so they can stream in
// during that phase's epilogue and the grid-wide barriers.
template <int kKind>
__device__ __forceinline__ void issue_ahead(const Operand& op, const Geo& g,
                                            int mt, Ring& ring, int most) {
  int n = 0;
  for_pieces(g, blockIdx.x, [&](const Piece& p) {
    for (int r = p.r0; r < p.r1 && n < most; r += kR, ++n) {
      const uint32_t it = ring.it + n;
      const uint32_t slot = it % ring.stages;
      mbar_wait(&ring.empty[slot], ((it / ring.stages) & 1) ^ 1);
      copy_weights<kKind>(ring, op, g, p, r, slot, mt);
    }
  });
  ring.pre = n;
}

// A consumer warp's MMAs on one ring stage at `st` (x boxes, then the
// weight rows), `rows` weight rows of it valid (kFull: all kR, so the
// slices need no guard and every weight word of the stage is loaded
// before the first MMA). See stream_gemm for the fragments.
template <int kKind, int MT, bool kFull>
__device__ __forceinline__ void stage_mma(
    const unsigned char* st, int rows,
    typename Fmt<kKind>::Acc (&acc)[MT][4][4]) {
  using F = Fmt<kKind>;
  constexpr int kLdw = kW + 16;
  constexpr int kXBox = x_box_bytes<kKind>(MT);
  const unsigned char* wst = st + F::kPlanes * kXBox;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, gq = lane >> 2;
  const int col = warp * 32 + 4 * gq;            // this thread's words
  // ldmatrix: this lane's row of an m16 block and its 16-byte half
  const int lrow = lane & 15, lhalf = lane >> 4;
  auto wword = [&](int r) { return ld_u32(wst + r * kLdw + col); };
  // the ldmatrix address of this lane in x box pl: row `row`, 16-byte
  // chunk q (128-byte swizzle; 64-byte for 64-byte int8 rows)
  auto xaddr = [&](int pl, int row, int q) {
    const int sq = F::kXRow == 128 ? q ^ (row & 7) : q ^ ((row >> 1) & 3);
    return st + pl * kXBox + row * F::kXRow + (sq << 4);
  };
  if constexpr (kKind == kW4Int8) {
    // k32 slices: packed rows 32q.. of the stage, both planes
    uint32_t w[kR / 32][8];
#pragma unroll
    for (int q = 0; q < kR / 32; ++q) {
      if (!kFull && 32 * q >= rows) break;          // warp-uniform
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[q][i] = wword(32 * q + 4 * t + i);
        w[q][4 + i] = wword(32 * q + 16 + 4 * t + i);
      }
    }
#pragma unroll
    for (int q = 0; q < kR / 32; ++q) {
      if (!kFull && 32 * q >= rows) break;          // warp-uniform
      const bool half = !kFull && 32 * q + 16 >= rows;   // k 16..31 absent
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        uint32_t u0[4], u1[4], b0[4], b1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u0[i] = pl ? nibbles_s8x4<true>(w[q][i])
                     : nibbles_s8x4<false>(w[q][i]);
          u1[i] = pl ? nibbles_s8x4<true>(w[q][4 + i])
                     : nibbles_s8x4<false>(w[q][4 + i]);
        }
        transpose4(u0, b0);
        transpose4(u1, b1);
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          uint32_t a[4];
          ldmatrix_x4(a, xaddr(pl, 16 * mb + lrow, 2 * q + lhalf));
          if (half) a[2] = a[3] = 0u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t b[2] = {b0[c], b1[c]};
            mma_s8(acc[mb][c], a, b);
          }
        }
      }
    }
  } else {
    // k16 slices: 16 rows of the stage each (INT4: both planes)
    uint32_t v[kR / 16][4];
#pragma unroll
    for (int jj = 0; jj < kR / 16; ++jj) {
      if (!kFull && 16 * jj >= rows) break;         // warp-uniform
      const int r0 = 16 * jj + 2 * t;
      v[jj][0] = wword(r0);
      v[jj][1] = wword(r0 + 1);
      v[jj][2] = wword(r0 + 8);
      v[jj][3] = wword(r0 + 9);
    }
#pragma unroll
    for (int jj = 0; jj < kR / 16; ++jj) {
      if (!kFull && 16 * jj >= rows) break;         // warp-uniform
#pragma unroll
      for (int pl = 0; pl < F::kPlanes; ++pl) {
        uint32_t b[4][2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
          const uint32_t p01 = __byte_perm(v[jj][0], v[jj][1], sel);
          const uint32_t p89 = __byte_perm(v[jj][2], v[jj][3], sel);
          if constexpr (F::kW4) {
            if (pl) {
              b[c][0] = nibbles_bf16x2<true>(p01 >> 4);
              b[c][1] = nibbles_bf16x2<true>(p89 >> 4);
            } else {
              b[c][0] = nibbles_bf16x2<false>(p01);
              b[c][1] = nibbles_bf16x2<false>(p89);
            }
          } else {
            b[c][0] = int8_bf16x2(p01);
            b[c][1] = int8_bf16x2(p89);
          }
        }
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          uint32_t a[4];
          ldmatrix_x4(a, xaddr(pl, 16 * mb + lrow, 2 * jj + lhalf));
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_bf16(acc[mb][c], a, b[c]);
        }
      }
    }
  }
}

// The consumer warps' side of stream_gemm, for an M tile of MT m16
// blocks.
template <int kKind, int MT, typename OnPiece>
__device__ __forceinline__ void consume(const Geo& g, Ring& ring,
                                        OnPiece& on_piece) {
  using Acc = typename Fmt<kKind>::Acc;
  const int lane = threadIdx.x & 31;
  for_pieces(g, blockIdx.x, [&](const Piece& p) {
    Acc acc[MT][4][4];
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][c][e] = 0;
    for (int r = p.r0; r < p.r1; r += kR) {
      const int rows = min(kR, p.r1 - r);
      const uint32_t slot = ring.it % ring.stages;
      mbar_wait(&ring.full[slot], (ring.it / ring.stages) & 1);
      const unsigned char* st = ring.base + (size_t)slot * ring.stage_bytes;
      if (rows == kR)
        stage_mma<kKind, MT, true>(st, rows, acc);
      else
        stage_mma<kKind, MT, false>(st, rows, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.empty[slot]);
      ++ring.it;
    }
    on_piece(p, acc);
  });
}

// Streams this block's pieces of one GEMM through the ring. The consumer
// warps call on_piece(piece, acc) once a piece is done: acc
// [m16 block][n8 block][4] holds the thread's sums over the piece's rows,
// element (mb, c, e) at row 16 mb + g + 8 (e >> 1) and column
// 32 warp + 8 t + 4 (e & 1) + c of the slice (store_piece). The producer warp only copies; stages whose
// weights issue_ahead already issued get only their x boxes. Every thread
// of the block must call it.
template <int kKind, typename OnPiece>
__device__ __forceinline__ void stream_gemm(const Operand& op, const Geo& g,
                                            int mt, Ring& ring,
                                            OnPiece&& on_piece) {
  using F = Fmt<kKind>;
  const int xbox = x_box_bytes<kKind>(mt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {                  // the producer
    int k = 0;                                   // stages of this GEMM
    for_pieces(g, blockIdx.x, [&](const Piece& p) {
      for (int r = p.r0; r < p.r1; r += kR, ++k) {
        const uint32_t slot = ring.it % ring.stages;
        if (k >= ring.pre) {                     // not issued ahead
          mbar_wait(&ring.empty[slot], ((ring.it / ring.stages) & 1) ^ 1);
          copy_weights<kKind>(ring, op, g, p, r, slot, mt);
        }
        // the x box of each half (rows past M filled with zeros), by TMA
        if (lane == 0) {
          unsigned char* xs = ring.base + (size_t)slot * ring.stage_bytes;
          mbar_arrive_expect_tx(&ring.full[slot], F::kPlanes * xbox);
          for (int pl = 0; pl < F::kPlanes; ++pl)
            tma_load(xs + pl * xbox, op.x, pl * op.x_hi + r, 0,
                     &ring.full[slot]);
        }
        ++ring.it;
      }
    });
    ring.pre = 0;
    return;
  }

  switch (mt) {               // the M tile: compile-time from here on
    case 1: consume<kKind, 1>(g, ring, on_piece); break;
    case 2: consume<kKind, 2>(g, ring, on_piece); break;
    case 3: consume<kKind, 3>(g, ring, on_piece); break;
    default: consume<kKind, 4>(g, ring, on_piece); break;
  }
}

// Writes a consumer thread's sums of a piece into dst (M rows of kW
// values): rows < M, columns < ncols.
template <int MT, typename Acc>
__device__ __forceinline__ void store_piece(
    Acc* dst, const Acc (&acc)[MT][4][4], int M, int ncols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, gq = lane >> 2;
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * mb + gq + 8 * (e >> 1);
      const int n = warp * 32 + 8 * t + 4 * (e & 1);
      if (m >= M || n >= ncols) continue;
      Acc* d = dst + (size_t)m * kW + n;
      d[0] = acc[mb][0][e];
      d[1] = acc[mb][1][e];
      d[2] = acc[mb][2][e];
      d[3] = acc[mb][3][e];
    }
}

// The sum of a slice's pieces at (m, c..c+3) of workspace ws (slots of
// M x kW; c a multiple of 4), in block order (K order); a slice's slots
// are consecutive. Loads go 8 at a time
// (through L2: other blocks wrote them), so their latencies overlap.
template <typename Acc>
struct Vec4 {
  using T = typename std::conditional<std::is_same<Acc, int>::value, int4,
                                      float4>::type;
};
template <typename Acc>
__device__ __forceinline__ typename Vec4<Acc>::T slice_sum4(
    const Acc* ws, const Geo& g, int j, int m, int c) {
  using V = typename Vec4<Acc>::T;
  const int b0 = g.first_block(j);
  const int n = g.last_block(j) - b0 + 1;
  const size_t slot = (size_t)g.M * kW;
  const Acc* p = ws + (size_t)(j + b0) * slot + (size_t)m * kW + c;
  V v = {0, 0, 0, 0};
  for (int i0 = 0; i0 < n; i0 += 8) {
    V t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i0 + i < n)
        t[i] = __ldcg(reinterpret_cast<const V*>(p + (i0 + i) * slot));
      else
        t[i] = V{0, 0, 0, 0};
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v.x += t[i].x;
      v.y += t[i].y;
      v.z += t[i].z;
      v.w += t[i].w;
    }
  }
  return v;
}

// ------------------------------------------------------------ host side
// the x map of an (m, k) activation matrix of kKind's x type, for M
// tiles of mt m16 blocks
template <int kKind>
bool x_map(CUtensorMap* map, const void* x, int m, int k, int mt) {
  constexpr int e = Fmt<kKind>::kXBytes;
  return encode_2d(map,
                   e == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   e, x, m, k, (long long)k * e, 16 * mt, Fmt<kKind>::kXRow);
}

}  // namespace dec
}  // namespace aimet
