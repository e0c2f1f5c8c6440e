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
//   0 (KSOL)  ao = decode attention (decode_attention.cuh, K3's function
//             one block a (row, kv head)): rope, INT8-KV quantize and
//             in-place append, GQA over the cache
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
// Design: one launch per layer with cudaLaunchCooperativeKernel, one block
// an SM (8 consumer warps and a producer warp), phases separated by
// cooperative_groups' grid-wide barrier (grid.sync(), no relocatable
// device code needed).
// - The GEMM phases run the decode weight-streaming routine
//   (decode_gemm.cuh): every block streams an equal share of the phase's
//   weight bytes through its ring (the inputs by TMA from tensor maps
//   encoded at launch) and writes the partial sums of its pieces (column
//   slice, K range) to the workspace `part`.
// - The epilogues spread over all blocks and run on the consumer warps,
//   4 columns a thread, while each block's producer warp issues the next
//   GEMM phase's first weight stages (kAhead). A and C take items
//   of (row, 1024 columns): the pieces added in K order (the result does
//   not depend on the run), the scales and the residual, and a partial of
//   the row's sum of squares; the block that brings a row's last partial
//   (an atomic count a row) adds the partials in order and does the next
//   RMSNorm and, with int8 dots, the row's quantization. B's items are
//   4 columns: silu(g) * u, and with int8 dots the row's absmax by
//   atomicMax (exact in any order), then a quantization pass of its own.
//   So each phase is a GEMM and an epilogue, a grid-wide barrier after
//   each, plus the int8 row quantizations of the attention output and h.
// The intermediates y, h, out live in workspaces the wrapper allocates.
// Unlike the TPU kernel, no weight chunk is held in a manual DMA slot, so
// the W_o double-buffer race of decode_layer_sol.py:135 has no
// counterpart here.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_attention.cuh"
#include "decode_gemm.cuh"
#include "row_quant.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
namespace dec = aimet::dec;
constexpr int kThreads = dec::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16 * dec::kMaxMT;
constexpr int kW = dec::kW;              // columns a GEMM slice
constexpr int kE = 4 * kW;               // columns an epilogue item (A, C)
// weight stages the producer issues ahead for the next GEMM phase while
// the consumers run an epilogue: more stalls it on the copies' issue past
// the epilogue's end, none leaves the ring to refill at the phase's start
// (chip_smoke.py --layer-variants, PERF.md §6)
constexpr int kAhead = 2;
// shared memory: phase 0's attention scratch from byte 0; from phase A on
// the ring's barriers, the block reductions' scratch and a flag in the
// header, then the ring
constexpr int kRedOffset = 256;
constexpr int kFlagOffset = 512;

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
  void* part;              // (part_n,) f32 / int32 partial sums of a phase
  void* cnt;               // (3, M) int32: rows' partials in (zeroed here)
  void* rowpart;           // (rowpart_n,) f32: rows' partials
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
  unsigned long long* stamps;  // (kStamps,) %globaltimer ns, or null
  int M, A, D, F, Nq;
  int ld_gu;               // row stride of W_gate and W_up (F or 2F)
  int S, H, KH, HD;
  int part_n, rowpart_n;   // values of part and rowpart (checked at launch)
  float eps, sqrt_d;
};

// The GEMM phases' inputs as TMA tensor maps (decode_gemm.cuh), encoded by
// aimet_fused_layer: x_a (the attention output, M x A), xbuf as M x D and
// as M x F; with int8 dots they read xq instead.
struct LayerMaps {
  CUtensorMap xa, xd, xf;
};

// Block 0 writes %globaltimer into stamps[i] at kernel start (0), after
// each grid-wide barrier (1: attention, 2: int8 rows, 3/4: phase A's GEMM
// and epilogue, 5/6: B, 7: B's int8 rows, 8/9: C, 10: D's GEMM) and at its
// end (11), when the pointer is set; a slot not reached stays as the
// caller left it. ops/fused_layer.py mirrors the slots.
__device__ __forceinline__ void stamp(const FusedLayerArgs& a, int i) {
  if (a.stamps == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  a.stamps[i] = t;
}

__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogues and the row quantizations run on the consumer warps (kET
// threads, their own barrier): meanwhile the producer warp issues the
// next GEMM phase's first weight stages.
constexpr int kET = 32 * dec::kConsumerWarps;

// Per-row INT8 quantization of the K values at xr (as K1: the shared row
// quantizer, row_quant.cuh) with the row's absmax `amax`: codes to qr,
// scale to *sx.
__device__ void quantize_row(const bf16* xr, int K, float amax, int8_t* qr,
                             float* sx) {
  const float scale = aimet::rowq::scale_of(amax);
  if (threadIdx.x == 0) *sx = scale;
  aimet::rowq::quantize_share<true>(xr, K, scale, qr, threadIdx.x, kET);
}

// A GEMM phase: this block's pieces of x @ W (and W2) into `part`,
// slot (slice + block) of M x kW partial sums each.
template <int kKind>
__device__ __forceinline__ void gemm(const dec::Operand& op,
                                     const dec::Geo& g, int mt,
                                     dec::Ring& ring, void* part) {
  using Acc = typename dec::Fmt<kKind>::Acc;
  Acc* ws = static_cast<Acc*>(part);
  dec::stream_gemm<kKind>(
      op, g, mt, ring, [&](const dec::Piece& p, const auto& acc) {
        const int n0 = (p.j >= g.nsl1 ? p.j - g.nsl1 : p.j) * kW;
        dec::store_piece(ws + (size_t)(p.j + blockIdx.x) * g.M * kW, acc,
                         g.M, min(kW, g.N - n0));
      });
}

// A phase's output elements (m, columns n..n+3 of weight h; n % 4 == 0,
// within one slice) to v: their pieces in K order times their scales.
template <bool kInt8>
__device__ __forceinline__ void phase_values4(const void* part,
                                              const dec::Geo& g, int h,
                                              int m, int n, float sxm,
                                              const float* sw,
                                              float (&v)[4]) {
  const int j = h * g.nsl1 + n / kW, c = n % kW;
  if constexpr (kInt8) {
    const int4 q = dec::slice_sum4<int>(
        static_cast<const int*>(part), g, j, m, c);
    const int qi[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __fmul_rn(__fmul_rn(__int2float_rn(qi[e]), sxm), sw[n + e]);
  } else {
    const float4 q = dec::slice_sum4<float>(
        static_cast<const float*>(part), g, j, m, c);
    const float qf[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(qf[e], sw[n + e]);
  }
}

// 4 bf16 values at p (8-byte aligned) as f32, through L2
__device__ __forceinline__ void load4_cg(const bf16* p, float (&v)[4]) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ uint2 pack4(const float (&v)[4]) {
  uint2 u;
  bf16* b = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) b[e] = __float2bfloat16_rn(v[e]);
  return u;
}

// After an epilogue item (row m, slice j of nsl) left its partial v of a
// row reduction: whether this block brought the row's last one. The
// block barrier, then one thread's fence, release the item's outputs
// (the pattern of CUTLASS's inter-block semaphores); the last block's
// fence after the count orders its reads of the others' after theirs.
__device__ bool row_done(int* cnt, float* rowpart, int m, int j, int nsl,
                         float v, int* flag) {
  dec::consumer_sync();
  if (threadIdx.x == 0) {
    rowpart[(size_t)m * nsl + j] = v;
    __threadfence();
    const bool last = atomicAdd(&cnt[m], 1) == nsl - 1;
    if (last) __threadfence();
    *flag = last;
  }
  dec::consumer_sync();
  return *flag;
}

// atomicMax of v (>= 0, as int bits) into rowmax[m] for each lane's row
// m (-1: none), one atomic a warp where its lanes share a row. Every lane
// of the warp calls it.
__device__ __forceinline__ void row_max_into(int* rowmax, int m, float v) {
  const int m0 = __shfl_sync(0xffffffffu, m, 0);
  if (__all_sync(0xffffffffu, m == m0 || m < 0)) {
    v = aimet::warp_max(v);
    if ((threadIdx.x & 31) == 0 && m0 >= 0)
      atomicMax(rowmax + m0, __float_as_int(v));
  } else if (m >= 0) {
    atomicMax(rowmax + m, __float_as_int(v));
  }
}

// A row's partials, in slice order: their sum or their max.
__device__ float row_total(const float* rowpart, int m, int nsl,
                           bool is_max) {
  float r = __ldcg(rowpart + (size_t)m * nsl);
  for (int j = 1; j < nsl; ++j) {
    const float v = __ldcg(rowpart + (size_t)m * nsl + j);
    r = is_max ? fmaxf(r, v) : r + v;
  }
  return r;
}

// Row m of rmsnorm(v, gamma) with v at vr (written by other blocks) and
// its sum of squares `sumsq` to dst (D % 8 == 0); returns this thread's
// share of the result's absmax.
__device__ float norm_row(const bf16* vr, float sumsq, const bf16* gamma,
                          int D, float eps, bf16* dst) {
  const float r = rsqrtf(sumsq / (float)D + eps);
  float amax = 0.0f;
  for (int n = 8 * threadIdx.x; n < D; n += 8 * kET) {
    float v[8], gm[8];
    aimet::rowq::ld8<true>(vr + n, v);
    aimet::rowq::ld8<true>(gamma + n, gm);
    uint4 o;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = round_bf(round_bf(v[i] * r) * gm[i]);
      ob[i] = __float2bfloat16_rn(x);
      amax = fmaxf(amax, fabsf(x));
    }
    *reinterpret_cast<uint4*>(dst + n) = o;
  }
  return amax;
}

template <bool kAttn, bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
fused_layer_kernel(const FusedLayerArgs a,
                   const __grid_constant__ LayerMaps maps) {
  constexpr int kKind = kInt8 ? dec::kW4Int8 : dec::kW4Bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kRedOffset);
  int* flag = reinterpret_cast<int*>(smem + kFlagOffset);
  cg::grid_group grid = cg::this_grid();
  const int M = a.M, A = a.A, D = a.D, F = a.F, Nq = a.Nq;
  const int mt = (M + 15) / 16;
  const bf16* resid = static_cast<const bf16*>(a.resid);
  bf16* y = static_cast<bf16*>(a.y);
  bf16* xbuf = static_cast<bf16*>(a.xbuf);
  bf16* out = static_cast<bf16*>(a.out);
  int8_t* xq = static_cast<int8_t*>(a.xq);
  float* sx = static_cast<float*>(a.sx);   // [phase A..D][M]
  int* cnt = static_cast<int*>(a.cnt);     // [phase A..C][M]
  float* rowpart = static_cast<float*>(a.rowpart);
  const float* so = static_cast<const float*>(a.so);
  const float* sg = static_cast<const float*>(a.sg);
  const float* su = static_cast<const float*>(a.su);
  const float* sd = static_cast<const float*>(a.sd);
  const bool has_next = a.qkv_next != nullptr;   // the same for every block
  const bool producer = threadIdx.x / 32 == dec::kConsumerWarps;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < 3 * M; i += kThreads) cnt[i] = 0;
  stamp(a, 0);
  // a grid-wide barrier after which bulk copies may read what any block
  // wrote before it (and overwrite shared memory it used)
  auto barrier = [&](int i) {
    dec::fence_proxy_async();
    grid.sync();
    stamp(a, i);
  };

  // the GEMM phases: weights, inputs and their split
  const dec::Geo ga(M, A / 2, D, 1, gridDim.x);
  const dec::Geo gb(M, D / 2, F, 2, gridDim.x);
  const dec::Geo gc(M, F / 2, D, 1, gridDim.x);
  const dec::Geo gd(M, D / 2, Nq, 1, gridDim.x);
  auto w8p = [](const void* p) { return static_cast<const int8_t*>(p); };
  const dec::Operand oa{w8p(a.wo), nullptr, D, &maps.xa, A / 2};
  const dec::Operand ob{w8p(a.wg), w8p(a.wu), a.ld_gu, &maps.xd, D / 2};
  const dec::Operand oc{w8p(a.wd), nullptr, D, &maps.xf, F / 2};
  const dec::Operand od{w8p(a.wq), nullptr, Nq, &maps.xd, D / 2};
  dec::Ring ring = dec::ring_of<kKind>(smem, mt);

  // --- phase 0 (KSOL): attention, one (row, kv head) at a time, its
  // scratch from byte 0 of shared memory; attention_body ends with a block
  // barrier, after which the ring's barriers take the header
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
    x_a = ao;
  }
  // one thread sets up the ring's barriers; the grid barrier after phase
  // 0 (or the block barrier below) orders that before their first use
  dec::init_ring(ring);
  if constexpr (kAttn) barrier(1);
  __syncthreads();
  if constexpr (kInt8) {
    if (!producer)
      for (int m = blockIdx.x; m < M; m += gridDim.x) {
        const bf16* xr = x_a + (size_t)m * A;
        const float amax = dec::consumer_reduce(
            aimet::rowq::absmax_share<true>(xr, A, threadIdx.x, kET), true,
            red);
        quantize_row(xr, A, amax, xq + (size_t)m * A, sx + m);
      }
    barrier(2);
  }

  // --- phase A: y = bf16(ao @ W_o) + resid; then rmsnorm(y) -> xbuf, in
  // items of 4 x 256 columns of a row (4 columns a thread); meanwhile the
  // producer issues phase B's first weight stages (so for each phase)
  gemm<kKind>(oa, ga, mt, ring, a.part);
  barrier(3);
  const int nA = (D + kE - 1) / kE;
  if (producer) {
    dec::issue_ahead<kKind>(ob, gb, mt, ring, kAhead);
  } else {
    for (int item = blockIdx.x; item < M * nA; item += gridDim.x) {
      const int m = item / nA, j = item % nA;
      const int n = j * kE + 4 * threadIdx.x;
      const size_t row = (size_t)m * D;
      float ss = 0.0f;
      if (n < D) {
        float v[4], r4[4];
        phase_values4<kInt8>(a.part, ga, 0, m, n,
                             kInt8 ? __ldcg(sx + m) : 1.0f, so, v);
        load4_cg(resid + row + n, r4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = round_bf(round_bf(v[e]) + r4[e]);
          ss += v[e] * v[e];
        }
        *reinterpret_cast<uint2*>(y + row + n) = pack4(v);
      }
      ss = dec::consumer_reduce(ss, false, red);
      if (!row_done(cnt, rowpart, m, j, nA, ss, flag)) continue;
      const float amax = norm_row(y + row, row_total(rowpart, m, nA, false),
                                  static_cast<const bf16*>(a.mlp_gamma), D,
                                  a.eps, xbuf + row);
      if (kInt8)
        quantize_row(xbuf + row, D, dec::consumer_reduce(amax, true, red),
                     xq + row, sx + M + m);
    }
  }
  barrier(4);

  // --- phase B: h = bf16(silu(g) * u) -> xbuf; 4 columns a thread
  gemm<kKind>(ob, gb, mt, ring, a.part);
  barrier(5);
  int* rowmax = cnt + M;        // int8: bits of the rows' absmax of h (>= 0)
  if (producer) {
    dec::issue_ahead<kKind>(oc, gc, mt, ring, kAhead);
  } else {
    for (int base = blockIdx.x * kET; base < M * F / 4;
         base += gridDim.x * kET) {
      const int i = base + threadIdx.x;   // the warp stays whole (shuffles)
      if (kInt8 && i >= M * F / 4) {
        row_max_into(rowmax, -1, 0.0f);
        continue;
      }
      if (i >= M * F / 4) continue;
      const int m = i / (F / 4), n = 4 * (i % (F / 4));
      const float sxm = kInt8 ? __ldcg(sx + M + m) : 1.0f;
      float g[4], u[4];
      phase_values4<kInt8>(a.part, gb, 0, m, n, sxm, sg, g);
      phase_values4<kInt8>(a.part, gb, 1, m, n, sxm, su, u);
      float amax = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sig = 1.0f / (1.0f + expf(-g[e]));
        g[e] = round_bf(__fmul_rn(__fmul_rn(g[e], sig), u[e]));
        amax = fmaxf(amax, fabsf(g[e]));
      }
      *reinterpret_cast<uint2*>(xbuf + (size_t)m * F + n) = pack4(g);
      if (kInt8) row_max_into(rowmax, m, amax);
    }
  }
  barrier(6);
  if constexpr (kInt8) {
    // h's per-row quantization (a max is exact in any order)
    if (!producer)
      for (int i = blockIdx.x * kET + threadIdx.x; i < M * F / 8;
           i += gridDim.x * kET) {
        const int m = i / (F / 8), n = 8 * (i % (F / 8));
        const float scale =
            aimet::rowq::scale_of(__int_as_float(__ldcg(rowmax + m)));
        if (n == 0) sx[2 * M + m] = scale;
        float v[8];
        aimet::rowq::ld8<true>(xbuf + (size_t)m * F + n, v);
        uint2 q;
        int8_t* b = reinterpret_cast<int8_t*>(&q);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          b[e] = aimet::rowq::code(v[e], scale);
        *reinterpret_cast<uint2*>(xq + (size_t)m * F + n) = q;
      }
    barrier(7);
  }

  // --- phase C: out = bf16(h @ W_down) + y; then rmsnorm(out) -> xbuf
  gemm<kKind>(oc, gc, mt, ring, a.part);
  barrier(8);
  if (producer) {
    if (has_next) dec::issue_ahead<kKind>(od, gd, mt, ring, kAhead);
  } else {
    for (int item = blockIdx.x; item < M * nA; item += gridDim.x) {
      const int m = item / nA, j = item % nA;
      const int n = j * kE + 4 * threadIdx.x;
      const size_t row = (size_t)m * D;
      float ss = 0.0f;
      if (n < D) {
        float v[4], y4[4];
        phase_values4<kInt8>(a.part, gc, 0, m, n,
                             kInt8 ? __ldcg(sx + 2 * M + m) : 1.0f, sd, v);
        load4_cg(y + row + n, y4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = round_bf(round_bf(v[e]) + y4[e]);
          ss += v[e] * v[e];
        }
        *reinterpret_cast<uint2*>(out + row + n) = pack4(v);
      }
      if (!has_next) continue;
      ss = dec::consumer_reduce(ss, false, red);
      if (!row_done(cnt + 2 * M, rowpart, m, j, nA, ss, flag)) continue;
      const float amax = norm_row(out + row,
                                  row_total(rowpart, m, nA, false),
                                  static_cast<const bf16*>(a.attn_gamma), D,
                                  a.eps, xbuf + row);
      if (kInt8)
        quantize_row(xbuf + row, D, dec::consumer_reduce(amax, true, red),
                     xq + row, sx + 3 * M + m);
    }
  }
  if (!has_next) {
    stamp(a, 11);
    return;
  }
  barrier(9);

  // --- phase D: the next layer's qkv = bf16(rmsnorm(out) @ W_qkv)
  gemm<kKind>(od, gd, mt, ring, a.part);
  barrier(10);
  const float* sq = static_cast<const float*>(a.sq);
  bf16* qn = static_cast<bf16*>(a.qkv_next);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < M * Nq / 4;
       i += gridDim.x * kThreads) {
    const int m = i / (Nq / 4), n = 4 * (i % (Nq / 4));
    float v[4];
    phase_values4<kInt8>(a.part, gd, 0, m, n,
                         kInt8 ? __ldcg(sx + 3 * M + m) : 1.0f, sq, v);
    *reinterpret_cast<uint2*>(qn + (size_t)m * Nq + n) = pack4(v);
  }
  stamp(a, 11);
}

using Kernel = void (*)(const FusedLayerArgs, const LayerMaps);

// The tensor maps of a launch; false if one cannot be encoded.
template <int kKind>
bool encode_maps(const FusedLayerArgs& a, bool attn, LayerMaps* m) {
  const int mt = (a.M + 15) / 16;
  const void* xa = kKind == dec::kW4Int8 ? a.xq : attn ? a.ao : a.attn_out;
  const void* xb = kKind == dec::kW4Int8 ? a.xq : a.xbuf;
  return dec::x_map<kKind>(&m->xa, xa, a.M, a.A, mt) &&
         dec::x_map<kKind>(&m->xd, xb, a.M, a.D, mt) &&
         dec::x_map<kKind>(&m->xf, xb, a.M, a.F, mt);
}

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

// Dynamic shared memory of the kernel, in bytes: the larger of the GEMM
// ring and (KSOL) the attention phase's scratch. S = 0 when the score rows
// go to the global workspace `scores`.
extern "C" int aimet_fused_layer_smem(int attn, int int8, int rep, int HD,
                                      int S) {
  size_t b = dec::kSmemBytes;
  if (attn)
    b = std::max(b, sizeof(float) *
                        aimet::attention_smem_floats(rep, HD, S, kWarps));
  return (int)b;
}

// The cooperative grid: co-resident blocks of the kernel, at most 4 a SM
// (one, at its shared memory).
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
// attn, int8 and smem. Requires 1 <= M <= 64; A, D, F multiples of 32;
// Nq and ld_gu multiples of 16, ld_gu >= F; weights and activations
// 16-byte aligned (decode_gemm.cuh's bulk copies); part_n at least the
// largest GEMM phase's workspace on this grid (Geo::ws_values), rowpart_n
// at least M x the epilogue items of a row (kE columns each).
extern "C" int aimet_fused_layer(const void* args, int attn, int int8,
                                 int grid, int smem, void* stream) {
  FusedLayerArgs a = *static_cast<const FusedLayerArgs*>(args);
  if (a.M <= 0 || a.M > kMaxRows || a.A % 32 || a.D % 32 || a.F % 32 ||
      a.Nq % 16 || a.ld_gu % 16 || a.ld_gu < a.F || grid <= 0 ||
      (int8 && !attn))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long part = std::max(
      {dec::Geo(a.M, a.A / 2, a.D, 1, grid).ws_values(),
       dec::Geo(a.M, a.D / 2, a.F, 2, grid).ws_values(),
       dec::Geo(a.M, a.F / 2, a.D, 1, grid).ws_values(),
       a.Nq ? dec::Geo(a.M, a.D / 2, a.Nq, 1, grid).ws_values() : 0ll});
  if (a.part_n < part || a.rowpart_n < (long long)a.M * ((a.D + kE - 1) / kE))
    return static_cast<int>(cudaErrorInvalidValue);
  LayerMaps maps;
  if (!(int8 ? encode_maps<dec::kW4Int8>(a, attn, &maps)
             : encode_maps<dec::kW4Bf16>(a, attn, &maps)))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k = pick(attn, int8);
  cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* kargs[] = {&a, &maps};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k), dim3(grid),
                                  dim3(kThreads), kargs, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
