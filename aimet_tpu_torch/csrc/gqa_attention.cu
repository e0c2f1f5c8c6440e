// KGQA: one-token GQA decode attention over the INT8 KV caches, with no
// append.
//
// Replaces aimet_tpu/ops/decode_attention.py:fused_gqa_decode_attention /
// _kernel, with the two elementwise folds the TPU version does around its
// pallas_call brought inside. Its oracle is fused_gqa_decode_attention_xla
// (decode_attention.py:101-114), the serving decode-attention math, in the
// reference's rounding order:
//   1. qs = q * T(k_scale / sqrt(D)) in q's dtype T: a bf16 q gets a bf16
//      factor and a bf16 product;
//   2. scores qs . k in f32 (a bf16 value times an int8 code is exact in
//      f32; an f32 q uses f32 FMAs, never TF32);
//   3. the mask s <= pos, -1e30 elsewhere (masked rows contribute exactly 0
//      after the softmax and are skipped);
//   4. the softmax in f32 over the whole live row: p = exp(s - m) / l with
//      the row's max m and sum l;
//   5. each p rounded to T (the reference's probs.astype(q.dtype));
//   6. the context sum_s p v from the int8 V rows in f32, times v_scale;
//      f32 out.
// A negative position masks every row: the softmax of S equal scores
// averages the S rows uniformly, as the reference's does. A position >= S
// attends over all S rows.
//
// Bound on the H100: bytes, (pos+1) x D of K and of V for each (row, kv
// head), at ~4 f32 operations a cache byte pair.
//
// Design: split S (flash-decoding), as K3 (split_attention.cuh), with
// KGQA's rounding. Step 5 rounds each p with the row's global m and l, so
// they must exist before any p is rounded: two launches over a grid of
// (chunk, kv head, batch row) blocks, chunks of C rows from
// ops/decode_attention.gqa_chunk (B, KH and S alone), blocks past the live
// rows exit at once. Each block copies its chunk's cache rows into shared
// memory with cp.async (16 bytes a copy where D % 16, else 4), all in
// flight at once. The products run on the tensor cores as bf16
// mma.sync.m16n8k16 with f32 sums, exactly: an int8 code is exact in
// bf16 (it becomes one through the f32 2^23 trick, whose high half it
// is), a bf16 q or probability is itself, and an f32 one is the sum of
// three bf16 planes (hi, mid, lo: 24 bits), one MMA a plane.
//   * gqa_scores_kernel: while the K rows arrive, the block builds the
//     query's MMA fragments (step 1) in shared memory; then a warp takes
//     16 cache rows at a time, A = the rows x 16 dims, B = 16 dims x the
//     heads (n = 8 >= rep); a warp a head then takes the chunk's max m_c
//     and sum l_c = sum exp(s - m_c); the scores and (m_c, l_c) go to the
//     workspace.
//   * gqa_context_kernel: while the V rows arrive, the row's m = max m_c
//     and l = sum_c exp(m_c - m) l_c over the live chunks (the same order
//     in every block, so the same bits) and the chunk's p = T(exp(s - m) /
//     l), as bf16 planes; then warp w takes dims 32 w.. of every head over
//     all the chunk's rows, A = the heads x 16 rows of p, B = 16 rows x 8
//     dims of V; the partial sums go to the workspace, and the last block
//     of (row, kv head) to finish (a counter left at 0) adds them in chunk
//     order, times v_scale, so repeated launches give the same bits.
// Both query dtypes take both launches: for an f32 q step 5 changes
// nothing, and one path serves both.
#include "decode_attention.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = aimet::kAttnMaxRep;  // the MMA's n = 8 heads
constexpr int kStat = 2 * kMaxRep;           // a chunk's m_c[8], l_c[8]
constexpr int kStatLoads = 2;                // a lane's (m_c, l_c) at once
// The workspace, in floats: the scores [B][KH][rep][Sp] (Sp = S rounded up
// to 4: whole float4s), the chunks' (m_c, l_c) [B][KH][nchunks][16], their
// partial contexts [B][KH][nchunks][rep][D].
struct Workspace {
  size_t stats, parts, total;
  __host__ __device__ Workspace(int B, int S, int KH, int rep, int D,
                                int nchunks) {
    const size_t bkh = (size_t)B * KH;
    stats = bkh * rep * ((S + 3) / 4 * 4);
    parts = stats + bkh * nchunks * kStat;
    total = parts + bkh * nchunks * rep * D;
  }
};

struct Chunk {
  int n, nlive, c0, rows;
  bool masked;
  __device__ Chunk(int pos, int S, int C) {
    masked = pos < 0;
    n = masked ? S : min(pos + 1, S);           // live rows
    nlive = (n + C - 1) / C;
    c0 = blockIdx.x * C;
    rows = min(C, n - c0);                      // this chunk's, if live
  }
};

// A staged cache row: D bytes rounded up to 16, then 16 bytes of pad, so
// the rows 8 threads read at once fall in distinct banks.
__host__ __device__ inline int row_bytes(int D) {
  return (D + 15) / 16 * 16 + 16;
}

// Copies `rows` rows of a head's cache (stride_s bytes apart, D bytes
// each) into shared rows row_bytes(D) apart, as one cp.async group. Bytes
// past D in a staged row are not written.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const int8_t* src, int rows,
                                           size_t stride_s, int D) {
  const int ld = row_bytes(D);
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (D % 16 == 0) {
    const int units = D / 16;
    for (int i = threadIdx.x; i < rows * units; i += kThreads) {
      const int r = i / units, u = i % units;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + r * ld + 16 * u),
                   "l"(src + r * stride_s + 16 * u)
                   : "memory");
    }
  } else {
    const int units = D / 4;
    for (int i = threadIdx.x; i < rows * units; i += kThreads) {
      const int r = i / units, u = i % units;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       base + r * ld + 4 * u),
                   "l"(src + r * stride_s + 4 * u)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bf16 bits (low half: the first) of two int8 codes: byte i0 of u0 and
// byte i1 of u1, each word XORed with 0x80808080 (code + 128): under the
// exponent of 2^23 a byte is the float 2^23 + 128 + code, less 2^23 + 128
// the code, exact, whose bf16 is the f32's high half
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t u0, int i0,
                                                 uint32_t u1, int i1) {
  const float f0 =
      __int_as_float(__byte_perm(u0, 0x4B000000u, 0x7650 | i0)) - 8388736.0f;
  const float f1 =
      __int_as_float(__byte_perm(u1, 0x4B000000u, 0x7650 | i1)) - 8388736.0f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The bf16 planes of v (kPlanes = 1: v is a bf16 value; 3: an f32 one,
// hi + mid + lo exactly)
template <int kPlanes>
__device__ __forceinline__ void planes_of(float v, uint16_t (&h)[kPlanes]) {
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    h[i] = __bfloat16_as_ushort(b);
    v = v - __bfloat162float(b);
  }
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <typename T>
constexpr int kPlanesOf = sizeof(T) == 2 ? 1 : 3;

// smem: the chunk's K rows [C][row_bytes(D)], its scores [rep][C], the
// query's B fragments [8 k steps][planes][32 lanes] (two words a lane)
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
gqa_scores_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const float* __restrict__ ks, int pos,
                  float* __restrict__ ws, int S, int KH, int rep, int D,
                  int C, float sqrt_d) {
  constexpr int kPl = kPlanesOf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(pos, S, C);
  if ((int)blockIdx.x >= ch.nlive) return;
  const int j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bj = (size_t)b * KH + j;
  const int ld = row_bytes(D), nks = (D + 15) / 16;   // k steps of 16 dims
  unsigned char* kst = smem;
  float* sc = reinterpret_cast<float*>(smem + C * ld);
  uint2* qf = reinterpret_cast<uint2*>(sc + rep * C);

  if (!ch.masked) {
    const size_t stride_s = (size_t)KH * D;    // bytes between cache rows
    stage_rows(kst,
               kc + ((size_t)b * S + ch.c0) * stride_s + (size_t)j * D,
               ch.rows, stride_s, D);
    // the B fragments of lane (g, t4): head n = g, k step s's slots
    // 2 t4 + {0, 1, 8, 9} are dims 16 s + 4 t4 + {0, 1, 2, 3} (A takes
    // the same order); each warp reads them from shared memory
    const float factor = aimet::to_f32(
        aimet::from_f32<T>(__fdiv_rn(ks[bj], sqrt_d)));
    for (int i = tid; i < 8 * 32; i += kThreads) {
      const int s = i / 32, gi = i % 32 / 4, ti = i % 4;
      const T* qb = q + (bj * rep + gi) * D;
      uint16_t h[4][kPl];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * s + 4 * ti + e;
        const float v = gi < rep && d < D
                            ? aimet::to_f32(aimet::from_f32<T>(__fmul_rn(
                                  aimet::to_f32(qb[d]), factor)))
                            : 0.0f;
        planes_of<kPl>(v, h[e]);
      }
#pragma unroll
      for (int p = 0; p < kPl; ++p)
        qf[(s * kPl + p) * 32 + i % 32] =
            make_uint2(pack2(h[0][p], h[1][p]), pack2(h[2][p], h[3][p]));
    }
    stage_wait();
    __syncthreads();
    // a warp 16 rows at a time: c = (row g, heads 2 t4, 2 t4 + 1), then
    // row g + 8; rows past `rows` (unstaged bytes, finite) are not kept
    for (int tile = warp; 16 * tile < ch.rows; tile += kWarps) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* r0 = kst + (16 * tile + g) * ld + 4 * t4;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s >= nks) break;
        const uint32_t w0 = aimet::ld_u32(r0 + 16 * s) ^ 0x80808080u;
        const uint32_t w1 = aimet::ld_u32(r0 + 8 * ld + 16 * s) ^ 0x80808080u;
        const uint32_t a[4] = {codes_bf16x2(w0, 0, w0, 1),
                               codes_bf16x2(w1, 0, w1, 1),
                               codes_bf16x2(w0, 2, w0, 3),
                               codes_bf16x2(w1, 2, w1, 3)};
#pragma unroll
        for (int p = 0; p < kPl; ++p) {
          const uint2 f = qf[(s * kPl + p) * 32 + lane];
          const uint32_t bq[2] = {f.x, f.y};
          aimet::mma_bf16(c, a, bq);
        }
      }
      const int t = 16 * tile + g, h = 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = t + 8 * (e >> 1), head = h + (e & 1);
        if (head < rep && row < ch.rows) sc[head * C + row] = c[e];
      }
    }
    __syncthreads();
  }

  // the chunk's (m_c, l_c), a warp a head, and its scores out
  float* stat = ws + Workspace(gridDim.z, S, KH, rep, D, gridDim.x).stats +
                (bj * gridDim.x + blockIdx.x) * kStat;
  for (int r = warp; r < rep; r += kWarps) {
    const float* s_r = sc + r * C;
    float m = -1e30f, l = 0.0f;
    if (ch.masked) {
      l = (float)ch.rows;                       // exp(0) a row
    } else {
      for (int i = lane; i < ch.rows; i += 32) m = fmaxf(m, s_r[i]);
      m = aimet::warp_max(m);
      for (int i = lane; i < ch.rows; i += 32) l += expf(s_r[i] - m);
      l = aimet::warp_sum(l);
    }
    if (lane == 0) {
      stat[r] = m;
      stat[kMaxRep + r] = l;
    }
  }
  if (!ch.masked) {                            // whole float4s (C % 32)
    const int row4 = (ch.rows + 3) / 4, Sp4 = (S + 3) / 4;
    float4* s4 = reinterpret_cast<float4*>(ws + bj * rep * Sp4 * 4 + ch.c0);
    for (int i = tid; i < rep * row4; i += kThreads)
      s4[(size_t)(i / row4) * Sp4 + i % row4] =
          reinterpret_cast<const float4*>(sc + (i / row4) * C)[i % row4];
  }
}

// the bf16 probability planes' row length: C + 8 values, so the 8 heads'
// rows start 4 banks apart
__host__ __device__ inline int prob_ld(int C) { return C + 8; }

// smem: the chunk's V rows [C][row_bytes(D)], its probabilities' bf16
// planes [planes][8][prob_ld(C)] (heads past rep and rows past the
// chunk's 0), the row's m [8] and l [8], the last-block flag
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
gqa_context_kernel(const int8_t* __restrict__ vc,
                   const float* __restrict__ vs, int pos, float* ws,
                   int* cnt, float* __restrict__ out, int S, int KH,
                   int rep, int D, int C) {
  constexpr int kPl = kPlanesOf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(pos, S, C);
  const int c = blockIdx.x;
  if (c >= ch.nlive) return;
  const int j = blockIdx.y, b = blockIdx.z, nchunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bj = (size_t)b * KH + j;
  const Workspace W(gridDim.z, S, KH, rep, D, nchunks);
  const float* stats = ws + W.stats + bj * nchunks * kStat;
  float* parts = ws + W.parts + bj * nchunks * rep * D;
  const int ld = row_bytes(D), pld = prob_ld(C);
  unsigned char* vst = smem;
  uint16_t* pp = reinterpret_cast<uint16_t*>(smem + C * ld);
  float* gm = reinterpret_cast<float*>(pp + kPl * kMaxRep * pld);
  float* gl = gm + kMaxRep;
  int* flag = reinterpret_cast<int*>(gl + kMaxRep);

  const size_t stride_s = (size_t)KH * D;
  stage_rows(vst, vc + ((size_t)b * S + ch.c0) * stride_s + (size_t)j * D,
             ch.rows, stride_s, D);

  // while the V rows arrive: the row's m and l over its live chunks, in
  // chunk order
  for (int r = warp; r < rep; r += kWarps) {
    float mc[kStatLoads], lc[kStatLoads];
    float m = -INFINITY;
    for (int i0 = 0; i0 < ch.nlive; i0 += 32 * kStatLoads) {
#pragma unroll
      for (int u = 0; u < kStatLoads; ++u) {
        const int i = i0 + 32 * u + lane;
        mc[u] = i < ch.nlive ? __ldcg(stats + i * kStat + r) : -INFINITY;
        lc[u] = i < ch.nlive ? __ldcg(stats + i * kStat + kMaxRep + r)
                             : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStatLoads; ++u) m = fmaxf(m, mc[u]);
    }
    m = aimet::warp_max(m);
    float l = 0.0f;
    if (ch.nlive <= 32 * kStatLoads) {        // (m_c, l_c) still held
#pragma unroll
      for (int u = 0; u < kStatLoads; ++u)
        if (32 * u + lane < ch.nlive) l = fmaf(expf(mc[u] - m), lc[u], l);
    } else {
      for (int i = lane; i < ch.nlive; i += 32)
        l = fmaf(expf(__ldcg(stats + i * kStat + r) - m),
                 __ldcg(stats + i * kStat + kMaxRep + r), l);
    }
    l = aimet::warp_sum(l);
    if (lane == 0) {
      gm[r] = m;
      gl[r] = l;
    }
  }
  __syncthreads();
  // the chunk's probabilities, rounded to T, as bf16 planes; its scores
  // loaded up to 4 float4 a thread at once (C % 32 == 0: a head's row of
  // scores is whole float4s from a 16-byte boundary); heads past rep and
  // rows past the chunk's (to the next 16) are 0
  constexpr int kBatch = 4;
  const int row4 = (ch.rows + 3) / 4, Sp4 = (S + 3) / 4;
  const int rows16 = (ch.rows + 15) / 16 * 16;
  const float4* s4 = reinterpret_cast<const float4*>(
      ws + bj * rep * Sp4 * 4 + ch.c0);
  for (int i0 = tid; i0 < kMaxRep * rows16 / 4; i0 += kBatch * kThreads) {
    float4 sv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / (rows16 / 4),
                t4_ = i % (rows16 / 4);
      sv[u] = ch.masked || r >= rep || t4_ >= row4
                  ? make_float4(-1e30f, -1e30f, -1e30f, -1e30f)
                  : __ldcg(s4 + (size_t)r * Sp4 + t4_);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / (rows16 / 4),
                t = 4 * (i % (rows16 / 4));
      if (i >= kMaxRep * rows16 / 4) break;
      const float e[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float pr =
            r < rep && t + k < ch.rows
                ? aimet::to_f32(aimet::from_f32<T>(
                      __fdiv_rn(expf(e[k] - gm[r]), gl[r])))
                : 0.0f;
        uint16_t h[kPl];
        planes_of<kPl>(pr, h);
#pragma unroll
        for (int p = 0; p < kPl; ++p)
          pp[(p * kMaxRep + r) * pld + t + k] = h[p];
      }
    }
  }
  stage_wait();
  __syncthreads();

  // warp w: dims 32 w + 4 g + i (n-tile i, column g) of every head over
  // the chunk's rows, 16 a step (slots = rows); c[i] = (head g, dims
  // 32 w + 8 t4 + i and + 4 + i)
  if (32 * warp < D) {
    float acc[4][4] = {};
    const unsigned char* vcol = vst + 32 * warp + 4 * g;
    for (int k0 = 0; k0 < ch.rows; k0 += 16) {
      uint32_t a[kPl][4];
#pragma unroll
      for (int p = 0; p < kPl; ++p) {
        const uint16_t* pr = pp + (p * kMaxRep + g) * pld + k0 + 2 * t4;
        a[p][0] = aimet::ld_u32(pr);
        a[p][1] = 0u;                        // heads 8..15: none
        a[p][2] = aimet::ld_u32(pr + 8);
        a[p][3] = 0u;
      }
      const uint32_t v0 =
          aimet::ld_u32(vcol + (k0 + 2 * t4) * ld) ^ 0x80808080u;
      const uint32_t v1 =
          aimet::ld_u32(vcol + (k0 + 2 * t4 + 1) * ld) ^ 0x80808080u;
      const uint32_t v2 =
          aimet::ld_u32(vcol + (k0 + 2 * t4 + 8) * ld) ^ 0x80808080u;
      const uint32_t v3 =
          aimet::ld_u32(vcol + (k0 + 2 * t4 + 9) * ld) ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t bv[2] = {codes_bf16x2(v0, i, v1, i),
                                codes_bf16x2(v2, i, v3, i)};
#pragma unroll
        for (int p = 0; p < kPl; ++p) aimet::mma_bf16(acc[i], a[p], bv);
      }
    }
    if (g < rep) {
      float* rec = parts + ((size_t)c * rep + g) * D + 32 * warp + 8 * t4;
      const int d0 = 32 * warp + 8 * t4;
      if (d0 + 4 <= D)
        *reinterpret_cast<float4*>(rec) =
            make_float4(acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
      if (d0 + 8 <= D)
        *reinterpret_cast<float4*>(rec + 4) =
            make_float4(acc[0][1], acc[1][1], acc[2][1], acc[3][1]);
    }
  }

  // the last block of (b, j) adds the chunks' sums in chunk order. The
  // block barrier, then one thread's fence, release the partial sums.
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const bool last = atomicAdd(&cnt[bj], 1) == ch.nlive - 1;
    if (last) {
      cnt[bj] = 0;                      // ready for the next launch
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  const float vscale = vs[bj];
  float* o = out + bj * rep * D;
  for (int i = tid; i < rep * D; i += kThreads) {
    float v = 0.0f;
    for (int k0 = 0; k0 < ch.nlive; k0 += 8) {   // 8 chunks' loads at once
      float part8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        part8[u] = k0 + u < ch.nlive
                       ? __ldcg(parts + (size_t)(k0 + u) * rep * D + i)
                       : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < ch.nlive) v += part8[u];
    }
    o[i] = v * vscale;
  }
}

int scores_smem(int rep, int D, int C, int planes) {
  return C * row_bytes(D) + 4 * rep * C + 8 * 8 * planes * 32;
}
int context_smem(int rep, int D, int C, int planes) {
  return C * row_bytes(D) + 2 * planes * kMaxRep * prob_ld(C) +
         4 * (2 * kMaxRep + 1);
}

template <typename K>
int allow_smem(K kern, int bytes, int* set) {
  if (bytes <= *set) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *set = bytes;
  return 0;
}

template <typename T>
int run(const void* q, const void* kc, const void* vc, const void* ks,
        const void* vs, int pos, void* out, void* ws, void* cnt, int B,
        int S, int KH, int rep, int D, int C, float sqrt_d,
        cudaStream_t st) {
  static int set_scores = 48 * 1024, set_context = 48 * 1024;
  const int s1 = scores_smem(rep, D, C, kPlanesOf<T>),
            s2 = context_smem(rep, D, C, kPlanesOf<T>);
  if (int e = allow_smem(gqa_scores_kernel<T>, s1, &set_scores)) return e;
  if (int e = allow_smem(gqa_context_kernel<T>, s2, &set_context)) return e;
  const dim3 grid((S + C - 1) / C, KH, B);
  float* w = static_cast<float*>(ws);
  gqa_scores_kernel<T><<<grid, kThreads, s1, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), pos, w, S, KH, rep, D, C, sqrt_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gqa_context_kernel<T><<<grid, kThreads, s2, st>>>(
      static_cast<const int8_t*>(vc), static_cast<const float*>(vs), pos, w,
      static_cast<int*>(cnt), static_cast<float*>(out), S, KH, rep, D, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: q (B, KH, rep, D) f32 or bf16; caches (B, S, KH, D) int8; ks, vs
// (B, KH) f32; out (B, KH, rep, D) f32; ws: ws_values f32, at least
// B KH (rep Sp + nchunks (16 + rep D)) with Sp = S rounded up to 4 and
// nchunks = ceil(S / chunk), 16-byte aligned; cnt: cnt_values >= B KH
// ints, 0 (and left 0). Requires rep <= 8, D % 4 == 0, D <= 128, chunk a
// multiple of 32 in [32, 256].
extern "C" int aimet_gqa_attention(const void* q, const void* kc,
                                   const void* vc, const void* ks,
                                   const void* vs, int pos, void* out,
                                   void* ws, void* cnt, int B, int S, int KH,
                                   int rep, int D, int chunk,
                                   long long ws_values, int cnt_values,
                                   float sqrt_d, int q_is_bf16,
                                   void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || rep <= 0 || rep > kMaxRep || D % 4 != 0 || D <= 0 ||
      D > 128 || S <= 0 || chunk < 32 || chunk > 256 || chunk % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (S + chunk - 1) / chunk;
  if (ws_values < (long long)Workspace(B, S, KH, rep, D, nchunks).total ||
      cnt_values < B * KH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_is_bf16)
    return run<__nv_bfloat16>(q, kc, vc, ks, vs, pos, out, ws, cnt, B, S,
                              KH, rep, D, chunk, sqrt_d, st);
  return run<float>(q, kc, vc, ks, vs, pos, out, ws, cnt, B, S, KH, rep, D,
                    chunk, sqrt_d, st);
}
