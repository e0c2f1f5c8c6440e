// The split-S (flash-decoding) one-token GQA decode attention of K3
// (decode_attention.cu): the cache rows of one (batch row b, kv head j) are
// cut into chunks of C rows, one block a chunk; each block writes its
// chunk's softmax statistics and unnormalised context to a small f32
// workspace, and the last block of (b, j) to finish merges the chunks in
// chunk order. See decode_attention.cu for what it computes and why.
//
// Inside a block (4 warps):
//   1. the chunk's live K and V rows are copied into shared memory by
//      16-byte cp.async (4-byte where D % 16), two groups, so V streams in
//      while the scores are formed; the block whose chunk holds the
//      position writes the new K/V row to the cache and to its own copy;
//   2. the rep query heads (roped, times k_scale / sqrt(D)) become two
//      int8 planes a head, q ~ sq (q1 + q2 / 256) with sq = max|q| / 127
//      (within max|q| / 65,024 of q), and the scores are exact int32 dots
//      on the tensor cores: mma.sync.m16n8k32.s8, A = 16 cache rows x 32
//      dims straight from the staged bytes (ldmatrix), B = the planes of
//      the (at most 8) heads; no per-row warp reduction;
//   3. a warp a head takes the chunk's max and its exponentials; the
//      probabilities p in [0, 1] become two int8 planes as well,
//      p ~ (p1 + p2 / 256) / 127 (within 1 / 65,024), and the chunk's sum l
//      is that of the planes' values;
//   4. the context is again int8 MMAs, A = the heads' probability planes
//      (k = 32 rows), B = V: a 32-bit load takes 4 dims of a row, a 4 x 4
//      byte transpose gives 4 rows of one dim (decode_gemm.cuh);
//   5. (m, l, context[rep][D]) go to the chunk's record; the block then
//      counts itself done for (b, j) and the last one (a counter left at
//      0) rescales every chunk by exp(m_c - m), multiplies by the
//      reciprocal of the total sum and by v_scale, in chunk order, so
//      repeated launches give the same bits.
#pragma once
#include "decode_attention.cuh"
#include "decode_gemm.cuh"
#include "gemm_tiles.cuh"

namespace aimet {
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;        // query heads a kv head: the MMA's n8
constexpr int kMinChunk = 32;     // a chunk is a multiple of the k32 step
constexpr int kMaxChunk = 256;
constexpr int kRecHead = 16;      // a record: m[8], l[8], context[rep][D]
constexpr float kInv127 = 1.0f / 127.0f;

__host__ __device__ inline int record_floats(int rep, int D) {
  return kRecHead + rep * D;
}

// Shared memory, byte offsets: K and V rows (C rows of Dp + 16 bytes, Dp =
// D rounded up to 32: the pad puts ldmatrix's 8 rows in distinct banks),
// reused by the merge for two [8][nchunks] f32 arrays; then one region
// holding first the staged qkv values of the block's heads (rep query
// heads, k, v, up to 4 bytes each) and its cos / sin rows, and once the
// query planes are cut, the scores [rep][C] f32 and the probability planes
// [2][8][C + 16]; the query planes [2][8][Dp + 16]; per-head scalars and a
// flag. (43.7 KB at C = 128, rep 4, D 128: five blocks an SM.)
struct Layout {
  int Dp, ldr, ldp;
  int kv, raw, rope, sc, ppl, qpl, misc, total;
  __host__ __device__ Layout(int C, int D, int rep, int nchunks) {
    Dp = (D + 31) / 32 * 32;
    ldr = Dp + 16;
    ldp = C + 16;
    const int kv_bytes = 2 * C * ldr;
    const int merge_bytes = 2 * kMaxRep * nchunks * 4;
    kv = 0;
    raw = ((kv_bytes > merge_bytes ? kv_bytes : merge_bytes) + 15) / 16 * 16;
    rope = raw + (rep + 2) * D * 4;
    sc = raw;
    ppl = sc + rep * C * 4;
    const int staged = (rep + 3) * D * 4, scored = rep * C * 4 + 16 * ldp;
    qpl = raw + ((staged > scored ? staged : scored) + 15) / 16 * 16;
    misc = qpl + 2 * kMaxRep * ldr;
    total = misc + 4 * (4 * kMaxRep + 4);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   dec::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies `words` 4-byte words from src to dst (both 4-byte aligned), no
// group commit.
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int words) {
  for (int i = threadIdx.x; i < words; i += kThreads)
    cp_async4(static_cast<uint32_t*>(dst) + i,
              static_cast<const uint32_t*>(src) + i);
}

// Copies rows [0, nrows) of a head's cache (rows stride_s bytes apart, D
// bytes each) into shared rows ldr bytes apart, as one cp.async group.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const int8_t* src, int nrows,
                                           size_t stride_s, int D, int ldr) {
  if (D % 16 == 0) {
    const int units = D / 16;
    for (int i = threadIdx.x; i < nrows * units; i += kThreads) {
      const int r = i / units, u = i % units;
      dec::cp_async16(dst + r * ldr + 16 * u, src + r * stride_s + 16 * u);
    }
  } else {
    const int units = D / 4;
    for (int i = threadIdx.x; i < nrows * units; i += kThreads) {
      const int r = i / units, u = i % units;
      cp_async4(dst + r * ldr + 4 * u, src + r * stride_s + 4 * u);
    }
  }
  cp_async_commit();
}

// orders this thread's earlier memory accesses (and, after a block
// barrier, the block's) before its later ones at GPU scope: the release
// before the counter's atomic, the acquire after it
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ int clamp127(float v) {
  return (int)fminf(fmaxf(v, -127.0f), 127.0f);
}

// Block (chunk c, kv head j, batch row b) of a (nchunks, KH, B) grid; the
// arguments are decode_attention.cu's. ws holds a record of
// record_floats(H / KH, D) floats for each (b, j, chunk); cnt one int for
// each (b, j), 0 on entry and on exit.
template <typename T>
__device__ __forceinline__ void split_attention(
    const T* __restrict__ qkv, const float* __restrict__ cosb,
    const float* __restrict__ sinb, int8_t* kc, int8_t* vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const float* __restrict__ iks, const float* __restrict__ ivs,
    const int* __restrict__ positions, T* __restrict__ out, float* ws,
    int* cnt, int S, int H, int KH, int D, int C, float sqrt_d,
    unsigned char* smem) {
  const int c = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.x;
  const int pos = positions[b];
  const bool masked = pos < 0;
  const int n = masked ? S : min(pos + 1, S);       // live rows
  const int nlive = (n + C - 1) / C;
  if (c >= nlive) return;                           // past the live rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rep = H / KH, D2 = D / 2;
  const int c0 = c * C, rows = min(C, n - c0);      // this chunk's
  const bool write = pos >= 0 && pos < S && pos / C == c;
  const Layout L(C, D, rep, nchunks);
  const int Dp = L.Dp, ldr = L.ldr, ldp = L.ldp;
  unsigned char* ksm = smem + L.kv;                 // [C][ldr]
  unsigned char* vsm = ksm + C * ldr;
  int8_t* qpl = reinterpret_cast<int8_t*>(smem + L.qpl);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int8_t* ppl = reinterpret_cast<int8_t*>(smem + L.ppl);
  float* sq = reinterpret_cast<float*>(smem + L.misc);
  float* mh = sq + kMaxRep;
  float* lh = mh + kMaxRep;
  float* inv = lh + kMaxRep;
  int* flag = reinterpret_cast<int*>(inv + kMaxRep);

  // 1: stage the block's query heads, its new k and v (where it appends)
  // and its rope rows, then the cache rows (the appended row comes from
  // this block), as three cp.async groups
  const size_t stride_s = (size_t)KH * D;           // bytes between rows
  const size_t bj = (size_t)b * KH + j;
  int8_t* kcb = kc + (size_t)b * S * stride_s + (size_t)j * D;
  int8_t* vcb = vc + (size_t)b * S * stride_s + (size_t)j * D;
  const T* row = qkv + (size_t)b * (H + 2 * KH) * D;
  T* raw = reinterpret_cast<T*>(smem + L.raw);      // [rep + 2][D], then
                                                    // the scores
  float* rope = reinterpret_cast<float*>(smem + L.rope);   // cos, sin
  constexpr int kPerWord = 4 / sizeof(T);
  stage_words(raw, row + (size_t)j * rep * D, rep * D / kPerWord);
  if (write) {
    stage_words(raw + rep * D, row + (size_t)(H + j) * D, D / kPerWord);
    stage_words(raw + (rep + 1) * D, row + (size_t)(H + KH + j) * D,
                D / kPerWord);
  }
  stage_words(rope, cosb + (size_t)b * D2, D2);
  stage_words(rope + D2, sinb + (size_t)b * D2, D2);
  cp_async_commit();
  const int nload = write ? pos - c0 : rows;
  stage_rows(ksm, kcb + (size_t)c0 * stride_s, nload, stride_s, D, ldr);
  stage_rows(vsm, vcb + (size_t)c0 * stride_s, nload, stride_s, D, ldr);
  const float qscale = __fdiv_rn(ks[bj], sqrt_d);
  const float ik = iks[bj], iv = ivs[bj];
  cp_async_wait<2>();                 // this thread's qkv and rope values
  __syncthreads();

  // 2: the query heads, a warp a head, in registers (a lane's dims
  // lane + 32 i): rope, times k_scale / sqrt(D), then the two int8 planes
  // (heads past rep and dims past D are 0); the block's new k / v row
  const float* cr = rope;
  const float* sr = rope + D2;
  for (int r = warp; r < kMaxRep; r += kWarps) {
    float qv[4];
    float a = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      qv[i] = r < rep && d < D
                  ? __fmul_rn(rope_at(raw + r * D, cr, sr, d, D2), qscale)
                  : 0.0f;
      a = fmaxf(a, fabsf(qv[i]));
    }
    a = warp_max(a);
    const float sqr = __fdiv_rn(a, 127.0f);
    const float iq = a > 0.0f ? __fdiv_rn(127.0f, a) : 0.0f;
    if (lane == 0) sq[r] = sqr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      if (d >= Dp) break;
      const float f1 = rintf(qv[i] * iq);
      const int q1 = clamp127(f1);
      const float e = fmaf(-(float)q1, sqr, qv[i]);
      qpl[r * ldr + d] = (int8_t)q1;
      qpl[(kMaxRep + r) * ldr + d] = (int8_t)clamp127(rintf(e * iq * 256.0f));
    }
  }
  if (write) {
    for (int d = tid; d < D; d += kThreads) {
      const int8_t kq =
          quant_i8(__fmul_rn(rope_at(raw + rep * D, cr, sr, d, D2), ik));
      const int8_t vq = quant_i8(__fmul_rn(to_f32(raw[(rep + 1) * D + d]),
                                           iv));
      kcb[(size_t)pos * stride_s + d] = kq;
      vcb[(size_t)pos * stride_s + d] = vq;
      ksm[(pos - c0) * ldr + d] = kq;
      vsm[(pos - c0) * ldr + d] = vq;
    }
  }
  cp_async_wait<1>();                 // this thread's K rows
  __syncthreads();                    // everyone's, and the query planes

  const int nks = Dp / 32;            // k32 steps over the dims (<= 4)
  uint32_t bq[2][4][2];
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int8_t* p = qpl + (pl * kMaxRep + g) * ldr + 32 * k + 4 * t;
      bq[pl][k][0] = k < nks ? ld_u32(p) : 0u;
      bq[pl][k][1] = k < nks ? ld_u32(p + 16) : 0u;
    }
  const int ntiles = (rows + 15) / 16;
  for (int tile = warp; tile < ntiles; tile += kWarps) {
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    // ldmatrix: lane l gives row (l >> 3 & 1) * 8 + (l & 7) of the tile,
    // 16-byte half l >> 4 of the k32 step
    const unsigned char* a_row =
        ksm + (tile * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldr +
        (lane >> 4) * 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= nks) break;
      uint32_t a[4];
      dec::ldmatrix_x4(a, a_row + 32 * k);
      mma_s8(acc[0], a, bq[0][k]);
      mma_s8(acc[1], a, bq[1][k]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t + (e & 1), s_ = tile * 16 + g + 8 * (e >> 1);
      if (r < rep)
        sc[r * C + s_] = __fmul_rn(
            sq[r], fmaf((float)acc[1][e], 0.00390625f, (float)acc[0][e]));
    }
  }
  __syncthreads();

  // 3: the chunk's max, exponentials and sum, a warp a head; rows past
  // `rows` get probability 0
  for (int r = warp; r < rep; r += kWarps) {
    const float* s_r = sc + r * C;
    float m = -INFINITY;
    for (int i = lane; i < rows; i += 32)
      m = fmaxf(m, masked ? -1e30f : s_r[i]);
    m = warp_max(m);
    float l = 0.0f;
    for (int i = lane; i < C; i += 32) {
      int p1 = 0, p2 = 0;
      if (i < rows) {
        const float f = __expf((masked ? -1e30f : s_r[i]) - m) * 127.0f;
        const float f1 = rintf(f);
        p1 = (int)f1;
        p2 = clamp127(rintf(__fmul_rn(__fsub_rn(f, f1), 256.0f)));
        l += fmaf((float)p2, 0.00390625f, f1) * kInv127;
      }
      ppl[r * ldp + i] = (int8_t)p1;
      ppl[(kMaxRep + r) * ldp + i] = (int8_t)p2;
    }
    l = warp_sum(l);
    if (lane == 0) {
      mh[r] = m;
      lh[r] = l;
    }
  }
  cp_async_wait<0>();                 // this thread's V rows
  __syncthreads();

  // 4: the context of the chunk, warp w on dims 32 w.. (n8 block cc of
  // it: column n is dim 32 w + 4 n + cc)
  const int R = record_floats(rep, D);
  float* base = ws + bj * (size_t)nchunks * R;
  float* rec = base + (size_t)c * R;
  if (warp < nks) {
    int acc[2][4][4] = {};
    const int nk = (rows + 31) / 32;
    for (int k = 0; k < nk; ++k) {
      uint32_t a[2][4];
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const int8_t* p = ppl + (pl * kMaxRep + g) * ldp + 32 * k + 4 * t;
        a[pl][0] = ld_u32(p);
        a[pl][1] = 0u;                // heads 8..15: none
        a[pl][2] = ld_u32(p + 16);
        a[pl][3] = 0u;
      }
      uint32_t u0[4], u1[4], b0[4], b1[4];
      const unsigned char* v =
          vsm + (32 * k + 4 * t) * ldr + 32 * warp + 4 * g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u0[i] = ld_u32(v + i * ldr);
        u1[i] = ld_u32(v + (16 + i) * ldr);
      }
      dec::transpose4(u0, b0);
      dec::transpose4(u1, b1);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const uint32_t bb[2] = {b0[cc], b1[cc]};
        mma_s8(acc[0][cc], a[0], bb);
        mma_s8(acc[1][cc], a[1], bb);
      }
    }
    const int d0 = 32 * warp + 8 * t;
    if (g < rep) {
      float v[8];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        v[cc] = fmaf((float)acc[1][cc][0], 0.00390625f,
                     (float)acc[0][cc][0]) * kInv127;
        v[4 + cc] = fmaf((float)acc[1][cc][1], 0.00390625f,
                         (float)acc[0][cc][1]) * kInv127;
      }
      float* o = rec + kRecHead + g * D + d0;
      if (d0 < D)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      if (d0 + 4 < D)
        *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  if (tid < rep) {
    rec[tid] = mh[tid];
    rec[kMaxRep + tid] = lh[tid];
  }

  // 5: the last block of (b, j) merges the chunks in chunk order. The
  // block barrier, then one thread's fence, release the record.
  __syncthreads();
  if (tid == 0) {
    fence_gpu();
    const bool last = atomicAdd(&cnt[bj], 1) == nlive - 1;
    if (last) {
      cnt[bj] = 0;                      // ready for the next launch
      fence_gpu();
    }
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  float* wm = reinterpret_cast<float*>(smem + L.kv);  // [8][nlive]: m_c
  float* wl = wm + kMaxRep * nlive;                   // [8][nlive]: l_c
  for (int i = tid; i < rep * nlive; i += kThreads) {
    const int ch = i / rep, r = i % rep;
    wm[r * nlive + ch] = __ldcg(base + (size_t)ch * R + r);
    wl[r * nlive + ch] = __ldcg(base + (size_t)ch * R + kMaxRep + r);
  }
  __syncthreads();
  for (int r = warp; r < rep; r += kWarps) {
    float m = -INFINITY;
    for (int ch = lane; ch < nlive; ch += 32)
      m = fmaxf(m, wm[r * nlive + ch]);
    m = warp_max(m);
    float l = 0.0f;
    for (int ch = lane; ch < nlive; ch += 32) {   // m_c becomes its weight
      const float w = expf(wm[r * nlive + ch] - m);
      wm[r * nlive + ch] = w;
      l = fmaf(w, wl[r * nlive + ch], l);
    }
    l = warp_sum(l);
    if (lane == 0) inv[r] = 1.0f / l;
  }
  __syncthreads();
  const float vscale = vs[bj];
  T* o = out + (size_t)b * H * D + (size_t)j * rep * D;
  for (int i = 4 * tid; i < rep * D; i += 4 * kThreads) {
    const int r = i / D;                 // D % 4 == 0: one head
    const float* w = wm + r * nlive;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch0 = 0; ch0 < nlive; ch0 += 8) {
      float4 part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        part[u] = ch0 + u < nlive
                      ? __ldcg(reinterpret_cast<const float4*>(
                            base + (size_t)(ch0 + u) * R + kRecHead + i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (ch0 + u >= nlive) break;
        const float wu = w[ch0 + u];
        acc.x = fmaf(wu, part[u].x, acc.x);
        acc.y = fmaf(wu, part[u].y, acc.y);
        acc.z = fmaf(wu, part[u].z, acc.z);
        acc.w = fmaf(wu, part[u].w, acc.w);
      }
    }
    const float s = inv[r];
    o[i + 0] = from_f32<T>(__fmul_rn(__fmul_rn(acc.x, s), vscale));
    o[i + 1] = from_f32<T>(__fmul_rn(__fmul_rn(acc.y, s), vscale));
    o[i + 2] = from_f32<T>(__fmul_rn(__fmul_rn(acc.z, s), vscale));
    o[i + 3] = from_f32<T>(__fmul_rn(__fmul_rn(acc.w, s), vscale));
  }
}

}  // namespace split
}  // namespace aimet
