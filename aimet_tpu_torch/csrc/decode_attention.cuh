// One-token GQA decode attention as a block-level device function, one
// block a (batch row, kv head): phase 0 of the whole-layer decode kernels
// KSOL / KDL (fused_layer.cu). K3 (decode_attention.cu, split_attention.cuh)
// and KGQA (gqa_attention.cu) split S across blocks instead and use only
// rope_at and the limits from here. What it computes is described in
// decode_attention.cu.
//
// Design: the rep query heads of one kv head share every K/V byte they read
// (GQA reuse in registers); for the scores and for the context the warps
// take cache rows in turn, a lane 4 bytes of a row, so a warp reads a
// whole 128-byte row at once, and each warp issues the loads of 8 rows
// before it uses any. The score rows sit in shared memory while they fit
// (S <= 12,352 at rep 4, D 128, with 16 warps); for a longer cache the
// caller passes a (B, KH, rep, S) f32 workspace and the rows live there,
// with the same arithmetic, so every cache length is taken. Splitting S
// across blocks as K3 and KGQA do is open for these callers.
#pragma once
#include "common.cuh"

namespace aimet {

constexpr int kAttnMaxRep = 8;
constexpr int kAttnUnroll = 8;     // cache rows in flight per warp

// the score rows, in floats, rounded up so what follows is float4-aligned
__host__ __device__ inline size_t attention_scores_floats(int rep, int S) {
  return ((size_t)rep * S + 3) / 4 * 4;
}

// shared memory of attention_body, in floats, for a block of `warps` warps;
// S = 0 when the score rows live in a global workspace instead (a cache
// too long for them to fit in shared memory)
__host__ __device__ inline size_t attention_smem_floats(int rep, int D, int S,
                                                       int warps) {
  return (size_t)rep * D + attention_scores_floats(rep, S) +
         (size_t)warps * rep * D;
}

template <typename T>
__device__ __forceinline__ float rope_at(const T* x, const float* c,
                                         const float* s, int d, int D2) {
  if (d < D2) {
    const float x1 = to_f32(x[d]), x2 = to_f32(x[d + D2]);
    return __fsub_rn(__fmul_rn(x1, c[d]), __fmul_rn(x2, s[d]));
  }
  const int e = d - D2;
  const float x1 = to_f32(x[e]), x2 = to_f32(x[d]);
  return __fadd_rn(__fmul_rn(x2, c[e]), __fmul_rn(x1, s[e]));
}

// Steps 4-5 for the rep query rows of one kv head: smem starts with them
// ([rep][D] f32, scaled, written before a block barrier), then holds the
// score rows and the warps' partial contexts (attention_smem_floats). With
// `scores` non-null the score rows ([rep][S] f32) live there instead, in
// global memory, and smem holds only the query rows and the partial
// contexts: the arithmetic and its rounding points are the same, so only
// the cache length the block takes changes;
// kcb / vcb are the head's cache rows, stride_s bytes apart. Rows s < n
// are live, all n masked to -1e30 when `masked`. Writes
// out[r * D + d] = from_f32<OutT>(context * vscale); the caller puts a
// block barrier before reusing smem.
template <int kThreads, typename OutT>
__device__ __forceinline__ void attend(float* smem, float* scores,
                                       const int8_t* kcb, const int8_t* vcb,
                                       size_t stride_s, int S, int n,
                                       bool masked, int rep, int D,
                                       float vscale, OutT* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kMaxRep = kAttnMaxRep;
  constexpr int kUnroll = kAttnUnroll;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* q = smem;                               // [rep][D]
  float* sc = scores ? scores : smem + rep * D;        // [rep][S]
  float* part = smem + rep * D +                       // [warps][rep][D]
                (scores ? 0 : attention_scores_floats(rep, S));

  // 4: scores. A warp takes cache rows in turn, each lane 4 dims (one
  // 4-byte load, so a warp reads a 128-byte row in one transaction);
  // kUnroll rows are loaded before any is used, so loads overlap.
  const int nchunk = D / 4;
  const bool lane_on = lane < nchunk;
  float4 qv[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
    qv[r] = (r < rep && lane_on)
                ? *reinterpret_cast<const float4*>(q + r * D + lane * 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  const char4 zero4 = make_char4(0, 0, 0, 0);
  for (int s0 = warp; s0 < n; s0 += kWarps * kUnroll) {
    char4 kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sidx = s0 + u * kWarps;
      kv[u] = (lane_on && sidx < n)
                  ? *reinterpret_cast<const char4*>(
                        kcb + (size_t)sidx * stride_s + lane * 4)
                  : zero4;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sidx = s0 + u * kWarps;      // warp-uniform
      if (sidx >= n) break;
      const float k0 = kv[u].x, k1 = kv[u].y, k2 = kv[u].z, k3 = kv[u].w;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        float v = qv[r].x * k0;
        v = fmaf(qv[r].y, k1, v);
        v = fmaf(qv[r].z, k2, v);
        v = fmaf(qv[r].w, k3, v);
        v = warp_sum(v);
        if (lane == 0) sc[(size_t)r * S + sidx] = masked ? -1e30f : v;
      }
    }
  }
  __syncthreads();

  // softmax over the n live rows, one warp per query head
  for (int r = warp; r < rep; r += kWarps) {
    float* p = sc + (size_t)r * S;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, p[i]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(p[i] - m);
      p[i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.0f / sum;
    for (int i = lane; i < n; i += 32) p[i] *= inv;
  }
  __syncthreads();

  // 5: context, rows split across warps as for the scores, each lane 4
  // dims of every query head; the warps' partial sums meet in shared memory
  float4 acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = warp; s0 < n; s0 += kWarps * kUnroll) {
    char4 vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sidx = s0 + u * kWarps;
      vv[u] = (lane_on && sidx < n)
                  ? *reinterpret_cast<const char4*>(
                        vcb + (size_t)sidx * stride_s + lane * 4)
                  : zero4;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sidx = s0 + u * kWarps;
      if (sidx >= n) break;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        const float p = sc[(size_t)r * S + sidx];
        acc[r].x = fmaf(p, (float)vv[u].x, acc[r].x);
        acc[r].y = fmaf(p, (float)vv[u].y, acc[r].y);
        acc[r].z = fmaf(p, (float)vv[u].z, acc[r].z);
        acc[r].w = fmaf(p, (float)vv[u].w, acc[r].w);
      }
    }
  }
  if (lane_on) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep)
        *reinterpret_cast<float4*>(part + ((size_t)warp * rep + r) * D +
                                   lane * 4) = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += part[(size_t)w * rep * D + i];
    out[i] = from_f32<OutT>(v * vscale);
  }
}

// Attention of batch row b, kv head j, by a block of kThreads threads;
// `smem` holds attention_smem_floats(H / KH, D, S, kThreads / 32) floats,
// or, with a (B, KH, H / KH, S) f32 score workspace `scores`, those of
// S = 0.
// Ends with a block barrier, so the block may reuse `smem` at once.
template <typename T, int kThreads>
__device__ __forceinline__ void attention_body(
    const T* __restrict__ qkv, const float* __restrict__ cosb,
    const float* __restrict__ sinb, int8_t* kc, int8_t* vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const float* __restrict__ iks, const float* __restrict__ ivs,
    const int* __restrict__ positions, T* __restrict__ out, int b, int j,
    int S, int H, int KH, int D, float sqrt_d, float* smem, float* scores) {
  const int rep = H / KH, D2 = D / 2;
  const int tid = threadIdx.x;
  float* q = smem;                            // [rep][D], scaled

  const T* row = qkv + (size_t)b * (H + 2 * KH) * D;
  const float* c = cosb + (size_t)b * D2;
  const float* s = sinb + (size_t)b * D2;
  const int pos = positions[b];
  const size_t bj = (size_t)b * KH + j;
  const float kscale = ks[bj], vscale = vs[bj];
  const float qscale = __fdiv_rn(kscale, sqrt_d);

  // 1-3: rope q (scaled as the reference folds k_scale/sqrt(D) into q),
  // quantize and append the new k/v row
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q[i] = __fmul_rn(rope_at(row + (size_t)(j * rep + r) * D, c, s, d, D2),
                     qscale);
  }
  const bool write = pos >= 0 && pos < S;
  const size_t stride_s = (size_t)KH * D;     // bytes between cache rows
  int8_t* kcb = kc + (size_t)b * S * stride_s + (size_t)j * D;
  int8_t* vcb = vc + (size_t)b * S * stride_s + (size_t)j * D;
  if (write) {
    const float ik = iks[bj], iv = ivs[bj];
    const T* krow = row + (size_t)(H + j) * D;
    const T* vrow = row + (size_t)(H + KH + j) * D;
    for (int d = tid; d < D; d += kThreads) {
      kcb[(size_t)pos * stride_s + d] =
          quant_i8(__fmul_rn(rope_at(krow, c, s, d, D2), ik));
      vcb[(size_t)pos * stride_s + d] =
          quant_i8(__fmul_rn(to_f32(vrow[d]), iv));
    }
  }
  __syncthreads();   // q in shared; the appended row visible to the block

  const bool masked = pos < 0;
  const int n = masked ? S : min(pos + 1, S);
  attend<kThreads>(
      smem, scores ? scores + bj * rep * S : nullptr, kcb, vcb, stride_s, S,
      n, masked, rep, D, vscale,
      out + (size_t)b * H * D + (size_t)j * rep * D);
  __syncthreads();
}

}  // namespace aimet
