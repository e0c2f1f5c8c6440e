// K3: one-token GQA decode attention over the INT8 KV cache, with the new
// K/V row quantized and appended in place.
//
// Replaces aimet_tpu/ops/decode_attention_fused.py:fused_decode_attention /
// _attn_kernel -> attention_body. Its oracle is the XLA decode path
// aimet_tpu/serving/quantized_llm.py:_attention_from_qkv.
//
// One block per (batch row b, kv head j). The block
//   1. applies half-split rope in f32 to this kv head's `rep` query heads
//      and to k, with the cos/sin row the wrapper passes for row b;
//   2. quantizes the new k/v row with the wrapper's reciprocals 1/k_scale,
//      1/v_scale (kv_cache.py:_quant: multiply, round half to even, clamp);
//   3. writes that row at positions[b] in place;
//   4. scores the query heads against cache rows s <= pos scaled by
//      k_scale/sqrt(D) (rows past pos are masked to -1e30 in the reference
//      and contribute exactly 0 after the softmax, so they are skipped),
//      takes the softmax in f32;
//   5. forms the context from the INT8 V rows, times v_scale.
// Query head h uses kv head h / rep. The elementwise f32 steps use
// explicitly rounded intrinsics so no multiply-add is contracted: the new
// cache row is bit-identical to the plain version's.
//
// A position outside [0, S) writes nothing. A position >= S attends over
// all S rows (the reference's mask s <= pos keeps them all); a negative
// position masks every row, which the reference's softmax turns into a
// uniform average over the S rows, and so does this kernel.
//
// Bound on the H100: bytes. The block reads (pos+1) x D bytes of K and of
// V for its kv head; the score and context math is ~4 f32 operations per
// cache byte pair. Design: the rep query heads of one kv head share every
// K/V byte they read (GQA reuse in registers); for the scores and for the
// context the 16 warps take cache rows in turn, a lane 4 bytes of a row, so
// a warp reads a whole 128-byte row at once, and each warp issues the loads
// of 8 rows before it uses any (the loops are otherwise latency-bound). The
// cache is streamed once per block. Scores for S <= max_len sit in shared
// memory. One block per (b, j) is 256 blocks at batch 32; splitting S across
// blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kUnroll = 8;     // cache rows in flight per warp

template <typename T>
__device__ __forceinline__ float rope_at(const T* x, const float* c,
                                         const float* s, int d, int D2) {
  if (d < D2) {
    const float x1 = aimet::to_f32(x[d]), x2 = aimet::to_f32(x[d + D2]);
    return __fsub_rn(__fmul_rn(x1, c[d]), __fmul_rn(x2, s[d]));
  }
  const int e = d - D2;
  const float x1 = aimet::to_f32(x[e]), x2 = aimet::to_f32(x[d]);
  return __fadd_rn(__fmul_rn(x2, c[e]), __fmul_rn(x1, s[e]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ cosb,
                        const float* __restrict__ sinb, int8_t* kc,
                        int8_t* vc, const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const float* __restrict__ iks,
                        const float* __restrict__ ivs,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int S, int H, int KH, int D, float sqrt_d) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KH, j = blockIdx.x % KH;
  const int rep = H / KH, D2 = D / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q = smem;                            // [rep][D], scaled
  float* sc = q + rep * D;                    // [rep][S] scores -> probs
  float* part = sc + (size_t)rep * S;         // [warps][rep][D]

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
          aimet::quant_i8(__fmul_rn(rope_at(krow, c, s, d, D2), ik));
      vcb[(size_t)pos * stride_s + d] =
          aimet::quant_i8(__fmul_rn(aimet::to_f32(vrow[d]), iv));
    }
  }
  __syncthreads();   // q in shared; the appended row visible to the block

  const bool masked = pos < 0;
  const int n = masked ? S : min(pos + 1, S);

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
        v = aimet::warp_sum(v);
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
    m = aimet::warp_max(m);
    float sum = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(p[i] - m);
      p[i] = e;
      sum += e;
    }
    sum = aimet::warp_sum(sum);
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
    const int r = i / D, d = i % D;
    out[(size_t)b * H * D + (size_t)(j * rep + r) * D + d] =
        aimet::from_f32<T>(v * vscale);
  }
}

template <typename T>
int run(const void* qkv, const void* cosb, const void* sinb, void* kc,
        void* vc, const void* ks, const void* vs, const void* iks,
        const void* ivs, const void* pos, void* out, int B, int S, int H,
        int KH, int D, float sqrt_d, cudaStream_t st) {
  const int rep = H / KH;
  const size_t smem =
      sizeof(float) * ((size_t)rep * D + (size_t)rep * S +
                       (size_t)kWarps * rep * D);
  auto kern = decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B * KH, kThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<int8_t*>(kc),
      static_cast<int8_t*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const float*>(iks),
      static_cast<const float*>(ivs), static_cast<const int*>(pos),
      static_cast<T*>(out), S, H, KH, D, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: qkv (B, (H + 2 KH) D); cos, sin (B, D/2) f32; caches (B, S, KH, D)
// int8; ks, vs, iks, ivs (B, KH) f32; positions (B,) int32; out (B, H D).
// Requires H % KH == 0, H / KH <= 8, D % 4 == 0 and D <= 128.
extern "C" int aimet_decode_attention(const void* qkv, const void* cosb,
                                      const void* sinb, void* kc, void* vc,
                                      const void* ks, const void* vs,
                                      const void* iks, const void* ivs,
                                      const void* pos, void* out, int B, int S,
                                      int H, int KH, int D, float sqrt_d,
                                      int io_is_bf16, void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxRep || D % 4 != 0 || D <= 0 ||
      D > 128 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_is_bf16)
    return run<__nv_bfloat16>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs, pos,
                              out, B, S, H, KH, D, sqrt_d, st);
  return run<float>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs, pos, out, B, S,
                    H, KH, D, sqrt_d, st);
}
