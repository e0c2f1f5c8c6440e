// KGQA: one-token GQA decode attention over the INT8 KV caches, with no
// append.
//
// Replaces aimet_tpu/ops/decode_attention.py:fused_gqa_decode_attention /
// _kernel, with the two elementwise folds the TPU version does around its
// pallas_call brought inside. Its oracle is fused_gqa_decode_attention_xla
// (decode_attention.py:101-114), the serving decode-attention math.
//
// One block per (batch row b, kv head j), in the reference's rounding
// order:
//   1. qs = q * T(k_scale / sqrt(D)) in q's dtype T: a bf16 q gets a bf16
//      factor and a bf16 product; kept in shared memory as f32;
//   2. scores qs . k in f32 (a bf16 value times an int8 code is exact in
//      f32; an f32 q uses f32 FMAs, never TF32);
//   3. the mask s <= pos, -1e30 elsewhere (masked rows contribute exactly 0
//      after the softmax and are skipped);
//   4. the softmax in f32 over the whole score row, which sits in shared
//      memory, or, for a cache too long for that, in a global workspace
//      the wrapper passes (an online-rescaled softmax would round at other
//      points);
//   5. each prob divided by the row's sum and rounded to T;
//   6. the context from the int8 V rows in f32, times v_scale; f32 out.
// Steps 2-6 are attend's (decode_attention.cuh, KSOL's phase 0), with
// the probs rounded as step 5 says. A negative position masks every row: the
// softmax of S equal scores averages the S rows uniformly, as the
// reference's does. A position >= S attends over all S rows.
//
// Bound on the H100: bytes. The block reads (pos+1) x D bytes of K and of
// V for its kv head and does ~4 f32 operations per cache byte pair. Design
// as K3: the rep query heads share every K/V byte in registers, a warp
// reads a 128-byte cache row at once, each warp keeps 8 rows in flight.
// One block per (b, j) is 128 blocks at Llama-3-8B's batch 16 (KH = 8);
// splitting S across blocks is later work.
#include "decode_attention.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_attention_kernel(const T* __restrict__ q, const int8_t* kc,
                     const int8_t* vc, const float* __restrict__ ks,
                     const float* __restrict__ vs, int pos,
                     float* __restrict__ out, float* scores, int S, int KH,
                     int rep, int D, float sqrt_d) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KH, j = blockIdx.x % KH;
  const size_t bj = (size_t)b * KH + j;
  const float factor = aimet::to_f32(
      aimet::from_f32<T>(__fdiv_rn(ks[bj], sqrt_d)));
  const T* qb = q + bj * rep * D;
  for (int i = threadIdx.x; i < rep * D; i += kThreads)
    smem[i] = aimet::to_f32(
        aimet::from_f32<T>(__fmul_rn(aimet::to_f32(qb[i]), factor)));
  __syncthreads();
  const size_t stride_s = (size_t)KH * D;     // bytes between cache rows
  const size_t head = (size_t)b * S * stride_s + (size_t)j * D;
  const bool masked = pos < 0;
  aimet::attend<kThreads, aimet::ProbsRounded<T>>(
      smem, scores ? scores + bj * rep * S : nullptr, kc + head, vc + head,
      stride_s, S, masked ? S : min(pos + 1, S),
      masked, rep, D, vs[bj], out + bj * rep * D);
}

template <typename T>
int run(const void* q, const void* kc, const void* vc, const void* ks,
        const void* vs, int pos, void* out, void* ws, int B, int S, int KH,
        int rep, int D, float sqrt_d, cudaStream_t st) {
  const size_t smem = sizeof(float) * aimet::attention_smem_floats(
                                          rep, D, ws ? 0 : S, kWarps);
  auto kern = gqa_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B * KH, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const int8_t*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), pos, static_cast<float*>(out),
      static_cast<float*>(ws), S, KH, rep, D, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: q (B, KH, rep, D) f32 or bf16; caches (B, S, KH, D) int8; ks, vs
// (B, KH) f32; out (B, KH, rep, D) f32; ws null, or a (B, KH, rep, S) f32
// workspace for the score rows. Requires rep <= 8, D % 4 == 0 and
// D <= 128.
extern "C" int aimet_gqa_attention(const void* q, const void* kc,
                                   const void* vc, const void* ks,
                                   const void* vs, int pos, void* out,
                                   void* ws, int B, int S, int KH, int rep,
                                   int D, float sqrt_d, int q_is_bf16,
                                   void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || rep <= 0 || rep > aimet::kAttnMaxRep || D % 4 != 0 ||
      D <= 0 || D > 128 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_is_bf16)
    return run<__nv_bfloat16>(q, kc, vc, ks, vs, pos, out, ws, B, S, KH, rep,
                              D, sqrt_d, st);
  return run<float>(q, kc, vc, ks, vs, pos, out, ws, B, S, KH, rep, D,
                    sqrt_d, st);
}
