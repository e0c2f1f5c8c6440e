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
// cache is streamed once per block. The score rows sit in shared memory
// while they fit (S <= 12,352 at rep 4, D 128, in sm_90's 227 KB a
// block); for a longer cache the wrapper passes a (B, KH, rep, S) f32
// workspace and the rows live there (in L2 for the most part), with the
// same arithmetic, so every cache length is taken. One block per (b, j) is
// 256 blocks at batch 32; splitting S across blocks (flash-decoding) is
// later work.
#include "decode_attention.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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
                        float* scores, int S, int H, int KH, int D,
                        float sqrt_d) {
  extern __shared__ float smem[];
  aimet::attention_body<T, kThreads>(qkv, cosb, sinb, kc, vc, ks, vs, iks,
                                     ivs, positions, out, blockIdx.x / KH,
                                     blockIdx.x % KH, S, H, KH, D, sqrt_d,
                                     smem, scores);
}

template <typename T>
int run(const void* qkv, const void* cosb, const void* sinb, void* kc,
        void* vc, const void* ks, const void* vs, const void* iks,
        const void* ivs, const void* pos, void* out, void* ws, int B, int S,
        int H, int KH, int D, float sqrt_d, cudaStream_t st) {
  const int rep = H / KH;
  const size_t smem = sizeof(float) * aimet::attention_smem_floats(
                                          rep, D, ws ? 0 : S, kWarps);
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
      static_cast<T*>(out), static_cast<float*>(ws), S, H, KH, D, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: qkv (B, (H + 2 KH) D); cos, sin (B, D/2) f32; caches (B, S, KH, D)
// int8; ks, vs, iks, ivs (B, KH) f32; positions (B,) int32; out (B, H D);
// ws null, or a (B, KH, H / KH, S) f32 workspace for the score rows (for
// a cache whose rows do not fit in shared memory). Requires H % KH == 0,
// H / KH <= 8, D % 4 == 0 and D <= 128.
extern "C" int aimet_decode_attention(const void* qkv, const void* cosb,
                                      const void* sinb, void* kc, void* vc,
                                      const void* ks, const void* vs,
                                      const void* iks, const void* ivs,
                                      const void* pos, void* out, void* ws,
                                      int B, int S, int H, int KH, int D,
                                      float sqrt_d, int io_is_bf16,
                                      void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || H / KH > aimet::kAttnMaxRep || D % 4 != 0 ||
      D <= 0 || D > 128 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_is_bf16)
    return run<__nv_bfloat16>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs, pos,
                              out, ws, B, S, H, KH, D, sqrt_d, st);
  return run<float>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs, pos, out, ws,
                    B, S, H, KH, D, sqrt_d, st);
}
