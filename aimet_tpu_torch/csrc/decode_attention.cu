// K3: one-token GQA decode attention over the INT8 KV cache, with the new
// K/V row quantized and appended in place.
//
// Replaces aimet_tpu/ops/decode_attention_fused.py:fused_decode_attention /
// _attn_kernel -> attention_body. Its oracle is the XLA decode path
// aimet_tpu/serving/quantized_llm.py:_attention_from_qkv.
//
// For batch row b and kv head j it
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
// Query head h uses kv head h / rep. The new cache row uses explicitly
// rounded intrinsics (no contracted multiply-add), so it is bit-identical
// to the plain version's.
//
// A position outside [0, S) writes nothing. A position >= S attends over
// all S rows (the reference's mask s <= pos keeps them all); a negative
// position masks every row, which the reference's softmax turns into a
// uniform average over the S rows, and so does this kernel.
//
// Bound on the H100: bytes, (pos+1) x D of K and of V a (row, kv head).
// Design (split_attention.cuh): flash-decoding. The grid is (chunk of C
// cache rows, kv head, batch row), C chosen by the wrapper from B, KH and
// S alone (128 rows; 64 where 128 would leave SMs without a block), so it
// never reads the positions on the host: a block whose chunk starts past
// its row's live rows exits at once. Five 128-row blocks fit an SM. A
// block stages its chunk's rows by 16-byte cp.async,
// scores and forms the context with int8 tensor-core MMAs on two-plane
// int8 query heads and probabilities (~2^-16 of their max), writes (max,
// sum, context) to an f32 workspace, and the last block of (b, j) merges
// the chunks in chunk order. Only the block whose chunk holds the position
// appends the new row, and only it reads that row (from its own copy).
// The whole-layer kernels (KSOL / KDL, fused_layer.cu) and KGQA keep the
// one-block-a-(row, kv head) attend of decode_attention.cuh.
#include "split_attention.cuh"

namespace {

namespace sp = aimet::split;

template <typename T>
__global__ void __launch_bounds__(sp::kThreads)
split_attention_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ cosb,
                       const float* __restrict__ sinb, int8_t* kc,
                       int8_t* vc, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const float* __restrict__ iks,
                       const float* __restrict__ ivs,
                       const int* __restrict__ positions, T* __restrict__ out,
                       float* ws, int* cnt, int S, int H, int KH, int D,
                       int C, float sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  sp::split_attention<T>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs,
                         positions, out, ws, cnt, S, H, KH, D, C, sqrt_d,
                         smem);
}

template <typename T>
int run(const void* qkv, const void* cosb, const void* sinb, void* kc,
        void* vc, const void* ks, const void* vs, const void* iks,
        const void* ivs, const void* pos, void* out, void* ws, void* cnt,
        int B, int S, int H, int KH, int D, int C, float sqrt_d,
        cudaStream_t st) {
  const int nchunks = (S + C - 1) / C;
  const sp::Layout L(C, D, H / KH, nchunks);
  auto kern = split_attention_kernel<T>;
  static int smem_set = 48 * 1024;          // the limit set so far
  if (L.total > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = L.total;
  }
  kern<<<dim3(nchunks, KH, B), sp::kThreads, L.total, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<int8_t*>(kc),
      static_cast<int8_t*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const float*>(iks),
      static_cast<const float*>(ivs), static_cast<const int*>(pos),
      static_cast<T*>(out), static_cast<float*>(ws), static_cast<int*>(cnt),
      S, H, KH, D, C, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: qkv (B, (H + 2 KH) D); cos, sin (B, D/2) f32; caches (B, S, KH, D)
// int8; ks, vs, iks, ivs (B, KH) f32; positions (B,) int32; out (B, H D);
// ws: ws_values f32, at least a record of 16 + (H / KH) D floats for each
// (b, kv head, chunk of `chunk` rows); cnt: cnt_values >= B KH ints, 0 (and
// left 0). Requires H % KH == 0, H / KH <= 8, D % 4 == 0, D <= 128, chunk a
// multiple of 32 in [32, 256], and the block's shared memory within 227 KB.
extern "C" int aimet_decode_attention(const void* qkv, const void* cosb,
                                      const void* sinb, void* kc, void* vc,
                                      const void* ks, const void* vs,
                                      const void* iks, const void* ivs,
                                      const void* pos, void* out, void* ws,
                                      void* cnt, int B, int S, int H, int KH,
                                      int D, int chunk, long long ws_values,
                                      int cnt_values, float sqrt_d,
                                      int io_is_bf16, void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || H / KH > sp::kMaxRep || D % 4 != 0 ||
      D <= 0 || D > 128 || S <= 0 || chunk < sp::kMinChunk ||
      chunk > sp::kMaxChunk || chunk % sp::kMinChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (S + chunk - 1) / chunk;
  if (ws_values < (long long)B * KH * nchunks *
                      sp::record_floats(H / KH, D) ||
      cnt_values < B * KH ||
      sp::Layout(chunk, D, H / KH, nchunks).total > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_is_bf16)
    return run<__nv_bfloat16>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs, pos,
                              out, ws, cnt, B, S, H, KH, D, chunk, sqrt_d,
                              st);
  return run<float>(qkv, cosb, sinb, kc, vc, ks, vs, iks, ivs, pos, out, ws,
                    cnt, B, S, H, KH, D, chunk, sqrt_d, st);
}
