// K1: dynamic per-row symmetric INT8 activation quantizer.
//
// Replaces the activation-quantization phase of the TPU W4A8 kernels:
// aimet_tpu/ops/int_matmul.py:_w4a8_fusedq_kernel (the j == 0 branch, which
// quantizes in f32) and the quantize_activation_per_row call in front of
// the K-split matmul_w4a8.
//
// Computes, for each row m of x (M, K) bf16/f32:
//   amax = max_k |x[m,k]|;  sx[m] = max(amax, 1e-8) / 127   (f32)
//   q[m,k] = clamp(rint(x[m,k] / sx[m]), -127, 127)        (int8)
// in f32 with IEEE division and round-half-to-even, bit-identical to the
// plain version (ops/int_matmul.quantize_activation_per_row).
//
// Bound on the H100: bytes. It reads x once for the max and once more for
// the codes (the second read hits a cache for the main path's row sizes,
// K <= 14336: 28 KB of bf16), and writes one byte per element; the
// arithmetic is a handful of operations per element.
// Design: one block per row, so the row max is a block reduction and needs
// no second pass over device memory; the row's arithmetic and its loads
// are the shared row quantizer's (row_quant.cuh), 16 bytes a load where
// the row is aligned, by the read-only path. At decode M a w4a8 matmul
// quantizes its rows inside K2's fused decode kernel instead
// (w4a8_gemm.cu); K1 serves the rest.
#include "row_quant.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ sx, int K) {
  namespace rowq = aimet::rowq;
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  __shared__ float red[kThreads / 32];
  __shared__ float s_scale;

  float amax = aimet::warp_max(
      rowq::absmax_share<false>(xr, K, threadIdx.x, kThreads));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.0f;
    v = aimet::warp_max(v);
    if (threadIdx.x == 0) {
      const float scale = rowq::scale_of(v);
      s_scale = scale;
      sx[row] = scale;
    }
  }
  __syncthreads();
  rowq::quantize_share<false>(xr, K, s_scale, q + row * K, threadIdx.x,
                              kThreads);
}

}  // namespace

extern "C" int aimet_act_quant(const void* x, void* q, void* sx, int M, int K,
                               int x_is_bf16, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    act_quant_kernel<__nv_bfloat16><<<M, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(sx), K);
  else
    act_quant_kernel<float><<<M, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(sx), K);
  return static_cast<int>(cudaGetLastError());
}
