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
// plain version (ops/int_matmul.quantize_activation_per_row); the row's
// arithmetic is the shared row quantizer's (row_quant.cuh).
//
// Bound on the H100: bytes. It reads x once and writes one byte per
// element; the arithmetic is a handful of operations per element. Two
// kernels, chosen by the wrapper from the row's bytes
// (ops/int_matmul.act_quant_plan):
//
// * narrow rows (K <= 1024: ResNet-50's conv patches, K = 64..1152 f32;
//   any alignment) -- act_quant_rows_kernel: a block of 256 threads takes
//   R consecutive rows, L lanes a row (a power of two, 1..32, about 8
//   values a lane), 256 / L rows at a time. A lane holds its values of the
//   row in registers (loaded together, a warp's loads of a row contiguous
//   whatever its alignment), the row's lanes take its max with warp
//   shuffles over their group, and the codes come by a multiply with the
//   scale's reciprocal (division where the product lies near a
//   half-integer: row_quant.cuh's code_by_inv, code's bits). They go to
//   shared memory and out as one R x K span, 16 bytes a store: HBM sees
//   one read of x and one write of the codes; a block has one barrier for
//   its R rows.
// * wide rows (the prefill's K = 4096 / 14336 bf16) -- act_quant_kernel:
//   one block a row, the row max a block reduction, 16-byte loads where
//   the row is aligned, by the read-only path.
//
// At decode M a w4a8 matmul quantizes its rows inside K2's fused decode
// kernel instead (w4a8_gemm.cu); K1 serves the rest.
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

__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Rows [row0, row0 + R) of M, L lanes (a power of two up to 32) a row, each
// lane's values k = lane + L j (j < V) held in registers: a lane's loads
// are issued together, two rows of its group at a time where V = 8, and
// a warp's loads of a row are contiguous whatever the row's alignment. The
// codes go into shared memory at their global address's offset within 16 bytes,
// then out 16 bytes a store.
template <typename T, int L, int V>
__global__ void __launch_bounds__(kThreads)
act_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ sx, int M, int K, int R) {
  namespace rowq = aimet::rowq;
  constexpr int G = kThreads / L;             // groups of L lanes
  constexpr int U = V <= 8 ? 2 : 1;           // a group's rows in flight
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, (long long)M - row0);
  const int n = rows * K;                     // the block's codes
  int8_t* dst = q + row0 * K;
  int8_t* qs = reinterpret_cast<int8_t*>(smem + misalign(dst));

  // group g of the block takes rows g, g + G, ...
  const int lane = tid % L, grp = tid / L;
  const unsigned mask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1) << ((tid & 31) & ~(L - 1));
  for (int r0 = grp; r0 < rows; r0 += U * G) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* xr = x + (row0 + r0 + u * G) * K + lane;
      const bool live = r0 + u * G < rows;
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[u][j] = live && lane + L * j < K ? rowq::ld1<false>(xr + L * j)
                                           : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * G;
      if (r >= rows) break;                   // the same in the group
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[u][j]));
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(mask, amax, o));
      const float scale = rowq::scale_of(amax), inv = 1.0f / scale;
      if (lane == 0) sx[row0 + r] = scale;
      int8_t* qr = qs + r * K + lane;
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (lane + L * j < K)
          qr[L * j] = rowq::code_by_inv(v[u][j], scale, inv);
    }
  }
  __syncthreads();

  // the codes out, 16 bytes a store
  const int head = min(n, (16 - misalign(dst)) % 16);
  const int body = (n - head) / 16;
  for (int i = tid; i < head; i += kThreads) dst[i] = qs[i];
  for (int u = tid; u < body; u += kThreads)
    *reinterpret_cast<uint4*>(dst + head + 16 * u) =
        *reinterpret_cast<const uint4*>(qs + head + 16 * u);
  for (int i = head + 16 * body + tid; i < n; i += kThreads)
    dst[i] = qs[i];
}

template <typename T, int L, int V>
int launch_rows(const T* x, int8_t* q, float* sx, int M, int K, int rows,
                cudaStream_t s) {
  const int smem = 16 + rows * K;
  auto kern = act_quant_rows_kernel<T, L, V>;
  static int smem_set = 48 * 1024;          // the limit set so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const long long blocks = ((long long)M + rows - 1) / rows;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(x, q, sx, M, K, rows);
  return static_cast<int>(cudaGetLastError());
}

// the narrow-row kernel for `lanes` lanes a row: 8 values a lane where that
// holds the row (lanes 1..32), else 32 lanes of 16 or 32 values
template <typename T>
int launch_narrow(const T* x, int8_t* q, float* sx, int M, int K, int lanes,
                  int rows, cudaStream_t s) {
  if (K <= 8 * lanes) {
    switch (lanes) {
      case 1: return launch_rows<T, 1, 8>(x, q, sx, M, K, rows, s);
      case 2: return launch_rows<T, 2, 8>(x, q, sx, M, K, rows, s);
      case 4: return launch_rows<T, 4, 8>(x, q, sx, M, K, rows, s);
      case 8: return launch_rows<T, 8, 8>(x, q, sx, M, K, rows, s);
      case 16: return launch_rows<T, 16, 8>(x, q, sx, M, K, rows, s);
      default: return launch_rows<T, 32, 8>(x, q, sx, M, K, rows, s);
    }
  }
  if (K <= 16 * 32) return launch_rows<T, 32, 16>(x, q, sx, M, K, rows, s);
  return launch_rows<T, 32, 32>(x, q, sx, M, K, rows, s);
}

template <typename T>
int run(const void* x, void* q, void* sx, int M, int K, int lanes, int rows,
        cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(sx);
  if (lanes == 0) {
    act_quant_kernel<T><<<M, kThreads, 0, s>>>(xp, qp, sp, K);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_narrow<T>(xp, qp, sp, M, K, lanes, rows, s);
}

}  // namespace

// x (M, K) bf16 or f32, contiguous (any alignment of its element type);
// q (M, K) int8; sx (M,) f32. lanes 0: a block a row (wide rows); else
// the narrow-row kernel with `lanes` lanes a row (a power of two up to
// 32; K <= 8 lanes, or 32 lanes and K <= 1024) and `rows` rows a block
// (a multiple of 256 / lanes, their codes within 227 KB of shared
// memory).
extern "C" int aimet_act_quant(const void* x, void* q, void* sx, int M, int K,
                               int lanes, int rows, int x_is_bf16,
                               void* stream) {
  if (M <= 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes != 0 &&
      (lanes < 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
       (K > 8 * lanes && (lanes != 32 || K > 32 * 32)) || rows <= 0 ||
       rows % (kThreads / lanes) != 0 ||
       (long long)rows * K + 16 > 227 * 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return run<__nv_bfloat16>(x, q, sx, M, K, lanes, rows, s);
  return run<float>(x, q, sx, M, K, lanes, rows, s);
}
