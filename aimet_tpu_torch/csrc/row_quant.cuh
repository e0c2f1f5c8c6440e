// The per-row dynamic INT8 quantizer of activations, one definition for
// every kernel that quantizes rows: K1 (act_quant.cu), the int8 phases of
// KSOL (fused_layer.cu) and K2's fused decode kernel (w4a8_gemm.cu,
// w4a8_fusedq_decode_kernel). It is the f32 arithmetic of
// aimet_tpu/ops/int_matmul.py:_w4a8_fusedq_kernel's j == 0 branch:
//   sx = max(amax, 1e-8) / 127          (IEEE division)
//   q  = clamp(rint(x / sx), -127, 127) (IEEE division, half to even)
// for a bf16 or f32 row; bit-identical to the plain version
// (ops/int_matmul._quantize_activation_plain).
//
// A block's threads each take a share of a row (thread tid of nthr): its
// share of the absmax (the caller reduces the shares: a max is exact in any
// order), then its share of the codes. Rows of K % 8 == 0 at a 16-byte
// aligned address go 8 values a load and 8 codes a store; other rows one
// value at a time (the same bits). HeldRow keeps a row's values in
// registers between the two passes, so the row is read once. K1's narrow
// rows (act_quant.cu) use only scale_of and code_by_inv (code's bits):
// several rows share a block there.
//
// kCG: the loads go through L2 (ld.global.cg), for a row that another
// block may have written in the same launch (KSOL); else through the
// read-only path (ld.global.nc), for a row that is an input of the launch
// (K1, the fused decode kernel), which the SM's own cache may keep for a
// second pass.
#pragma once
#include "common.cuh"

namespace aimet {
namespace rowq {

template <bool kCG, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kCG)
    return __ldcg(p);
  else
    return __ldg(p);
}
template <bool kCG>
__device__ __forceinline__ float ld1(const float* p) {
  return ld<kCG>(p);
}
template <bool kCG>
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      ld<kCG>(reinterpret_cast<const unsigned short*>(p))));
}
// 8 values at p (16-byte aligned) as f32
template <bool kCG>
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = ld<kCG>(reinterpret_cast<const float4*>(p));
  const float4 b = ld<kCG>(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <bool kCG>
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = ld<kCG>(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// whether the K values at xr are read 8 at a time
template <typename T>
__device__ __forceinline__ bool read8(const T* xr, int K) {
  return K % 8 == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
}
// whether a row of K values at xr (codes at qr) goes 8 values at a time
template <typename T>
__device__ __forceinline__ bool by8(const T* xr, const int8_t* qr, int K) {
  return read8(xr, K) && (reinterpret_cast<uintptr_t>(qr) & 7) == 0;
}

// the row's scale from its absmax, and a value's code
__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}
__device__ __forceinline__ int8_t code(float v, float scale) {
  return quant_i8(__fdiv_rn(v, scale));
}
// code(v, scale) from inv = 1 / scale (IEEE): |v| <= scale * 127 (1 +
// 2^-23), so y = v * inv lies within 3e-5 of the IEEE quotient v / scale,
// and both round to the same integer unless that quotient is within
// 3e-5 of a half-integer: where y is within 1e-4 of one (or is not
// finite), the quotient is taken by IEEE division. The same bits as code()
// for a multiply where code() divides.
__device__ __forceinline__ int8_t code_by_inv(float v, float scale,
                                              float inv) {
  const float y = v * inv;
  return fabsf(y - floorf(y) - 0.5f) > 1e-4f ? quant_i8(y) : code(v, scale);
}

// This thread's share of max_k |x[k]| over the K values at xr.
template <bool kCG, typename T>
__device__ float absmax_share(const T* xr, int K, int tid, int nthr) {
  float amax = 0.0f;
  if (read8(xr, K)) {
    for (int k = 8 * tid; k < K; k += 8 * nthr) {
      float v[8];
      ld8<kCG>(xr + k, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
  } else {
    for (int k = tid; k < K; k += nthr)
      amax = fmaxf(amax, fabsf(ld1<kCG>(xr + k)));
  }
  return amax;
}

// This thread's share of the codes of the K values at xr, into qr.
template <bool kCG, typename T>
__device__ void quantize_share(const T* xr, int K, float scale, int8_t* qr,
                               int tid, int nthr) {
  if (by8(xr, qr, K)) {
    for (int k = 8 * tid; k < K; k += 8 * nthr) {
      float v[8];
      ld8<kCG>(xr + k, v);
      uint2 q;
      int8_t* b = reinterpret_cast<int8_t*>(&q);
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = code(v[i], scale);
      *reinterpret_cast<uint2*>(qr + k) = q;
    }
  } else {
    for (int k = tid; k < K; k += nthr)
      qr[k] = code(ld1<kCG>(xr + k), scale);
  }
}

// A row held in registers between its two passes (one read of the row,
// not two): each of nthr threads loads its share, 8 values a chunk, at
// most kChunks chunks (K <= 8 kChunks nthr, fits(): and by8()).
template <int kChunks>
struct HeldRow {
  float v[kChunks][8];

  template <typename T>
  __device__ static bool fits(const T* xr, const int8_t* qr, int K,
                              int nthr) {
    return by8(xr, qr, K) && K <= 8 * kChunks * nthr;
  }
  // loads this thread's share; returns its share of the absmax
  template <bool kCG, typename T>
  __device__ float load(const T* xr, int K, int tid, int nthr) {
    float amax = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = 8 * (tid + c * nthr);
      if (k < K) {
        ld8<kCG>(xr + k, v[c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
      }
    }
    return amax;
  }
  // this thread's share of the codes, from the registers
  __device__ void quantize(int K, float scale, int8_t* qr, int tid,
                           int nthr) const {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = 8 * (tid + c * nthr);
      if (k < K) {
        uint2 q;
        int8_t* b = reinterpret_cast<int8_t*>(&q);
#pragma unroll
        for (int i = 0; i < 8; ++i) b[i] = code(v[c][i], scale);
        *reinterpret_cast<uint2*>(qr + k) = q;
      }
    }
  }
};

}  // namespace rowq
}  // namespace aimet
