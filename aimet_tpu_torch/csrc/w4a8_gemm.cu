// K2: W4A8 GEMM — per-row INT8 activations x split-half packed INT4 weights.
//
// Replaces the GEMM of both TPU W4A8 kernels:
//   aimet_tpu/ops/int_matmul.py:matmul_w4a8_fusedq / _w4a8_fusedq_kernel
//   (K unsplit) and matmul_w4a8 / _w4a8_kernel (K split). The TPU needed
//   two variants because a whole K row had to fit in VMEM; here a block
//   loops over K itself, so one kernel takes every K.
//
// Computes out[m,n] = ((float)sum_k xq[m,k] * W[k,n]) * sx[m] * sw[n], cast
// to the out dtype, with the integer sum exact in int32 and the epilogue in
// the reference's order (int_matmul.py:497). W is the split-half biased
// layout (int_matmul.py:85-105): packed byte p of row r holds
// W[r] + 8 in its low nibble and W[r + K/2] (signed) in its high nibble.
// The nibbles are unpacked to signed int8 in registers (lo = (p & 15) - 8,
// hi = p >> 4, arithmetic); Hopper's MMA takes no int4.
//
// Bound on the H100: at prefill (M >= a few hundred) the int8 tensor-core
// rate (1,979 TOP/s dense); at decode (M <= 64) the packed weight bytes
// (K/2 x N at 3.35 TB/s). Three routes, chosen from the shape alone
// (ops/int_matmul.py, w4a8_decode_route, w4a8_tile_route), and at decode
// M K1 folded in front of the first (matmul_w4a8_fusedq,
// w4a8_fusedq_decode_kernel below: one cooperative launch quantizes the
// rows, then runs the decode route):
// - decode M (1 <= M <= 64, K/2 and N multiples of 16): w4a8_decode_kernel,
//   the decode weight-streaming routine of decode_gemm.cuh in its kW4Int8
//   kind (the one KSOL's w4a8 phases run): one block an SM, each streaming
//   an equal share of the packed weight bytes through a cp.async ring, x by
//   TMA, exact int32 sums; a slice split across blocks is added in block
//   order by the last block to finish its piece (slice counters left 0);
// - prefill M (M > 64, K/2 and N multiples of 16, at least the route's
//   count of 128 x 256 output tiles: w4a8_tile_route): w4a8_tile_kernel,
//   the persistent TMA + wgmma tile of wgmma_wo_tile.cuh in its kW4Int8
//   format: the int8 codes of x by TMA as wgmma's B operand, the packed
//   weights by TMA, sign-extended to int8 and transposed in registers
//   into wgmma's A operand (m64n128k32.s32.s8.s8), no split K, exact int32
//   sums and this epilogue's order;
// - every other shape: a simple tiled kernel on mma.sync.m16n8k32.s8.s8.s32
//   (the block tile aimet::s8_tile of gemm_tiles.cuh). A block owns a
//   64 x 128 output tile and walks its K range 64 packed rows at a time.
//   Where the M x N grid alone cannot fill 132 SMs (ragged small shapes
//   the decode route refuses), the K range is split across blocks and the
//   int32 partial sums are combined with integer atomics into a zeroed
//   (M, N) buffer (order-independent, so bit-exact), then a small epilogue
//   kernel.
#include <algorithm>

#include "decode_gemm.cuh"
#include "gemm_tiles.cuh"
#include "row_quant.cuh"
#include "wgmma_wo_tile.cuh"

namespace {

// the decode kernels' scratch in the ring's header (decode_gemm.cuh:
// barriers from byte 0): phase 0's reduction and a flag
constexpr int kRedOffset = 256;
constexpr int kFlagOffset = 512;

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

template <typename OutT>
__device__ __forceinline__ void store_out(OutT* out, float v) {
  *out = aimet::from_f32<OutT>(v);
}

__device__ __forceinline__ float epilogue(int acc, float sxm, float swn) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), swn);
}

// splits == 1: writes `out`; splits > 1: atomically adds the block's int32
// partial sums into `ws` (M, N), finished by w4a8_epilogue_kernel.
template <typename OutT>
__global__ void __launch_bounds__(kTileThreads)
w4a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ wp, const float* __restrict__ sw,
                 OutT* __restrict__ out, int* __restrict__ ws, int M, int N,
                 int K2, int split_rows) {
  __shared__ __align__(16) aimet::S8Tile sm;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int p_begin = blockIdx.z * split_rows;
  const int p_end = min(K2, p_begin + split_rows);
  int acc[2][4][4] = {};
  aimet::s8_tile(xq, wp, M, N, K2, m0, n0, p_begin, p_end, sm, acc);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + aimet::acc_row(mi, c);
        const int n = n0 + aimet::acc_col(ni, c);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (ws != nullptr)
          atomicAdd(ws + o, acc[mi][ni][c]);
        else
          store_out(out + o, epilogue(acc[mi][ni][c], sx[m], sw[n]));
      }
}

template <typename OutT>
__global__ void w4a8_epilogue_kernel(const int* __restrict__ ws,
                                     const float* __restrict__ sx,
                                     const float* __restrict__ sw,
                                     OutT* __restrict__ out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / N), n = (int)(i % N);
    store_out(out + i, epilogue(ws[i], sx[m], sw[n]));
  }
}

template <typename OutT>
int run(const int8_t* xq, const float* sx, const int8_t* wp, const float* sw,
        OutT* out, int* ws, int M, int N, int K2, int splits,
        cudaStream_t s) {
  const int ktiles = (K2 + aimet::kS8Step - 1) / aimet::kS8Step;
  const int per_split = (ktiles + splits - 1) / splits;
  const int nsplit = (ktiles + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  w4a8_gemm_kernel<OutT><<<grid, kTileThreads, 0, s>>>(
      xq, sx, wp, sw, out, split ? ws : nullptr, M, N, K2,
      per_split * aimet::kS8Step);
  if (split) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total = (size_t)M * N;
    const int blocks =
        (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
    w4a8_epilogue_kernel<OutT><<<blocks, 256, 0, s>>>(ws, sx, sw, out, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- K2 at decode M
// The same function on the decode weight-streaming routine (kW4Int8): x
// (M <= 64, K = 2 K2 int8 values a row) by TMA, the packed weights by
// cp.async. A slice held by one block goes straight to out; else each
// piece's int32 sums go to workspace slot (slice + block) and the last
// block of the slice adds them in block order. cnt: one int a slice, 0 on
// entry and on exit.

// The end of one piece of the decode route (K2's kernel and the fused
// one): acc holds the consumer thread's sums of piece p (stream_gemm's
// layout). sx is read through L2: the fused kernel's blocks wrote it in
// this launch.
template <typename OutT, int MT>
__device__ __forceinline__ void finish_piece(
    const aimet::dec::Geo& g, const aimet::dec::Piece& p,
    const int (&acc)[MT][4][4], const float* sx, const float* sw,
    OutT* out, int* ws, int* cnt, int* flag) {
  namespace dec = aimet::dec;
  constexpr int kW = dec::kW;
  const int M = g.M, N = g.N;
  const int n0 = p.j * kW, ncols = min(kW, N - n0);
  const int b0 = g.first_block(p.j), b1 = g.last_block(p.j);
  if (b0 == b1) {                      // the slice whole: to out
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = lane & 3, gq = lane >> 2;
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * mb + gq + 8 * (e >> 1);
        const int c = warp * 32 + 8 * t + 4 * (e & 1);
        if (m >= M || c >= ncols) continue;
        OutT* o = out + (size_t)m * N + n0 + c;
        const float sxm = __ldcg(sx + m);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          store_out(o + i, epilogue(acc[mb][i][e], sxm, sw[n0 + c + i]));
      }
    return;
  }
  dec::store_piece(ws + (size_t)(p.j + blockIdx.x) * M * kW, acc, M, ncols);
  // the consumers' barrier, then one thread's fence, release the piece (as
  // wo_decode_kernel in wo_gemm.cu)
  dec::consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(&cnt[p.j], 1) == b1 - b0;
    if (last) {
      cnt[p.j] = 0;                    // ready for the next call
      __threadfence();
    }
    *flag = last;
  }
  dec::consumer_sync();
  if (!*flag) return;
  // 4 columns a thread at a time: ncols is a multiple of 16
  for (int i = 4 * threadIdx.x; i < M * ncols;
       i += 4 * 32 * dec::kConsumerWarps) {
    const int m = i / ncols, c = i % ncols;
    const int4 v = dec::slice_sum4<int>(ws, g, p.j, m, c);
    OutT* o = out + (size_t)m * N + n0 + c;
    const float* s4 = sw + n0 + c;
    const float sxm = __ldcg(sx + m);
    store_out(o + 0, epilogue(v.x, sxm, s4[0]));
    store_out(o + 1, epilogue(v.y, sxm, s4[1]));
    store_out(o + 2, epilogue(v.z, sxm, s4[2]));
    store_out(o + 3, epilogue(v.w, sxm, s4[3]));
  }
}

template <typename OutT>
__global__ void __launch_bounds__(aimet::dec::kThreads, 1)
w4a8_decode_kernel(const int8_t* __restrict__ wp,
                   const __grid_constant__ CUtensorMap map_x,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   OutT* __restrict__ out, int* __restrict__ ws,
                   int* __restrict__ cnt, int M, int N, int K2) {
  namespace dec = aimet::dec;
  extern __shared__ __align__(128) unsigned char dsmem[];
  int* flag = reinterpret_cast<int*>(dsmem + kFlagOffset);
  const int mt = (M + 15) / 16;
  dec::Ring ring = dec::make_ring<dec::kW4Int8>(dsmem, mt);
  __syncthreads();
  const dec::Geo g(M, K2, N, 1, gridDim.x);
  const dec::Operand op{wp, nullptr, N, &map_x, K2};
  dec::stream_gemm<dec::kW4Int8>(
      op, g, mt, ring, [&](const dec::Piece& p, const auto& acc) {
        finish_piece(g, p, acc, sx, sw, out, ws, cnt, flag);
      });
}

// ---------------------------------- K1 folded into K2's decode route
// The TPU's _w4a8_fusedq_kernel (int_matmul.py:625-658) quantizes each row
// of x inside the GEMM. Here it is one cooperative launch (its blocks all
// resident at once), one block an SM, of 8 consumer warps and the
// routine's producer warp:
// - phase 0: the rows of x are dealt to the blocks, one row a block at a
//   time; the consumer warps compute K1's bits (the shared row quantizer,
//   row_quant.cuh: absmax, sx = max(amax, 1e-8) / 127, the codes; the row
//   held in registers between its passes) into the workspaces xq and sx.
//   Meanwhile the producer warp issues the first weight stages of the GEMM
//   into its ring (issue_ahead: the weights need nothing phase 0 writes);
// - the release of the codes: each writer's proxy fence (the TMA, an async
//   proxy, reads what other SMs wrote with generic stores; KSOL's barrier,
//   fused_layer.cu), then a count of finished rows (rows_done, released
//   by one thread a row) that only the producer waits on, with a proxy
//   fence after its acquire, before its first x box: the consumers go
//   straight on to their first stage's barrier;
// - phase 1: K2's decode route unchanged (the codes by TMA from a tensor
//   map on xq, its pieces and epilogue: finish_piece). The last block to
//   finish sets the two counters after the slices' back to 0.
// Codes, scales and output are bit for bit those of K1 + K2's decode
// route. What it saves at decode M, where K1 is pure latency (~2.5 us
// against a bound of 0.06 us at 16 x 4096 on the H100): one launch and
// its dispatch. It does not hide phase 0: the route's consumers, not the
// weight stream, set its pace, so phase 0, the release and the codes'
// TMA latency add ~4-5 us to K2's time, more than K1's at M <= 32; the
// per-slot step still gains on the host more than that (PERF.md, §6 PR
// 12).

// an acquiring load of a global int (the producer's wait)
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <typename XT, typename OutT>
__global__ void __launch_bounds__(aimet::dec::kThreads, 1)
w4a8_fusedq_decode_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                          float* __restrict__ sx,
                          const int8_t* __restrict__ wp,
                          const __grid_constant__ CUtensorMap map_x,
                          const float* __restrict__ sw,
                          OutT* __restrict__ out, int* __restrict__ ws,
                          int* __restrict__ cnt, int M, int N, int K2) {
  namespace dec = aimet::dec;
  namespace rowq = aimet::rowq;
  constexpr int kET = 32 * dec::kConsumerWarps;
  extern __shared__ __align__(128) unsigned char dsmem[];
  float* red = reinterpret_cast<float*>(dsmem + kRedOffset);
  int* flag = reinterpret_cast<int*>(dsmem + kFlagOffset);
  const int mt = (M + 15) / 16, K = 2 * K2;
  dec::Ring ring = dec::make_ring<dec::kW4Int8>(dsmem, mt);
  __syncthreads();
  const dec::Geo g(M, K2, N, 1, gridDim.x);
  const dec::Operand op{wp, nullptr, N, &map_x, K2};
  // after the slices' counters: rows quantized, blocks finished
  int* rows_done = cnt + g.nslices;
  int* blocks_done = rows_done + 1;
  if (threadIdx.x / 32 == dec::kConsumerWarps) {
    dec::issue_ahead<dec::kW4Int8>(op, g, mt, ring, ring.stages);
    if ((threadIdx.x & 31) == 0) {
      while (ld_acquire(rows_done) < M) __nanosleep(64);
      dec::fence_proxy_async();
    }
    __syncwarp();
  } else {
    // a row held in registers between its two passes from K = 512 up to
    // 8 x 8 x 256 values (every width the port serves); other rows, and
    // unaligned ones, are read twice
    using Held = rowq::HeldRow<8>;
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      const XT* xr = x + (size_t)m * K;
      int8_t* qr = xq + (size_t)m * K;
      float s;
      if (Held::fits(xr, qr, K, kET)) {
        Held row;
        s = rowq::scale_of(dec::consumer_reduce(
            row.load<false>(xr, K, threadIdx.x, kET), true, red));
        row.quantize(K, s, qr, threadIdx.x, kET);
      } else {
        s = rowq::scale_of(dec::consumer_reduce(
            rowq::absmax_share<false>(xr, K, threadIdx.x, kET), true, red));
        rowq::quantize_share<false>(xr, K, s, qr, threadIdx.x, kET);
      }
      if (threadIdx.x == 0) sx[m] = s;
      dec::fence_proxy_async();
      dec::consumer_sync();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(rows_done, 1);
      }
    }
  }
  dec::stream_gemm<dec::kW4Int8>(
      op, g, mt, ring, [&](const dec::Piece& p, const auto& acc) {
        finish_piece(g, p, acc, sx, sw, out, ws, cnt, flag);
      });
  // every producer of the grid has passed its wait once its block is here:
  // the last block leaves both counters 0 for the next launch
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(blocks_done, 1) == gridDim.x - 1) {
    *rows_done = 0;
    *blocks_done = 0;
    __threadfence();
  }
}

template <typename OutT>
int run_decode(const void* xq, const void* sx, const void* wp,
               const void* sw, void* out, void* ws, void* cnt, int M, int N,
               int K2, int blocks, cudaStream_t s) {
  namespace dec = aimet::dec;
  CUtensorMap mx;
  if (!dec::x_map<dec::kW4Int8>(&mx, xq, M, 2 * K2, (M + 15) / 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = w4a8_decode_kernel<OutT>;
  static bool ready = false;                 // the smem limit, once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dec::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  kern<<<blocks, dec::kThreads, dec::kSmemBytes, s>>>(
      static_cast<const int8_t*>(wp), mx, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<OutT*>(out),
      static_cast<int*>(ws), static_cast<int*>(cnt), M, N, K2);
  return static_cast<int>(cudaGetLastError());
}

// The fused decode kernel for x of type XT: a cooperative launch of
// `blocks` blocks, refused (cudaErrorCooperativeLaunchTooLarge) unless
// they can all be resident at once.
template <typename XT, typename OutT>
int run_fusedq_decode(const void* x, void* xq, void* sx, const void* wp,
                      const void* sw, void* out, void* ws, void* cnt, int M,
                      int N, int K2, int blocks, cudaStream_t s) {
  namespace dec = aimet::dec;
  CUtensorMap mx;
  if (!dec::x_map<dec::kW4Int8>(&mx, xq, M, 2 * K2, (M + 15) / 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = w4a8_fusedq_decode_kernel<XT, OutT>;
  // the smem limit, then the blocks that can be resident at once, once a
  // device (the one the launch goes to)
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dec::kSmemBytes)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, dec::kThreads, dec::kSmemBytes)) != cudaSuccess)
      return static_cast<int>(e);
    resident[dev] = per_sm * sms;
  }
  if (blocks > resident[dev])
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const XT* xp = static_cast<const XT*>(x);
  int8_t* xqp = static_cast<int8_t*>(xq);
  float* sxp = static_cast<float*>(sx);
  const int8_t* wpp = static_cast<const int8_t*>(wp);
  const float* swp = static_cast<const float*>(sw);
  OutT* op = static_cast<OutT*>(out);
  int* wsp = static_cast<int*>(ws);
  int* cntp = static_cast<int*>(cnt);
  void* args[] = {&xp, &xqp, &sxp, &wpp, &mx, &swp, &op, &wsp, &cntp,
                  &M, &N, &K2};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                  dim3(blocks), dim3(dec::kThreads), args,
                                  (size_t)dec::kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ws` is an (M, N) int32 buffer of zeros, read only when splits > 1.
extern "C" int aimet_w4a8_gemm(const void* xq, const void* sx, const void* wp,
                               const void* sw, void* out, void* ws, int M,
                               int N, int K2, int splits, int out_is_bf16,
                               void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || splits <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* sxp = static_cast<const float*>(sx);
  const int8_t* w = static_cast<const int8_t*>(wp);
  const float* swp = static_cast<const float*>(sw);
  int* wsp = static_cast<int*>(ws);
  if (out_is_bf16)
    return run(x, sxp, w, swp, static_cast<__nv_bfloat16*>(out), wsp, M, N,
               K2, splits, s);
  return run(x, sxp, w, swp, static_cast<float*>(out), wsp, M, N, K2, splits,
             s);
}

// K2's decode route: xq (M, 2 K2) int8 with 1 <= M <= 64, wp (K2, N)
// split-half INT4, K2 and N multiples of 16, xq and wp 16-byte aligned; a
// grid of `blocks` blocks (the SMs) streaming slices of 256 columns. ws
// holds ws_values int32 and cnt cnt_values ints, all 0 (and left 0):
// refused when short of what the split (decode_gemm.cuh, Geo) needs.
extern "C" int aimet_w4a8_decode_gemm(const void* xq, const void* sx,
                                      const void* wp, const void* sw,
                                      void* out, void* ws, void* cnt, int M,
                                      int N, int K2, int blocks,
                                      long long ws_values, int cnt_values,
                                      int out_is_bf16, void* stream) {
  namespace dec = aimet::dec;
  if (M <= 0 || M > 16 * dec::kMaxMT || K2 <= 0 || N <= 0 || K2 % 16 ||
      N % 16 || blocks <= 0 || !aimet::aligned16(xq) ||
      !aimet::aligned16(wp))
    return static_cast<int>(cudaErrorInvalidValue);
  const dec::Geo g(M, K2, N, 1, blocks);
  if (ws_values < g.ws_values() || cnt_values < g.nslices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16
             ? run_decode<__nv_bfloat16>(xq, sx, wp, sw, out, ws, cnt, M, N,
                                         K2, blocks, s)
             : run_decode<float>(xq, sx, wp, sw, out, ws, cnt, M, N, K2,
                                 blocks, s);
}

// K2's route at prefill M (wgmma_wo_tile.cuh, kW4Int8): xq (M, 2 K2) int8
// codes, rows unit-stride, wp (K2, N) split-half INT4, K2 and N multiples
// of 16 (x's high half 16-byte aligned); xq, wp and sw 16-byte aligned;
// out (M, N) bf16 or f32, (f32(sum) * sx[m]) * sw[n].
extern "C" int aimet_w4a8_tile_gemm(const void* xq, const void* sx,
                                    const void* wp, const void* sw,
                                    void* out, int M, int N, int K2,
                                    int out_is_bf16, void* stream) {
  namespace wot = aimet::wot;
  constexpr int kKind = aimet::dec::kW4Int8;
  if (M <= 0 || N <= 0 || K2 <= 0) return 0;
  if (K2 % 16 || N % 16 || !aimet::aligned16(xq) || !aimet::aligned16(wp) ||
      !aimet::aligned16(sw))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  if (!aimet::encode_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wp, K2, N, N,
                        wot::Stage<kKind>::kRows, 128) ||
      !aimet::encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, 2 * K2,
                        2LL * K2, wot::kBM, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  return out_is_bf16
             ? wot::launch_tile<kKind, __nv_bfloat16, false>(
                   mx, mw, sxp, swp, nullptr,
                   static_cast<__nv_bfloat16*>(out), M, N, K2, K2, 0, M, s)
             : wot::launch_tile<kKind, float, false>(
                   mx, mw, sxp, swp, nullptr, static_cast<float*>(out), M,
                   N, K2, K2, 0, M, s);
}

// K1 folded into K2's decode route (w4a8_fusedq_decode_kernel, one
// cooperative launch): x (M, 2 K2) bf16 or f32 (x_is_bf16) with 1 <= M <=
// 64, rows unit-stride, x 16-byte aligned; wp (K2, N) split-half INT4, K2
// and N multiples of 16, 16-byte aligned; xq (M, 2 K2) int8 and sx (M,)
// f32 workspaces that receive K1's codes and scales (xq 16-byte aligned);
// out (M, N) bf16 or f32; ws, blocks and ws_values as for
// aimet_w4a8_decode_gemm; cnt: cnt_values ints, 0 (and left 0), at least
// two past the slices' (the rows and blocks done). Refused when the grid
// cannot be resident at once.
extern "C" int aimet_w4a8_fusedq_decode_gemm(
    const void* x, void* xq, void* sx, const void* wp, const void* sw,
    void* out, void* ws, void* cnt, int M, int N, int K2, int blocks,
    long long ws_values, int cnt_values, int x_is_bf16, int out_is_bf16,
    void* stream) {
  namespace dec = aimet::dec;
  if (M <= 0 || M > 16 * dec::kMaxMT || K2 <= 0 || N <= 0 || K2 % 16 ||
      N % 16 || blocks <= 0 || !aimet::aligned16(x) ||
      !aimet::aligned16(xq) || !aimet::aligned16(wp))
    return static_cast<int>(cudaErrorInvalidValue);
  const dec::Geo g(M, K2, N, 1, blocks);
  if (ws_values < g.ws_values() || cnt_values < g.nslices + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = x_is_bf16
                 ? (out_is_bf16
                        ? run_fusedq_decode<__nv_bfloat16, __nv_bfloat16>
                        : run_fusedq_decode<__nv_bfloat16, float>)
                 : (out_is_bf16 ? run_fusedq_decode<float, __nv_bfloat16>
                                : run_fusedq_decode<float, float>);
  return run(x, xq, sx, wp, sw, out, ws, cnt, M, N, K2, blocks, s);
}
