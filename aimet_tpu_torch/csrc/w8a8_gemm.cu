// KQ8: the dynamic full-INT8 GEMM.
//
// KQ8 replaces aimet_tpu/ops/int_matmul.py:matmul_q8 (_w8a8_kernel and
// _w8a8_kernel_bias): already-quantized int8 activations x int8 weights,
// int32 sums, then
//   out[m,n] = (f32(acc) * sx[m]) * sw[n]              (no column bias)
//   out[m,n] = fma(f32(acc) * sx[m], sw[n], cb[n])     (with one)
// The second product and the bias add round once, as XLA contracts the TPU
// kernel's body into an FMA on the CPU, where the reference's tests run it
// in interpret mode; without a bias both products round, as there. Its
// int32 entry writes the raw sums: the direct integer conv of
// ops/int_conv.py (XLA's implicit GEMM in the JAX package) runs as a
// zero-point-filled int8 im2col and this entry.
//
// int_matmul.py:matmul_w8a8_fusedq (_w8a8_fusedq_kernel) has no kernel of
// its own here: ops/int_matmul.py runs K1 (act_quant.cu, the same f32 row
// quantizer bit for bit) and then KQ8. The TPU kernel quantized each row
// into VMEM so that the codes never went to HBM; a tile quantizing on its
// way into shared memory would redo each row's division for every
// 256-column tile (112 times at N = 28672), while the int8 codes cost one
// extra write and read of M x K bytes.
//
// Bound on the H100: at prefill M the int8 tensor-core rate (1,979 TOP/s
// dense); at decode M the int8 weight bytes (K x N at 3.35 TB/s). The
// integer conv's int32 entry is bound by bytes: its patch matrix and its
// int32 output (ResNet-50's 3 x 3 convs do ~180 operations a byte).
// Design, three routes picked by the wrapper from the shapes
// (ops/int_matmul.py):
// - f32 / bf16 entries at prefill M (M > 64, K and N multiples of 16, at
//   least the route's count of 128 x 256 output tiles: q8_tile_route):
//   q8_tile_kernel, the persistent TMA + wgmma tile of wgmma_wo_tile.cuh
//   in its kQ8 format (KSQ's stage: the codes by TMA as wgmma's B operand,
//   the N-major int8 weights by TMA, byte-transposed in registers into
//   wgmma's A operand, m64n128k32.s32.s8.s8), no split K, exact int32
//   sums and this epilogue in its order;
// - the other f32 / bf16 calls, and the int32 entry on an N-major (K, N)
//   weight (the JAX layout): the block tile aimet::s8_tile<false>
//   (gemm_tiles.cuh) on mma.sync.m16n8k32.s8 over any K, 128 k values a
//   step, as KSQ (w8a8_staticq.cu). Where M x N tiles cannot fill 132 SMs
//   the K range is split across blocks and the exact int32 partial sums
//   are combined with integer atomics (order-free, so the result stays
//   bit-exact), then an epilogue kernel applies the scales;
// - the int32 entry on a K-major weight (the integer conv's): the TMA +
//   wgmma route below.
#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "gemm_tiles.cuh"
#include "tma_wgmma.cuh"
#include "wgmma_wo_tile.cuh"

namespace {

using aimet::kTileM;
using aimet::kTileN;
using aimet::kTileThreads;

// the f32 epilogue of one sum, in the JAX kernel's order
template <bool kBias>
__device__ __forceinline__ float epilogue(int acc, float sxm, float swn,
                                          float cbn) {
  const float a = __fmul_rn(__int2float_rn(acc), sxm);
  return kBias ? __fmaf_rn(a, swn, cbn) : __fmul_rn(a, swn);
}

template <typename OutT, bool kBias>
__device__ __forceinline__ void store(OutT* out, size_t o, int acc,
                                      const float* sx, const float* sw,
                                      const float* cb, int m, int n) {
  if constexpr (std::is_same<OutT, int>::value)
    out[o] = acc;
  else
    out[o] = aimet::from_f32<OutT>(
        epilogue<kBias>(acc, sx[m], sw[n], kBias ? cb[n] : 0.0f));
}

// ws == nullptr: writes `out`; else atomically adds the block's int32
// partial sums into `ws` (M, N), finished by q8_epilogue_kernel (an int32
// output is its own ws).
template <typename OutT, bool kBias>
__global__ void __launch_bounds__(kTileThreads)
q8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               const float* __restrict__ cb, OutT* __restrict__ out,
               int* __restrict__ ws, int M, int N, int K, int split_rows) {
  __shared__ __align__(16) aimet::S8Tile sm;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int k_begin = blockIdx.z * split_rows;
  const int k_end = min(K, k_begin + split_rows);
  int acc[2][4][4] = {};
  aimet::s8_tile<false>(xq, w, M, N, K, m0, n0, k_begin, k_end, sm, acc);
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
          store<OutT, kBias>(out, o, acc[mi][ni][c], sx, sw, cb, m, n);
      }
}

template <typename OutT, bool kBias>
__global__ void q8_epilogue_kernel(const int* __restrict__ ws,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sw,
                                   const float* __restrict__ cb,
                                   OutT* __restrict__ out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    store<OutT, kBias>(out, i, ws[i], sx, sw, cb, (int)(i / N),
                       (int)(i % N));
}

int grid_for(size_t total) {
  return (int)std::min<size_t>((total + 255) / 256, (size_t)4 * 132 * 8);
}

template <typename OutT, bool kBias>
int gemm(const int8_t* xq, const int8_t* w, const float* sx, const float* sw,
         const float* cb, OutT* out, int* ws, int M, int N, int K, int splits,
         cudaStream_t s) {
  constexpr bool kInt = std::is_same<OutT, int>::value;
  constexpr int R = aimet::s8_step_rows<false>();
  const int steps = (K + R - 1) / R;
  const int per_split = (steps + splits - 1) / splits;
  const int nsplit = (steps + per_split - 1) / per_split;
  const bool split = nsplit > 1;
  int* acc_ws = split ? (kInt ? reinterpret_cast<int*>(out) : ws) : nullptr;
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nsplit);
  q8_gemm_kernel<OutT, kBias><<<grid, kTileThreads, 0, s>>>(
      xq, w, sx, sw, cb, out, acc_ws, M, N, K, per_split * R);
  if constexpr (!kInt) {
    if (split) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      q8_epilogue_kernel<OutT, kBias><<<grid_for((size_t)M * N), 256, 0,
                                        s>>>(ws, sx, sw, cb, out, M, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ int32 entry, K-major weights
// The route of the int32 entry when the weight arrives K-major, (N, K) with
// 16-byte aligned rows (the OIHW conv weight reshaped to (co, ci kh kw) is
// exactly that, so the integer conv passes it as it is): TMA + wgmma.
//
// A persistent block per SM walks BM x BN output tiles (BN = 64 or 128,
// n fastest, so blocks running together share A rows in L2). Warp 0 is the
// producer: one thread keeps a ring of up to 6 shared-memory stages fed
// with TMA loads of a 128-byte K step of A (BM rows) and of B (BN rows),
// 128-byte swizzled, each stage's arrival counted by an mbarrier; it runs
// on into the next tile while the consumers store, so one tile's int32
// stores overlap the next one's loads. BM / 64 consumer warpgroups (1 to
// 3: the tile height that needs the fewest waves of tiles) each take 64
// rows: wgmma.m64nBNk32.s32.s8.s8 reads both operands from shared memory,
// 4 MMAs a stage, one stage's MMAs in flight while the next is awaited,
// exact int32 sums in registers. Each warpgroup then writes its 64 x BN
// sums into its own shared tile (128-byte swizzled) and one thread hands
// it to a TMA store, which writes whole lines and clips the ragged edge
// while the MMAs of the next tile run (an int32 output whose rows are not
// 16-byte aligned, N % 4 != 0, is stored by the threads, 8 bytes at a
// time). TMA fills rows and k values past the matrix with zeros, so
// ragged M, N and K need no masks in the main loop. Where the tiles fill
// under a quarter of the SMs (a small-M call) the wrapper splits K and the
// splits add into a zeroed output with integer atomics (exact, so
// order-free).

constexpr int kQ8BK = 128;                 // bytes (k values) a stage

using aimet::bulk_commit;
using aimet::bulk_wait_all;
using aimet::bulk_wait_read;
using aimet::encode_2d;
using aimet::fence_proxy_async_shared;
using aimet::mbar_arrive;
using aimet::mbar_arrive_expect_tx;
using aimet::mbar_init;
using aimet::mbar_wait;
using aimet::sw128_desc;
using aimet::tma_load;
using aimet::tma_store;
using aimet::warpgroup_bar;
using aimet::wgmma_commit;
using aimet::wgmma_fence;
using aimet::wgmma_wait;

// d += A . B for one warpgroup: A 64 x 32 and B N x 32 int8, both K-major
// in shared memory (descriptors da, db), exact int32 sums (the scale-d
// predicate is 1: accumulate)
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64)
    wgmma_s8_n64(d, da, db);
  else
    wgmma_s8_n128(d, da, db);
}

// each consumer warpgroup's epilogue tile: 64 rows x BN int32, as BN / 32
// swizzled (64 x 128-byte) boxes of the TMA store
template <int BN>
__host__ __device__ constexpr int q8_epi_bytes() {
  return 64 * BN * 4;
}
// stages of a BM x BN tile: as many 128-byte K steps as fit in ~220 KB
// beside the epilogue tiles, at most 6
template <int BM, int BN>
__host__ __device__ constexpr int q8_stages() {
  return (220 * 1024 - BM / 64 * q8_epi_bytes<BN>()) / ((BM + BN) * kQ8BK) <
                 6
             ? (220 * 1024 - BM / 64 * q8_epi_bytes<BN>()) /
                   ((BM + BN) * kQ8BK)
             : 6;
}
template <int BM, int BN>
__host__ __device__ constexpr size_t q8_tma_smem() {
  return (size_t)q8_stages<BM, BN>() * (BM + BN) * kQ8BK +
         (size_t)BM / 64 * q8_epi_bytes<BN>() + 1024;  // + alignment
}

// BM = 64 x the consumer warpgroups (1, 2 or 3); BN = 64 or 128
template <int BM, int BN>
__global__ void __launch_bounds__(128 + 2 * BM, 1)
q8_tma_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_out,
              int* __restrict__ out, int M, int N, int ksteps, int per_split,
              int nsplit, int tiles_n, int tiles, int atomic, int tma_out) {
  constexpr int kStages = q8_stages<BM, BN>();
  constexpr uint32_t kStageBytes = (BM + BN) * kQ8BK;
  extern __shared__ unsigned char q8_smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(q8_smem) + 1023) & ~(uintptr_t)1023);
  int8_t* sa = reinterpret_cast<int8_t*>(base);           // [stage][BM][128]
  int8_t* sb = sa + kStages * BM * kQ8BK;                  // [stage][BN][128]
  // [wg][BN / 32][64][128] epilogue tiles
  unsigned char* se =
      reinterpret_cast<unsigned char*>(sb + kStages * BN * kQ8BK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * BM);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int units = tiles * nsplit;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {                                   // producer
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = u % tiles, split = u / tiles;
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      const int k_end = min(ksteps, (split + 1) * per_split);
      for (int ks = split * per_split; ks < k_end; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load(sa + stage * BM * kQ8BK, &map_a, ks * kQ8BK, m0,
                 &full[stage]);
        tma_load(sb + stage * BN * kQ8BK, &map_b, ks * kQ8BK, n0,
                 &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  // consumers: warpgroup wg - 1 takes rows 64 (wg - 1) .. of each tile
  const int cw = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  int stage = 0;
  uint32_t phase = 0;
  int acc[BN / 2];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u % tiles, split = u / tiles;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int k_end = min(ksteps, (split + 1) * per_split);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // one stage's MMAs stay in flight while the next stage is awaited;
    // a stage is released once the MMAs that read it are done
    int prev = -1;
    for (int ks = split * per_split; ks < k_end; ++ks) {
      mbar_wait(&full[stage], phase);
      const int8_t* a = sa + stage * BM * kQ8BK + cw * 64 * kQ8BK;
      const int8_t* b = sb + stage * BN * kQ8BK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ8BK; kk += 32)
        wgmma_s8<BN>(acc, sw128_desc(a + kk), sw128_desc(b + kk));
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    // acc[4c + 2i + j] is row 16 warp + lane / 4 + 8i, column
    // 8c + 2 (lane % 4) + j of this warpgroup's 64 x BN block
    if (tma_out) {
      // through shared memory: 128-byte swizzled boxes of 64 rows x 32
      // columns, stored by the TMA unit (whole lines, rows and columns
      // past the matrix clipped) while the MMAs of the next tile run
      unsigned char* ep = se + cw * q8_epi_bytes<BN>();
      if (t == 0) bulk_wait_read();      // the last tile's boxes are out
      warpgroup_bar(1 + cw);
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = warp * 16 + lane / 4 + 8 * i;
          const int chunk = (2 * (c % 4) + (lane % 4) / 2) ^ (rr % 8);
          *reinterpret_cast<int2*>(ep + (c / 4) * 64 * 128 + rr * 128 +
                                   chunk * 16 + 8 * (lane % 2)) =
              make_int2(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
        }
      fence_proxy_async_shared();
      warpgroup_bar(1 + cw);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < BN / 32; ++q)
          tma_store(&map_out, ep + q * 64 * 128, n0 + 32 * q, m0 + cw * 64);
        bulk_commit();
      }
      continue;
    }
    const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = r0 + 8 * i, n = c0 + 8 * c;
        if (m >= M || n >= N) continue;
        int* o = out + (size_t)m * N + n;
        const int v0 = acc[4 * c + 2 * i], v1 = acc[4 * c + 2 * i + 1];
        if (atomic) {
          atomicAdd(o, v0);
          if (n + 1 < N) atomicAdd(o + 1, v1);
        } else if (n + 1 < N && (N % 2) == 0) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
  }
  if (tma_out && threadIdx.x % 128 == 0) bulk_wait_all();
}

template <int BM, int BN>
int run_q8_tma(const void* xq, int lda, const void* w, int ldb, int* out,
               int M, int N, int K, int splits, int sms, cudaStream_t s) {
  CUtensorMap ma, mb, mo;
  // the TMA store needs 16-byte aligned output rows; split K adds atomically
  const bool tma_out = N % 4 == 0 && splits == 1;
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, lda, BM,
                 128) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, ldb, BN,
                 128) ||
      (tma_out && !encode_2d(&mo, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, out, M,
                             N, N * 4, 64, 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!tma_out) mo = mb;                     // unused
  auto kern = q8_tma_kernel<BM, BN>;
  constexpr size_t smem = q8_tma_smem<BM, BN>();
  static bool ready = false;                 // the smem limit, once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int ksteps = (K + kQ8BK - 1) / kQ8BK;
  const int per_split = (ksteps + splits - 1) / splits;
  const int nsplit = (ksteps + per_split - 1) / per_split;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int grid = std::min(tiles * nsplit, sms);
  kern<<<grid, 128 + 2 * BM, smem, s>>>(ma, mb, mo, out, M, N, ksteps,
                                        per_split, nsplit, tiles_n, tiles,
                                        nsplit > 1, tma_out);
  return static_cast<int>(cudaGetLastError());
}

// rows of output a persistent block's M tiles cover in all, in waves of
// `sms` blocks: the tile height that needs the fewest
int waves_rows(int M, int N, int BM, int BN, int sms) {
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  return (tiles + sms - 1) / sms * BM;
}

template <int BN>
int run_q8_kmajor(const void* xq, int lda, const void* w, int ldb, int* out,
                  int M, int N, int K, int splits, cudaStream_t s) {
  static int sms = 0;                        // the card's SMs, once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return static_cast<int>(e);
  }
  // the tile height (64 x 1, 2 or 3 consumer warpgroups) whose waves of
  // tiles cover the fewest rows a block, 128 on a tie: ResNet-50's 3 x 3
  // convs at 28 x 28 x 32 images make 196 128-row tiles, two waves, or
  // 131 192-row tiles, one; its layer-4 3 x 3 convs (M = 1568, N = 512)
  // fill 100 of the SMs with 64-row tiles, 52 with 128-row ones
  if (splits == 1) {
    const int r192 = waves_rows(M, N, 192, BN, sms);
    const int r128 = waves_rows(M, N, 128, BN, sms);
    const int r64 = waves_rows(M, N, 64, BN, sms);
    if (r192 < r128 && r192 <= r64)
      return run_q8_tma<192, BN>(xq, lda, w, ldb, out, M, N, K, 1, sms, s);
    if (r64 < r128)
      return run_q8_tma<64, BN>(xq, lda, w, ldb, out, M, N, K, 1, sms, s);
  }
  return run_q8_tma<128, BN>(xq, lda, w, ldb, out, M, N, K, splits, sms, s);
}

}  // namespace

// KQ8. xq (M, K) int8; sx (M,) f32; w (K, N) int8; sw (N,) f32; cb (N,) f32
// or null; out (M, N) of out_kind (0 f32, 1 bf16, 2 int32: the raw sums,
// sx, sw and cb unused); ws an (M, N) int32 buffer of zeros, read
// only when splits > 1 and the output is not int32 (an int32 output must be
// zeros itself then).
extern "C" int aimet_q8_gemm(const void* xq, const void* sx, const void* w,
                             const void* sw, const void* cb, void* out,
                             void* ws, int M, int N, int K, int splits,
                             int out_kind, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits <= 0 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* cbp = static_cast<const float*>(cb);
  int* wsp = static_cast<int*>(ws);
  if (out_kind == 2)
    return gemm<int, false>(x, wp, sxp, swp, cbp, static_cast<int*>(out),
                            wsp, M, N, K, splits, s);
  if (out_kind == 1) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    return cbp ? gemm<__nv_bfloat16, true>(x, wp, sxp, swp, cbp, o, wsp, M,
                                           N, K, splits, s)
               : gemm<__nv_bfloat16, false>(x, wp, sxp, swp, cbp, o, wsp, M,
                                            N, K, splits, s);
  }
  auto* o = static_cast<float*>(out);
  return cbp ? gemm<float, true>(x, wp, sxp, swp, cbp, o, wsp, M, N, K,
                                 splits, s)
             : gemm<float, false>(x, wp, sxp, swp, cbp, o, wsp, M, N, K,
                                  splits, s);
}

// KQ8's int32 entry with K-major weights: xq (M, K) int8, rows lda bytes
// apart; w (N, K) int8, rows ldb bytes apart (lda, ldb and both pointers
// multiples of 16); out (M, N) int32, zeros when splits > 1 (the splits'
// sums meet there by integer atomics).
extern "C" int aimet_q8_int32_kmajor(const void* xq, int lda, const void* w,
                                     int ldb, void* out, int M, int N, int K,
                                     int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits <= 0 || lda < K || ldb < K || lda % 16 || ldb % 16 ||
      !aimet::aligned16(xq) || !aimet::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (N <= 64)
    return run_q8_kmajor<64>(xq, lda, w, ldb, o, M, N, K, splits, s);
  return run_q8_kmajor<128>(xq, lda, w, ldb, o, M, N, K, splits, s);
}

// KQ8's f32 / bf16 entries at prefill M (wgmma_wo_tile.cuh, kQ8): xq (M, K)
// int8 codes, rows unit-stride; sx (M,) f32; w (K, N) int8; sw (N,) f32;
// cb (N,) f32 or null; K and N multiples of 16 (the codes' TMA boxes
// 16-byte aligned); xq, w, sw and cb 16-byte aligned; out (M, N) bf16 or
// f32, (f32(sum) * sx[m]) * sw[n], or fma(f32(sum) * sx[m], sw[n], cb[n]).
extern "C" int aimet_q8_tile_gemm(const void* xq, const void* sx,
                                  const void* w, const void* sw,
                                  const void* cb, void* out, int M, int N,
                                  int K, int out_is_bf16, void* stream) {
  namespace wot = aimet::wot;
  constexpr int kKind = aimet::dec::kQ8;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (K % 16 || N % 16 || !aimet::aligned16(xq) || !aimet::aligned16(w) ||
      !aimet::aligned16(sw) || (cb != nullptr && !aimet::aligned16(cb)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  if (!aimet::encode_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, N,
                        wot::Stage<kKind>::kRows, 128) ||
      !aimet::encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, K,
                        wot::kBM, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* cbp = static_cast<const float*>(cb);
  return out_is_bf16
             ? wot::launch_tile<kKind, __nv_bfloat16, false>(
                   mx, mw, sxp, swp, cbp, static_cast<__nv_bfloat16*>(out),
                   M, N, K, K, 0, M, s)
             : wot::launch_tile<kKind, float, false>(
                   mx, mw, sxp, swp, cbp, static_cast<float*>(out), M, N, K,
                   K, 0, M, s);
}
