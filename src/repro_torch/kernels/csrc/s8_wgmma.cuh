// The int8 wgmma GEMM tile for Hopper (sm_90a), used by the large-M
// regime of bitplane_matmul.cu, quant_matmul.cu and int4_matmul.cu.
//
// One block computes 128 x 128 int32 tiles of x (M, K) @ w^T, where w is
// given K-MAJOR, as an (N, K') row-major array: int8 wgmma reads both of
// its operands K-major (the transpose bit exists only for 16-bit types).
// Three warpgroups: two consumers of 64 rows each run wgmma m64n128k32
// s8 -> s32 out of shared memory; in the third, one producer thread
// fills a ring of STAGES slots of 128-deep x and w tiles by TMA under
// full / empty mbarriers, and setmaxnreg moves the producer's registers
// to the consumers (40 / 232 a thread).  Both operands arrive by TMA, so
// their rows must be 16-byte aligned (the caller re-pitches an x whose
// rows are not).  Out-of-range rows and depths load as zero.  The grid is
// persistent (at most one block per SM, each walking output tiles
// gridDim.x apart), and the ring runs on from one tile to the next, so
// the next tile's loads overlap this tile's epilogue.  Tiles are taken
// grouped by 8 row tiles, so the tiles in flight share their x rows and
// w columns in L2.  The epilogue is the caller's: it receives each
// consumer thread's accumulator registers, and store_tile() writes them
// through shared memory as f(column, acc) in the output's type.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace s8wg {

using namespace hopper;

constexpr int BM = 128;             // rows of x per block
constexpr int BN = 128;             // columns of the output per block
constexpr int BK = 128;             // depth per stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;      // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr int GROUP_M = 8;          // row tiles per raster group
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_OFF = STAGES * STAGE_BYTES;   // epilogue scratch
constexpr int LDO = BN + 8;         // int32 staging row stride (words)
constexpr int EPI_BYTES = BM * LDO * 4;
constexpr int BAR_OFF = EPI_OFF + EPI_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// x's rows can be read by TMA in place (16-byte aligned)
inline bool tma_x_ok(const void* x, int K) {
  return (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
}

__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// output tile `tile`'s origin, row tiles grouped GROUP_M at a time
__device__ __forceinline__ void tile_origin(int tile, int M, int N, int& m0,
                                            int& n0) {
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int group = tile / per_group;
  const int first_m = group * GROUP_M;
  const int size_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % size_m) * BM;
  n0 = (in_group / size_m) * BN;
}

// The block's output tiles: blockIdx.x, + gridDim.x, ... (a persistent
// grid of at most one block per SM).  map_x reads x (M, K), dims {K, M};
// map_w the K-major weight (N, K'), dims {K, N}.  The ring runs on across
// tiles, so the producer loads the next tile while the consumers finish
// this one; each consumer thread ends a tile by calling
// epi(acc, wg, m0, n0).
template <class Epi>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap* map_x,
                                           const CUtensorMap* map_w, int M,
                                           int N, int K, Epi epi) {
  uint8_t* smem = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);         // the producer's arrive.expect_tx
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA copy
    regs_dealloc<40>();
    if (threadIdx.x != CONSUMERS) return;
    int it = 0;                       // k-tiles loaded by this block
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, M, N, m0, n0);
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, map_x, &full[s], kt * BK, m0);
        tma_load_2d(st + A_BYTES, map_w, &full[s], kt * BK, n0);
      }
    }
  } else {
    // ---- consumer warpgroups
    regs_alloc<232>();
    const int wg = threadIdx.x >> 7;
    // this warpgroup's x rows and the w tile, in slot 0
    const uint64_t da = desc_sw128(smem + wg * 64 * 128, 16, 1024);
    const uint64_t db = desc_sw128(smem + A_BYTES, 16, 1024);
    int it = 0;                       // k-tiles consumed by this block
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, M, N, m0, n0);
      int acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8(acc, desc_add(da, s * STAGE_BYTES + kk * 32),
                   desc_add(db, s * STAGE_BYTES + kk * 32), 1);
        wgmma_commit();
        wgmma_wait<1>();              // the previous stage's products done
        fence_regs(acc);
        if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);   // the tile's last stage
      epi(acc, wg, m0, n0);
    }
  }
}

__device__ __forceinline__ void put1(int32_t* o, int v) { *o = v; }
__device__ __forceinline__ void put1(float* o, float v) { *o = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put4(int32_t* o, int a, int b, int c, int d) {
  *reinterpret_cast<int4*>(o) = make_int4(a, b, c, d);
}
__device__ __forceinline__ void put4(float* o, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(__nv_bfloat16* o, float a, float b,
                                     float c, float d) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(a, b),
                               __floats2bfloat162_rn(c, d)};
  *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(h);
}

// Epilogue: the warpgroup's 64 x 128 int32 tile through shared memory,
// then out rows as f(column, acc), four columns a thread: one 16-byte
// (int32, f32) or 8-byte (bf16, rounded to nearest even) store where
// N % 4 == 0, element by element at the ragged column edge or elsewhere.
// The int32 tile never reaches device memory unless OutT is int32_t.
template <class OutT, class F>
__device__ __forceinline__ void store_tile(const int (&acc)[64], int wg,
                                           int m0, int n0,
                                           OutT* __restrict__ out, int M,
                                           int N, F f) {
  int32_t* so = reinterpret_cast<int32_t*>(smem_base() + EPI_OFF) +
                wg * 64 * LDO;
  const int ct = threadIdx.x & 127;
  const int warp = ct >> 5;
  const int g = (ct & 31) >> 2;
  const int t = ct & 3;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t;
    *reinterpret_cast<int2*>(so + row * LDO + col) =
        make_int2(acc[i], acc[i + 1]);
  }
  named_sync(1 + wg, 128);
  const bool vec = (N % 4) == 0;
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int idx = ct + 128 * it;
    const int r = idx >> 5;
    const int c = (idx & 31) * 4;
    const int gm = m0 + wg * 64 + r;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const int4 v = *reinterpret_cast<const int4*>(so + r * LDO + c);
    OutT* o = out + static_cast<size_t>(gm) * N + gn;
    if (vec && gn + 3 < N) {
      put4(o, f(gn, v.x), f(gn + 1, v.y), f(gn + 2, v.z), f(gn + 3, v.w));
    } else {
      put1(o, f(gn, v.x));
      if (gn + 1 < N) put1(o + 1, f(gn + 1, v.y));
      if (gn + 2 < N) put1(o + 2, f(gn + 2, v.z));
      if (gn + 3 < N) put1(o + 3, f(gn + 3, v.w));
    }
  }
  named_sync(1 + wg, 128);            // staging free for the next tile
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Raise `kernel`'s dynamic shared memory limit to SMEM_BYTES, once: the
// caller keeps `done`, one per kernel instantiation.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  done = e == cudaSuccess;
  return e;
}

// the persistent grid for an (M, N) output: one block per tile, at most
// one per SM
inline int grid_blocks(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return tiles < sms ? tiles : sms;
}

// The tensor maps of one large-M GEMM: x (M, K) with row stride K (or its
// re-pitched copy xp with stride Kp), and the K-major weight wt (N, Kp).
inline bool make_maps(CUtensorMap* map_x, CUtensorMap* map_w, const void* x,
                      const int8_t* xp, const int8_t* wt, int M, int N,
                      int K, int Kp) {
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims_w[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(N)};
  const cuuint64_t stride_w[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box_w[2] = {BK, BN};
  const cuuint64_t dims_x[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t stride_x[1] = {static_cast<cuuint64_t>(xp ? Kp : K)};
  const cuuint32_t box_x[2] = {BK, BM};
  return make_map(map_w, u8, 2, wt, dims_w, stride_w, box_w) &&
         make_map(map_x, u8, 2, xp ? static_cast<const void*>(xp) : x,
                  dims_x, stride_x, box_x);
}

}  // namespace s8wg
