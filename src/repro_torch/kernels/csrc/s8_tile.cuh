// The mma.sync int8 tensor-core tile shared by int4_matmul.cu and
// quant_matmul.cu (the bit-plane kernel has its own wgmma tile,
// s8_wgmma.cuh, and GEMV).
//
// One block computes a 128 x 64 int32 tile of x (M, K) @ w (K, N): eight
// warps, 4 along M x 2 along N, each a 32 x 32 sub-tile of mma.sync
// m16n8k32 s8 -> s32 products.  x tiles are copied into shared memory
// row-major (16-byte vector loads when K is a multiple of 16 and x is
// 16-byte aligned); w tiles are copied transposed, sB[n][k], by a loader
// each kernel supplies, which is where the kernels differ (unpacking a
// nibble, or plain int8).  Out-of-range tile elements load as zero.
// Single-buffered: a simple tile that is right.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s8tile {

constexpr int BM = 128;             // rows of x per block
constexpr int BN = 64;              // columns of w per block
constexpr int BK = 64;              // depth per shared-memory stage
constexpr int LDS = BK + 16;        // padded row stride: conflict-free frags
constexpr int THREADS = 256;        // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;              // rows per warp
constexpr int WN = 32;              // columns per warp

using Acc = int[2][4][4];           // a warp's 32 x 32 accumulator fragments

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte x loads need K % 16 == 0 and a 16-byte-aligned base pointer
inline bool vec_x_ok(const void* x, int K) {
  return (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
}

// x tile rows [m0, m0 + BM), depth [k0, k0 + BK) -> sA[m][k]
template <bool VEC_X>
__device__ __forceinline__ void load_x_tile(int8_t* sA,
                                            const int8_t* __restrict__ x,
                                            int M, int K, int m0, int k0) {
  const int tid = threadIdx.x;
  if (VEC_X) {
#pragma unroll
    for (int it = 0; it < (BM * BK / 16) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx / (BK / 16);
      const int c = (idx % (BK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + c;
      int4 v = make_int4(0, 0, 0, 0);
      if (gm < M && gk < K)
        v = *reinterpret_cast<const int4*>(x + (size_t)gm * K + gk);
      *reinterpret_cast<int4*>(sA + r * LDS + c) = v;
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < (BM * BK) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx / BK;
      const int c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      sA[r * LDS + c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0;
    }
  }
}

// The block's whole K loop.  load_b(sB, k0) fills sB[n][k] for depth
// [k0, k0 + BK); the warp's fragments accumulate into acc.
template <bool VEC_X, class LoadB>
__device__ __forceinline__ void gemm_tile(Acc& acc, int8_t* sA, int8_t* sB,
                                          const int8_t* __restrict__ x,
                                          int M, int K, int m0,
                                          LoadB load_b) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // groupID
  const int t = lane & 3;           // threadID_in_group
  const int wm = (warp >> 1) * WM;  // warp's row offset in the tile
  const int wn = (warp & 1) * WN;   // warp's column offset in the tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_x_tile<VEC_X>(sA, x, M, K, m0, k0);
    load_b(sB, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = sA + (wm + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sB + (wn + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
}

// Visit the thread's accumulator pairs: store(row, nc, v0, v1) receives
// the tile-local column nc (even; v1 belongs to nc + 1) and the global
// row, which the caller still bounds by M.  c0,c1 sit at row g, c2,c3 at
// row g + 8 of each 16 x 8 fragment.
template <class Store>
__device__ __forceinline__ void for_each_pair(const Acc& acc, int m0,
                                              Store store) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * WM;
  const int wn = (warp & 1) * WN;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(m0 + wm + i * 16 + g + h * 8, wn + j * 8 + t * 2,
              acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

}  // namespace s8tile
