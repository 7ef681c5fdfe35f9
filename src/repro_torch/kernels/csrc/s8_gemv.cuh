// The int8 split-K GEMV and the K-major pre-pass for Hopper (sm_90a),
// shared by bitplane_matmul.cu, quant_matmul.cu and int4_matmul.cu.
//
// GEMV (M <= 16: decode-like rows).  The bound is reading the weight
// once.  One block of 8 warps owns a slab of 128 output columns and a
// slice of K (split-K: the wrappers' plan() fills one wave of 2 blocks
// per SM, the most its registers let an SM hold);
// x's slice sits in shared memory.  A weight loader W (below) hands each
// lane 16 columns of four k rows at a time, read in wide pieces along the
// weight's rows; they are byte-permuted (prmt) into the K-packed words of
// mma.sync m16n8k32 B fragments: lane (g, t) holds rows 4t..4t+3 and
// 16+4t..16+4t+3 of a 32-deep step, so product j's n8 column c is the
// lane group c's column j, and no shuffles are needed.  Warps reduce in
// shared memory; the caller then maps each partial to its global column
// and either adds it into an int32 output with atomicAdd (exact and
// independent of order) or, for an epilogue that must see the whole sum,
// adds it into a zeroed int32 scratch and lets the slab's last block to
// arrive apply the epilogue (finish()).
//
// A weight loader W provides
//   int lane_col(int slab, int g)   lane group g's first column, in W's
//                                   own units (bytes of a weight row)
//   uint4 load(int k, int col)      the raw words of row k there (zero
//                                   outside the matrix)
//   uint32_t word(uint4 r, int q)   word q of the lane's 16 columns as
//                                   signed int8 values: lane column 4q + b
//                                   in byte b
// and, for the pre-pass,
//   int8_t at(int k, int n)         logical column n at depth k.
//
// Pre-pass (M > 16).  int8 wgmma reads both operands K-major, so one
// launch writes the weight as a K-major (N, K') scratch (K' = K rounded up
// to 16, TMA's row stride) and, where x's rows are not 16-byte aligned
// (K % 16 or an unaligned base), re-pitches x into an (M, K') scratch with
// aligned 16-byte loads shifted into place; s8_wgmma.cuh's tile then reads
// both by TMA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s8gv {

constexpr int ROWS = 16;            // one m16 tile: M <= 16
constexpr int COLS = 128;           // output columns per block (a slab)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_STEPS = 64;       // k32 steps per split (x slice <= 33 KB)
constexpr int LDR = COLS + 4;       // row stride of the block's partial
constexpr int PRE_TILE = 64;        // weight tile of the pre-pass
constexpr int PRE_THREADS = 256;

// dynamic shared memory of a GEMV block: x's slice and the partial
inline size_t gemv_smem(int steps) {
  return ROWS * (steps * 32 + 16) + ROWS * LDR * 4;
}

// ---------------------------------------------------------------------------
// Weight loaders of int8 containers (bitplane_matmul.cu, quant_matmul.cu)
// ---------------------------------------------------------------------------

template <int NP>
__device__ __forceinline__ int8_t sign_extend_field(int8_t v) {
  // low NP bits of the container, read as an NP-bit two's-complement value
  const unsigned u = static_cast<unsigned>(static_cast<int>(v)) << (32 - NP);
  return static_cast<int8_t>(static_cast<int>(u) >> (32 - NP));
}

// the same on the four bytes of a word: (f ^ s) - s per byte, where f is
// the masked field and s its sign bit
template <int NP>
__device__ __forceinline__ uint32_t sign_extend_field4(uint32_t v) {
  if (NP == 8) return v;
  constexpr uint32_t MASK = ((1u << NP) - 1) * 0x01010101u;
  constexpr uint32_t SIGN = (1u << (NP - 1)) * 0x01010101u;
  return __vsub4((v & MASK) ^ SIGN, SIGN);
}

// BYTES (16 or 8) bytes of row k of a row-major (K, width) byte matrix
// from column c on, zero outside it, in the low words.  VEC is the widest
// load the rows allow (width % VEC == 0 and an aligned base): pieces of
// VEC bytes, the ones past the row's end left zero, or single bytes.
template <int BYTES, int VEC>
__device__ __forceinline__ uint4 load_row(const uint8_t* __restrict__ w,
                                          int k, int c, int K, int width) {
  uint32_t wd[4] = {0, 0, 0, 0};
  if (k >= K || c >= width) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = w + static_cast<size_t>(k) * width + c;
  if (VEC == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));  // width % 16 == 0
  } else if (VEC == 8) {
#pragma unroll
    for (int q = 0; q < BYTES / 8; ++q)
      if (q == 0 || c + 8 * q < width) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + 8 * q));
        wd[2 * q] = v.x;
        wd[2 * q + 1] = v.y;
      }
  } else if (VEC == 4) {
#pragma unroll
    for (int q = 0; q < BYTES / 4; ++q)
      if (q == 0 || c + 4 * q < width)
        wd[q] = __ldg(reinterpret_cast<const uint32_t*>(p + 4 * q));
  } else {
#pragma unroll
    for (int j = 0; j < BYTES; ++j)
      if (c + j < width)
        wd[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// the low NP-bit field of an int8 container w (K, N), sign-extended
template <int NP>
struct Field {
  const int8_t* __restrict__ w;
  int N;
  __device__ __forceinline__ int8_t at(int k, int n) const {
    return sign_extend_field<NP>(w[static_cast<size_t>(k) * N + n]);
  }
};

// the same for the GEMV: a lane's 16 columns are 16 bytes of a row
template <int NP, int VEC>
struct FieldRows {
  const uint8_t* __restrict__ w;
  int K, N;
  __device__ __forceinline__ int lane_col(int slab, int g) const {
    return slab * COLS + 16 * g;
  }
  __device__ __forceinline__ uint4 load(int k, int c) const {
    return load_row<16, VEC>(w, k, c, K, N);
  }
  __device__ __forceinline__ uint32_t word(const uint4& r, int q) const {
    return sign_extend_field4<NP>((&r.x)[q]);
  }
};

// ---------------------------------------------------------------------------
// GEMV core
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four k rows r[0..3] of the lane's 16 columns -> c[j]: the four k
// values of lane column j, lowest k in the lowest byte (an m16n8k32 B
// register)
template <class W>
__device__ __forceinline__ void pack_kpacked(uint32_t (&c)[16], const W& w,
                                             const uint4* r) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t r0 = w.word(r[0], q);
    const uint32_t r1 = w.word(r[1], q);
    const uint32_t r2 = w.word(r[2], q);
    const uint32_t r3 = w.word(r[3], q);
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    c[4 * q + 0] = __byte_perm(t0, t2, 0x5410);
    c[4 * q + 1] = __byte_perm(t0, t2, 0x7632);
    c[4 * q + 2] = __byte_perm(t1, t3, 0x5410);
    c[4 * q + 3] = __byte_perm(t1, t3, 0x7632);
  }
}

// 16 bytes of a row that start `off` bytes into the aligned 32-byte
// window {lo, hi}, bytes from `need` on zeroed (all of them when need <= 0)
__device__ __forceinline__ uint4 shifted16(uint4 lo, uint4 hi, int off,
                                           int need) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int wq = off >> 2, sh = 8 * (off & 3);
  uint32_t u[5];                    // words wq .. wq + 4 of the window
#pragma unroll
  for (int j = 0; j < 5; ++j)
    u[j] = wq == 0 ? w[j] : wq == 1 ? w[j + 1]
           : wq == 2 ? w[j + 2] : (j + 3 < 8 ? w[j + 3] : 0u);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int left = need - 4 * j;  // bytes of word j kept
    const uint32_t keep = left >= 4 ? 0xffffffffu
                          : left > 0 ? (1u << (8 * left)) - 1 : 0u;
    o[j] = __funnelshift_r(u[j], u[j + 1], sh) & keep;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// x rows [0, M), depth [kbase, kbase + kc) -> sx (row stride ldx), zero
// past M and K: 16-byte chunks read as the aligned bytes around them and
// shifted into place (shifted16).  The loads are unconditional (an
// out-of-range chunk reads x's first bytes and keeps none of them), so a
// thread's chunks are all in flight at once.
__device__ __forceinline__ void stage_x(int8_t* sx, int ldx,
                                        const int8_t* __restrict__ x, int M,
                                        int K, int kbase, int kc) {
  constexpr int BATCH = MAX_STEPS * 32 * ROWS / 16 / THREADS;
  const int per_row = kc / 16;      // chunks per row (kc is a multiple of 32)
  const int total = ROWS * per_row;
  uint4 lo[BATCH], hi[BATCH];
  int off[BATCH], need[BATCH];
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    const int r = idx / per_row, gk = kbase + 16 * (idx % per_row);
    need[u] = idx < total && r < M && gk < K ? min(K - gk, 16) : 0;
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        need[u] > 0 ? x + static_cast<size_t>(r) * K + gk : x);
    const uint4* p = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
    off[u] = static_cast<int>(a & 15);
    lo[u] = __ldg(p);
    hi[u] = __ldg(p + (off[u] + need[u] > 16 ? 1 : 0));
  }
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    if (idx < total)
      *reinterpret_cast<uint4*>(sx + (idx / per_row) * ldx +
                                16 * (idx % per_row)) =
          shifted16(lo[u], hi[u], off[u], need[u]);
  }
}

// where product j's n8 column c (lane group c's column j) is kept in the
// block's partial: column 16 (2t + h) + j at 8j + 4h + t, so the 32 lanes
// of one shared-memory atomicAdd hit 32 banks
__device__ __forceinline__ int red_index(int j, int c) {
  return 8 * j + 4 * (c & 1) + (c >> 1);
}

// The block's int32 partial over its K slice, grid (slabs, splits): split
// s covers k32 steps [s * steps, min((s + 1) * steps, ceil(K / 32))).
// Returns the partial in shared memory (ROWS x LDR ints, see red_index),
// complete for every thread.
template <class W>
__device__ __forceinline__ const int* gemv_partial(
    const W& w, const int8_t* __restrict__ x, int M, int K, int steps) {
  extern __shared__ __align__(16) uint8_t gv_smem[];
  const int ldx = steps * 32 + 16;  // x slice row stride: conflict-free
  int8_t* sx = reinterpret_cast<int8_t*>(gv_smem);
  int* red = reinterpret_cast<int*>(gv_smem + ROWS * ldx);

  const int total = (K + 31) / 32;
  const int step0 = blockIdx.y * steps;
  const int my_steps = min(steps, total - step0);
  const int kbase = step0 * 32;
  stage_x(sx, ldx, x, M, K, kbase, my_steps * 32);
  for (int i = threadIdx.x; i < ROWS * LDR; i += THREADS) red[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = w.lane_col(blockIdx.x, g);   // this lane's 16 columns
  int acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int st = warp; st < my_steps; st += WARPS) {
    const int k0 = kbase + st * 32;
    uint4 r[8];                     // rows 4t..4t+3, then 16+4t..16+4t+3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = w.load(k0 + 4 * t + i, col);
      r[4 + i] = w.load(k0 + 16 + 4 * t + i, col);
    }
    uint32_t b0[16], b1[16];
    pack_kpacked(b0, w, r);
    pack_kpacked(b1, w, r + 4);
    const int8_t* xa = sx + g * ldx + st * 32 + 4 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(xa);
    a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * ldx);
    a[2] = *reinterpret_cast<const uint32_t*>(xa + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * ldx + 16);
#pragma unroll
    for (int j = 0; j < 16; ++j) mma_s8(acc[j], a, b0[j], b1[j]);
  }

  // c0, c1 of product j sit at row g, c2, c3 at row g + 8, n8 columns
  // 2t and 2t + 1
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1);
      if (row < M && acc[j][e] != 0)
        atomicAdd(&red[row * LDR + red_index(j, 2 * t + (e & 1))],
                  acc[j][e]);
    }
  __syncthreads();
  return red;
}

// The block's partial added into part (M, N) with integer atomics.
// cols(L, gn, idx) maps the slab's column L (0 .. COLS - 1) to its global
// column gn (negative past the matrix) and its index in the partial.
template <class Cols>
__device__ __forceinline__ void add_partial(const int* red, int M, int N,
                                            int* __restrict__ part,
                                            Cols cols) {
  for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
    const int r = i / COLS;
    int gn, idx;
    cols(i % COLS, gn, idx);
    const int v = red[r * LDR + idx];
    if (gn >= 0 && v != 0)
      atomicAdd(&part[static_cast<size_t>(r) * N + gn], v);
  }
}

// True in the block that arrives last at its slab's counter, after every
// other block of the slab has added its partial (a __threadfence before
// the arrival publishes this block's atomics, one after it orders the
// last block's reads behind everyone's)
__device__ __forceinline__ bool last_arrival(unsigned* counter,
                                             unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The slab's whole int32 sums through epi(row, gn, v): straight from the
// block's partial when K is not split (gridDim.y == 1); otherwise the
// partial goes by atomicAdd into the zeroed scratch `part` (M, N), and the
// slab's last block to arrive at counters[blockIdx.x] (zeroed) reads the
// sums back from L2, all of a thread's before it uses the first.
template <class Cols, class Epi>
__device__ __forceinline__ void finish(const int* red, int M, int N,
                                       int* __restrict__ part,
                                       unsigned* counters, Cols cols,
                                       Epi epi) {
  const bool split = gridDim.y > 1;
  if (split) {
    add_partial(red, M, N, part, cols);
    if (!last_arrival(counters + blockIdx.x, gridDim.y)) return;
  }
  constexpr int PER = ROWS * COLS / THREADS;
  int v[PER], gn[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / COLS;
    int idx;
    cols(i % COLS, gn[u], idx);
    if (r >= M) gn[u] = -1;
    v[u] = gn[u] < 0 ? 0
           : split ? __ldcg(&part[static_cast<size_t>(r) * N + gn[u]])
                   : red[r * LDR + idx];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (gn[u] >= 0) epi((threadIdx.x + u * THREADS) / COLS, gn[u], v[u]);
}

// Host side of a split GEMV whose epilogue needs the whole sum: the
// scratch holds the int32 partial (M, N), then one arrival counter per
// slab; both are zeroed on `stream`.  Unsplit, nothing is needed.
inline cudaError_t split_scratch(void* scratch, int M, int N, int slabs,
                                 int splits, cudaStream_t stream, int** part,
                                 unsigned** counters) {
  *part = nullptr;
  *counters = nullptr;
  if (splits == 1) return cudaSuccess;
  const size_t part_bytes = static_cast<size_t>(M) * N * 4;
  *part = static_cast<int*>(scratch);
  *counters = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                          part_bytes);
  return cudaMemsetAsync(scratch, 0, part_bytes + 4 * slabs, stream);
}

// the GEMV's slab columns for an (M, N) output whose slab holds 128
// consecutive columns: L = 16c + j is lane group c's column j
struct SlabCols {
  int n0, N;
  __device__ __forceinline__ void operator()(int L, int& gn,
                                             int& idx) const {
    gn = n0 + L < N ? n0 + L : -1;
    idx = red_index(L & 15, L >> 4);
  }
};

// ---------------------------------------------------------------------------
// Pre-pass
// ---------------------------------------------------------------------------

// One launch before the GEMM.  Blocks [0, w_blocks) write
// wt[n][k] = w.at(k, n) in 64 x 64 tiles (columns K..K'-1 are never read:
// the tensor map's K bound zero-fills them).  With xp, the blocks after
// them re-pitch x (M, K) into xp (M, K'), one 16-byte chunk a thread, read
// as the aligned 16 or 32 bytes around it and shifted into place.
template <class W>
__device__ __forceinline__ void prepass(const W& w, int8_t* __restrict__ wt,
                                        const int8_t* __restrict__ x,
                                        int8_t* __restrict__ xp, int M,
                                        int N, int K, int Kp, int w_blocks) {
  if (static_cast<int>(blockIdx.x) < w_blocks) {
    __shared__ int8_t tile[PRE_TILE][PRE_TILE + 1];   // [k][n]
    const int tiles_k = (K + PRE_TILE - 1) / PRE_TILE;
    const int k0 = (blockIdx.x % tiles_k) * PRE_TILE;
    const int n0 = (blockIdx.x / tiles_k) * PRE_TILE;
    for (int i = threadIdx.x; i < PRE_TILE * PRE_TILE; i += PRE_THREADS) {
      const int kr = i / PRE_TILE, nc = i % PRE_TILE;
      const int gk = k0 + kr, gn = n0 + nc;
      tile[kr][nc] = (gk < K && gn < N) ? w.at(gk, gn) : int8_t(0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < PRE_TILE * PRE_TILE; i += PRE_THREADS) {
      const int nr = i / PRE_TILE, kc = i % PRE_TILE;
      const int gn = n0 + nr, gk = k0 + kc;
      if (gn < N && gk < K)
        wt[static_cast<size_t>(gn) * Kp + gk] = tile[kc][nr];
    }
    return;
  }
  const int per_row = Kp / 16;
  const size_t chunk =
      static_cast<size_t>(blockIdx.x - w_blocks) * PRE_THREADS + threadIdx.x;
  if (chunk >= static_cast<size_t>(M) * per_row) return;
  const int r = static_cast<int>(chunk / per_row);
  const int gk = 16 * static_cast<int>(chunk % per_row);
  const int need = K - gk < 16 ? K - gk : 16;      // >= 1: K' < K + 16
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(x + static_cast<size_t>(r) * K + gk);
  const uint4* p = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int off = static_cast<int>(a & 15);
  // the next 16 bytes only if a needed byte lies in them
  const uint4 lo = __ldg(p);
  const uint4 hi = off + need > 16 ? __ldg(p + 1) : lo;
  *reinterpret_cast<uint4*>(xp + static_cast<size_t>(r) * Kp + gk) =
      shifted16(lo, hi, off, need);
}

// The pre-pass's grid: w_blocks weight tiles, then (copy_x) x's chunks.
// Returns 0 when the grid is too large to launch.
inline unsigned prepass_blocks(int M, int N, int K, int Kp, bool copy_x,
                               int* w_blocks) {
  *w_blocks = ((K + PRE_TILE - 1) / PRE_TILE) *
              ((N + PRE_TILE - 1) / PRE_TILE);
  const size_t x_chunks = copy_x ? static_cast<size_t>(M) * (Kp / 16) : 0;
  const size_t blocks =
      *w_blocks + (x_chunks + PRE_THREADS - 1) / PRE_THREADS;
  return blocks > 2147483647u ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace s8gv
