// Bit-plane int8 GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bitplane_matmul.py
// (`bitplane_matmul`, pallas_call at line 86): int8 x (M, K) times the low
// `n_planes` two's-complement field of an int8 weight container w (K, N),
// accumulated exactly in int32 -> out (M, N).  The TPU kernel walks the
// weight's bit planes (one MXU dot per plane); the sum of weighted planes
// is identically one dot with the sign-extended field, so here every
// weight is sign-extended once and one int8 product runs.  `n_planes` is
// a template parameter over 1..8: a runtime bit value never specialises
// the code, only the static family.
//
// Two regimes, both this file's own code.  The wrapper's plan()
// (kernels/bitplane_matmul.py) picks one from (M, K, N) and x's
// alignment, and sizes the split and the scratch; this entry launches the
// plan it is given and refuses one the kernels cannot run.
//
// * Large M (M > 16: every CNN conv, M = 784 .. 200704, and the LM
//   prefill at M = 16384).  The bound is int8 operations for the LM
//   shapes (0.41 ms at 1979 TOPS for (16384, 2560, 9728)) and bytes for
//   the CNN shapes, where writing the int32 output is the largest term.
//   int8 wgmma takes both operands K-major, and w is N-major, so a
//   pre-pass (prepass_kernel) writes the sign-extended field once as a
//   K-major (N, K') scratch, K' = K rounded up to 16 (TMA's row stride);
//   the wrapper allocates it per call, nothing is cached, and its time
//   is part of the kernel's.  TMA also needs x's rows 16-byte aligned;
//   ResNet18 conv1 (K = 147) and AlexNet conv1 (K = 363) are not, so in
//   the same launch the pre-pass re-pitches such an x into an (M, K')
//   scratch with aligned 16-byte loads shifted into place.  (Copying x
//   into shared memory in the GEMM's producer warpgroup instead was
//   tried first and was about 2 x slower at conv1: one warpgroup cannot
//   keep enough loads in flight.)  The main kernel is s8_wgmma.cuh: a
//   persistent grid over 128 x 128 tiles, two consumer warpgroups on
//   wgmma m64n128k32 s8, a 4-stage TMA ring fed by one producer thread
//   that runs on into the next tile, and the int32 tile written through
//   shared memory as coalesced 16-byte rows.
// * Small M (M <= 16: the LM decode at M = 4, AlexNet fc6-fc8 and
//   ResNet18's fc at M = 16).  These are GEMVs: the bound is reading w
//   once (e.g. 25 MB for (4, 9728, 2560): 7.4 us at 3.35 TB/s).  One
//   block of 8 warps owns 128 output columns and a slice of K (split-K:
//   the plan gives about 2 x 132 blocks); x's slice sits in shared
//   memory.  Each lane reads 16-byte pieces of w along N (8-byte or
//   1-byte pieces when N's rows are not 16-byte aligned), sign-extends
//   the field four bytes at a time, and byte-permutes (prmt) four k rows
//   into the K-packed words of mma.sync m16n8k32 B fragments: lane
//   (g, t) loads rows 4t..4t+3 and 16+4t..16+4t+3 of a 32-deep step at
//   columns 16g..16g+15, so the 16 products it joins each cover the
//   columns {16g' + j}.  Warps reduce in shared memory; blocks add their
//   int32 partials into the zeroed output with atomicAdd, exact and
//   independent of order, so the result equals the plain version.  (A
//   fix-up in which the last block of a slab sums the partials was tried
//   instead of the atomics and ran slower.)  The threshold is one m16
//   tile of rows, and at a decode shape (M = 16 against 17, K = 2560,
//   N = 9728) the GEMV takes about a quarter of the large-M path's device
//   time (chip_smoke.py prints both).
//
// Ragged M, K and N are masked in both regimes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_wgmma.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// Large M: pre-pass and wgmma GEMM
// ---------------------------------------------------------------------------

constexpr int PRE_TILE = 64;        // w tile of the pre-pass
constexpr int PRE_THREADS = 256;

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

// The pre-pass, one launch before the GEMM.  Blocks [0, w_blocks) write
// wt[n][k] = field(w[k][n]) in 64 x 64 tiles (columns K..K'-1 are never
// read: the tensor map's K bound zero-fills them).  With copy_x, the
// blocks after them re-pitch x (M, K) into xp (M, K'), one 16-byte chunk
// a thread, read as the aligned 16 or 32 bytes around it and shifted
// into place.
template <int NP>
__global__ void __launch_bounds__(PRE_THREADS)
prepass_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
               const int8_t* __restrict__ x, int8_t* __restrict__ xp, int M,
               int N, int K, int Kp, int w_blocks) {
  if (static_cast<int>(blockIdx.x) < w_blocks) {
    __shared__ int8_t tile[PRE_TILE][PRE_TILE + 1];   // [k][n]
    const int tiles_k = (K + PRE_TILE - 1) / PRE_TILE;
    const int k0 = (blockIdx.x % tiles_k) * PRE_TILE;
    const int n0 = (blockIdx.x / tiles_k) * PRE_TILE;
    for (int i = threadIdx.x; i < PRE_TILE * PRE_TILE; i += PRE_THREADS) {
      const int kr = i / PRE_TILE, nc = i % PRE_TILE;
      const int gk = k0 + kr, gn = n0 + nc;
      tile[kr][nc] = (gk < K && gn < N)
          ? sign_extend_field<NP>(w[static_cast<size_t>(gk) * N + gn])
          : int8_t(0);
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

__global__ void __launch_bounds__(s8wg::THREADS, 1)
bitplane_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      int32_t* __restrict__ out, int M, int N, int K) {
  s8wg::gemm_tiles(&map_x, &map_w, M, N, K,
                   [&](const int (&acc)[64], int wg, int m0, int n0) {
                     s8wg::store_tile_s32(acc, wg, m0, n0, out, M, N);
                   });
}

int launch_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_w,
                 int32_t* out, int M, int N, int K, cudaStream_t stream) {
  static int sms = 0;                 // persistent grid: one block per SM
  if (sms == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        bitplane_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        s8wg::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int tiles = ((M + s8wg::BM - 1) / s8wg::BM) *
                    ((N + s8wg::BN - 1) / s8wg::BN);
  const int blocks = tiles < sms ? tiles : sms;
  bitplane_wgmma_kernel<<<blocks, s8wg::THREADS, s8wg::SMEM_BYTES, stream>>>(
      map_x, map_w, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Small M: split-K GEMV on mma.sync
// ---------------------------------------------------------------------------

constexpr int GV_ROWS = 16;         // one m16 tile: M <= 16
constexpr int GV_COLS = 128;        // output columns per block
constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_MAX_STEPS = 64;    // k32 steps per split (x slice <= 33 KB)
constexpr int GV_LDR = GV_COLS + 4; // row stride of the block's partial

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[k][n .. n + 15] as four words (zero outside the matrix).  VEC is the
// widest load the row layout allows: 16 (N % 16 == 0 and an aligned
// base), 8 (N % 8 == 0), else 1.
template <int VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w,
                                          int k, int n, int K, int N) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (k >= K || n >= N) return v;
  const int8_t* p = w + static_cast<size_t>(k) * N + n;
  if (VEC == 16) {
    v = __ldg(reinterpret_cast<const uint4*>(p));   // N % 16 == 0: whole
  } else if (VEC == 8) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    uint2 hi = make_uint2(0, 0);
    if (n + 8 < N) hi = __ldg(reinterpret_cast<const uint2*>(p + 8));
    v = make_uint4(lo.x, lo.y, hi.x, hi.y);
  } else {
    uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (n + j < N)
        wd[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                      << (8 * (j & 3));
    v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
  return v;
}

// rows k .. k + 3 at columns n .. n + 15 -> c[j]: the four k values of
// column n + j, lowest k in the lowest byte (an m16n8k32 B register)
template <int NP, int VEC>
__device__ __forceinline__ void load_kpacked(uint32_t (&c)[16],
                                             const int8_t* __restrict__ w,
                                             int k, int n, int K, int N) {
  uint4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = load_w16<VEC>(w, k + i, n, K, N);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t r0 = sign_extend_field4<NP>((&r[0].x)[q]);
    const uint32_t r1 = sign_extend_field4<NP>((&r[1].x)[q]);
    const uint32_t r2 = sign_extend_field4<NP>((&r[2].x)[q]);
    const uint32_t r3 = sign_extend_field4<NP>((&r[3].x)[q]);
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

// x rows [0, M), depth [kbase, kbase + kc) -> sx (row stride ldx), zero
// past M and K: 16-byte chunks read as the aligned bytes around them and
// shifted into place (shifted16).  The loads are unconditional (an
// out-of-range chunk reads x's first bytes and keeps none of them), so a
// thread's chunks are all in flight at once.
__device__ __forceinline__ void stage_x(int8_t* sx, int ldx,
                                        const int8_t* __restrict__ x, int M,
                                        int K, int kbase, int kc) {
  constexpr int BATCH = GV_MAX_STEPS * 32 * GV_ROWS / 16 / GV_THREADS;
  const int per_row = kc / 16;      // chunks per row (kc is a multiple of 32)
  const int total = GV_ROWS * per_row;
  uint4 lo[BATCH], hi[BATCH];
  int off[BATCH], need[BATCH];
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int idx = threadIdx.x + u * GV_THREADS;
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
    const int idx = threadIdx.x + u * GV_THREADS;
    if (idx < total)
      *reinterpret_cast<uint4*>(sx + (idx / per_row) * ldx +
                                16 * (idx % per_row)) =
          shifted16(lo[u], hi[u], off[u], need[u]);
  }
}

// grid (ceil(N / 128), splits); split s covers k32 steps
// [s * steps, min((s + 1) * steps, ceil(K / 32))).  out must be zeroed:
// each block adds its int32 partial with atomicAdd.
template <int NP, int VEC>
__global__ void __launch_bounds__(GV_THREADS)
bitplane_gemv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     int M, int N, int K, int steps) {
  extern __shared__ __align__(16) uint8_t gv_smem[];
  const int ldx = steps * 32 + 16;  // x slice row stride: conflict-free
  int8_t* sx = reinterpret_cast<int8_t*>(gv_smem);
  int* red = reinterpret_cast<int*>(gv_smem + GV_ROWS * ldx);

  const int n0 = blockIdx.x * GV_COLS;
  const int total = (K + 31) / 32;
  const int step0 = blockIdx.y * steps;
  const int my_steps = min(steps, total - step0);
  const int kbase = step0 * 32;
  stage_x(sx, ldx, x, M, K, kbase, my_steps * 32);
  for (int i = threadIdx.x; i < GV_ROWS * GV_LDR; i += GV_THREADS) red[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ncol = n0 + 16 * g;     // this lane's 16 weight columns
  int acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int st = warp; st < my_steps; st += GV_WARPS) {
    const int k0 = kbase + st * 32;
    uint32_t b0[16], b1[16];
    load_kpacked<NP, VEC>(b0, w, k0 + 4 * t, ncol, K, N);
    load_kpacked<NP, VEC>(b1, w, k0 + 16 + 4 * t, ncol, K, N);
    const int8_t* xa = sx + g * ldx + st * 32 + 4 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(xa);
    a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * ldx);
    a[2] = *reinterpret_cast<const uint32_t*>(xa + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * ldx + 16);
#pragma unroll
    for (int j = 0; j < 16; ++j) mma_s8(acc[j], a, b0[j], b1[j]);
  }

  // product j's column c of its n8 block is weight column n0 + 16c + j;
  // c0, c1 sit at row g, c2, c3 at row g + 8.  Column 16 (2t + h) + j of
  // a row is kept at red[row * GV_LDR + 8j + 4h + t], so the 32 lanes of
  // one atomicAdd hit 32 banks.
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1);
      if (row < M && acc[j][e] != 0)
        atomicAdd(&red[row * GV_LDR + 8 * j + 4 * (e & 1) + t], acc[j][e]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < M * GV_COLS; i += GV_THREADS) {
    const int r = i / GV_COLS, c = i % GV_COLS;
    const int gn = n0 + c;
    const int v = red[r * GV_LDR + 8 * (c & 15) + 4 * ((c >> 4) & 1) + (c >> 5)];
    if (gn < N && v != 0)
      atomicAdd(&out[static_cast<size_t>(r) * N + gn], v);
  }
}

template <int NP>
int launch_gemv(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
                int K, int steps, cudaStream_t stream) {
  const int total = (K + 31) / 32;
  const int splits = (total + steps - 1) / steps;
  const dim3 grid((N + GV_COLS - 1) / GV_COLS, splits);
  const size_t smem = GV_ROWS * (steps * 32 + 16) + GV_ROWS * GV_LDR * 4;
  cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * 4,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (N % 16 == 0 && wa % 16 == 0)
    bitplane_gemv_kernel<NP, 16><<<grid, GV_THREADS, smem, stream>>>(
        x, w, out, M, N, K, steps);
  else if (N % 8 == 0 && wa % 8 == 0)
    bitplane_gemv_kernel<NP, 8><<<grid, GV_THREADS, smem, stream>>>(
        x, w, out, M, N, K, steps);
  else
    bitplane_gemv_kernel<NP, 1><<<grid, GV_THREADS, smem, stream>>>(
        x, w, out, M, N, K, steps);
  return static_cast<int>(cudaGetLastError());
}

// scratch: the K-major field wt (N, K'), then (copy_x) xp (M, K')
template <int NP>
int launch_large(const int8_t* x, const int8_t* w, int32_t* out,
                 int8_t* scratch, int M, int N, int K, bool copy_x,
                 cudaStream_t stream) {
  using namespace s8wg;
  const int Kp = (K + 15) / 16 * 16;
  int8_t* wt = scratch;
  int8_t* xp = copy_x ? scratch + static_cast<size_t>(N) * Kp : nullptr;
  const int w_blocks = ((K + PRE_TILE - 1) / PRE_TILE) *
                       ((N + PRE_TILE - 1) / PRE_TILE);
  const size_t x_chunks = copy_x ? static_cast<size_t>(M) * (Kp / 16) : 0;
  const size_t blocks = w_blocks + (x_chunks + PRE_THREADS - 1) / PRE_THREADS;
  if (blocks > 2147483647u) return static_cast<int>(cudaErrorInvalidValue);
  prepass_kernel<NP><<<static_cast<unsigned>(blocks), PRE_THREADS, 0,
                       stream>>>(w, wt, x, xp, M, N, K, Kp, w_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap map_x, map_w;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims_w[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(N)};
  const cuuint64_t stride_w[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box_w[2] = {BK, BN};
  const cuuint64_t dims_x[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t stride_x[1] = {static_cast<cuuint64_t>(copy_x ? Kp : K)};
  const cuuint32_t box_x[2] = {BK, BM};
  if (!make_map(&map_w, u8, 2, wt, dims_w, stride_w, box_w) ||
      !make_map(&map_x, u8, 2, copy_x ? xp : x, dims_x, stride_x, box_x))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma(map_x, map_w, out, M, N, K, stream);
}

template <int NP>
int run(const int8_t* x, const int8_t* w, int32_t* out, int8_t* scratch,
        int M, int N, int K, int gemv_steps, bool copy_x,
        cudaStream_t stream) {
  if (gemv_steps > 0)
    return launch_gemv<NP>(x, w, out, M, N, K, gemv_steps, stream);
  return launch_large<NP>(x, w, out, scratch, M, N, K, copy_x, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  gemv_steps > 0 runs the
// small-M regime with that many k32 steps per split (M <= 16); 0 runs the
// large-M regime, with `scratch` (16-byte aligned) holding the K-major
// field (N, K') and, with copy_x, x re-pitched to (M, K'), K' = K rounded
// up to 16.  Without copy_x, x's rows must be 16-byte aligned (TMA).
// Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan the kernels do not take; the Python
// wrapper raises on anything but 0.
extern "C" int bitplane_matmul_s8(const void* x, const void* w, void* out,
                                  void* scratch, int M, int N, int K,
                                  int n_planes, int gemv_steps, int copy_x,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || n_planes < 1 || n_planes > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (gemv_steps > 0) {
    if (M > GV_ROWS || gemv_steps > GV_MAX_STEPS ||
        ((K + 31) / 32 + gemv_steps - 1) / gemv_steps > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (scratch == nullptr ||
             reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
             (!copy_x && !s8wg::tma_x_ok(x, K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  int8_t* sp = static_cast<int8_t*>(scratch);
  const bool cx = copy_x != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1: return run<1>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    case 2: return run<2>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    case 3: return run<3>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    case 4: return run<4>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    case 5: return run<5>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    case 6: return run<6>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    case 7: return run<7>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
    default: return run<8>(xp, wp, op, sp, M, N, K, gemv_steps, cx, s);
  }
}
