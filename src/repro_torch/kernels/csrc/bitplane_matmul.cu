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
//   scratch with aligned 16-byte loads shifted into place (s8_gemv.cuh's
//   prepass, shared with quant_matmul.cu and int4_matmul.cu).  (Copying x
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
//   the plan fills one wave of 2 blocks per SM); x's slice sits in shared
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

#include "s8_gemv.cuh"
#include "s8_wgmma.cuh"

namespace {

using s8gv::Field;
using s8gv::FieldRows;

// ---------------------------------------------------------------------------
// Large M: pre-pass and wgmma GEMM
// ---------------------------------------------------------------------------

template <int NP>
__global__ void __launch_bounds__(s8gv::PRE_THREADS)
bitplane_prepass_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                        const int8_t* __restrict__ x, int8_t* __restrict__ xp,
                        int M, int N, int K, int Kp, int w_blocks) {
  s8gv::prepass(Field<NP>{w, N}, wt, x, xp, M, N, K, Kp, w_blocks);
}

__global__ void __launch_bounds__(s8wg::THREADS, 1)
bitplane_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      int32_t* __restrict__ out, int M, int N, int K) {
  s8wg::gemm_tiles(&map_x, &map_w, M, N, K,
                   [&](const int (&acc)[64], int wg, int m0, int n0) {
                     s8wg::store_tile(acc, wg, m0, n0, out, M, N,
                                      [](int, int v) { return v; });
                   });
}

// ---------------------------------------------------------------------------
// Small M: split-K GEMV on mma.sync (s8_gemv.cuh)
// ---------------------------------------------------------------------------

// grid (ceil(N / 128), splits).  out must be zeroed: each block adds its
// int32 partial with atomicAdd.
template <int NP, int VEC>
__global__ void __launch_bounds__(s8gv::THREADS)
bitplane_gemv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     int M, int N, int K, int steps) {
  const FieldRows<NP, VEC> rows{reinterpret_cast<const uint8_t*>(w), K, N};
  const int* red = s8gv::gemv_partial(rows, x, M, K, steps);
  s8gv::add_partial(red, M, N, out,
                    s8gv::SlabCols{static_cast<int>(blockIdx.x) * s8gv::COLS,
                                   N});
}

template <int NP>
int launch_gemv(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
                int K, int steps, cudaStream_t stream) {
  const int total = (K + 31) / 32;
  const int splits = (total + steps - 1) / steps;
  const dim3 grid((N + s8gv::COLS - 1) / s8gv::COLS, splits);
  const size_t smem = s8gv::gemv_smem(steps);
  cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * 4,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (N % 16 == 0 && wa % 16 == 0)
    bitplane_gemv_kernel<NP, 16><<<grid, s8gv::THREADS, smem, stream>>>(
        x, w, out, M, N, K, steps);
  else if (N % 8 == 0 && wa % 8 == 0)
    bitplane_gemv_kernel<NP, 8><<<grid, s8gv::THREADS, smem, stream>>>(
        x, w, out, M, N, K, steps);
  else
    bitplane_gemv_kernel<NP, 1><<<grid, s8gv::THREADS, smem, stream>>>(
        x, w, out, M, N, K, steps);
  return static_cast<int>(cudaGetLastError());
}

// scratch: the K-major field wt (N, K'), then (copy_x) xp (M, K')
template <int NP>
int launch_large(const int8_t* x, const int8_t* w, int32_t* out,
                 int8_t* scratch, int M, int N, int K, bool copy_x,
                 cudaStream_t stream) {
  const int Kp = (K + 15) / 16 * 16;
  int8_t* wt = scratch;
  int8_t* xp = copy_x ? scratch + static_cast<size_t>(N) * Kp : nullptr;
  int w_blocks = 0;
  const unsigned blocks =
      s8gv::prepass_blocks(M, N, K, Kp, copy_x, &w_blocks);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  bitplane_prepass_kernel<NP><<<blocks, s8gv::PRE_THREADS, 0, stream>>>(
      w, wt, x, xp, M, N, K, Kp, w_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap map_x, map_w;
  if (!s8wg::make_maps(&map_x, &map_w, x, xp, wt, M, N, K, Kp))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  e = s8wg::allow_smem(bitplane_wgmma_kernel, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  bitplane_wgmma_kernel<<<s8wg::grid_blocks(M, N), s8wg::THREADS,
                          s8wg::SMEM_BYTES, stream>>>(map_x, map_w, out, M,
                                                      N, K);
  return static_cast<int>(cudaGetLastError());
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
    if (M > s8gv::ROWS || gemv_steps > s8gv::MAX_STEPS ||
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
