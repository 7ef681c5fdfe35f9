// Packed-int4 GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/int4_matmul.py
// (`int4_matmul`, pallas_call at line 67): int8 x (M, K) times int4
// weights packed two to a byte in the *halves* layout, w (K, N/2) uint8
// (logical column c < N/2 in the low nibble of byte column c, column
// c >= N/2 in the high nibble of byte column c - N/2), accumulated exactly
// in int32, then out[m, c] = f32(acc) * scale[c], written as f32 or bf16.
//
// The TPU kernel selects the nibble per 128-wide column block, which needs
// N/2 to be a multiple of the block.  Here the nibble is chosen per
// logical column, so any even N works (AlexNet's conv1 N = 96 and fc8
// N = 1000 put the halves' seam inside a tile).
//
// What bounds it on this card: bytes at every shape of the fixed-INT4
// AlexNet forward.  Two regimes, the bit-plane kernel's, which the
// wrapper's plan() (kernels/bitplane_matmul.py, shared; N counted in
// logical columns, so a slab of 128 of them is 64 byte columns) picks:
//
// * Small M (M <= 16: fc6-fc8, whose cost is the packed weight, half the
//   bytes of an int8 container: 18.9 MB at fc6).  s8_gemv.cuh's split-K
//   GEMV, reading each packed byte once: a lane loads 8 bytes of a packed
//   row along N (4 or 1 when the rows of N/2 bytes are not 8-byte
//   aligned: fc8's are 500 bytes), and sign-extends four nibbles per
//   instruction, (v & 0x0F0F0F0F) ^ 0x08080808 minus 0x08080808 per byte
//   (__vsub4), and the same on v >> 4.  Its 16 fragment columns are the 8
//   low nibbles (logical b .. b + 7) and the 8 high ones (N/2 + b ..
//   N/2 + b + 7), so a block's 64 byte columns cover 128 logical columns
//   in two 64-wide halves of the output, with the int8 GEMV's register
//   budget.  (16-byte loads would give a lane 32 columns and double its
//   accumulators; issuing two k32 steps' 8-byte loads before the first
//   step's products was tried and ran slower, with more registers.)  K
//   splits over one wave of 2 blocks per SM; the epilogue
//   __fmul_rn(__int2float_rn(acc), scale[c]) is applied to the whole sum
//   by the last block of each slab, as in quant_matmul.cu.
// * Large M (conv1, conv3).  A pre-pass unpacks (K, N/2) straight into
//   the K-major (N, K') int8 scratch (the low nibble of byte column c to
//   row c, the high one to row N/2 + c) and re-pitches an x whose rows
//   are not 16-byte aligned (conv1's K = 363); s8_wgmma.cuh's wgmma tile
//   then runs with the scale epilogue on its accumulators.  The packed
//   weight is small at these shapes (conv1 17 KB, conv3 442 KB): the
//   bytes that count are x and the output, so the scratch's extra write
//   is cheap, and its time is in every number.
//
// The epilogue multiplies in f32 with one rounding (__fmul_rn) and rounds
// to bf16 to nearest even, as the plain version does, so the result
// equals it.  Ragged M, K and columns are masked in the kernels.

#include <cuda_bf16.h>

#include "s8_gemv.cuh"
#include "s8_wgmma.cuh"

namespace {

constexpr int SLAB_BYTES = s8gv::COLS / 2;   // byte columns per GEMV block

__device__ __forceinline__ uint32_t low_nibbles(uint32_t v) {
  return __vsub4((v & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// the pre-pass's view: logical column n of the halves-packed (K, N/2)
struct Nibbles {
  const uint8_t* __restrict__ w;
  int Nh;
  __device__ __forceinline__ int8_t at(int k, int n) const {
    const int c = n < Nh ? n : n - Nh;
    const unsigned v = w[static_cast<size_t>(k) * Nh + c];
    const unsigned u = (n < Nh ? v : v >> 4) << 28;
    return static_cast<int8_t>(static_cast<int>(u) >> 28);
  }
};

// the GEMV's view: a lane reads 8 packed bytes of a row, its 16 columns
// the 8 low nibbles then the 8 high ones
template <int VEC>
struct NibbleRows {
  const uint8_t* __restrict__ w;
  int K, Nh;
  __device__ __forceinline__ int lane_col(int slab, int g) const {
    return slab * SLAB_BYTES + 8 * g;
  }
  __device__ __forceinline__ uint4 load(int k, int c) const {
    return s8gv::load_row<8, VEC>(w, k, c, K, Nh);
  }
  __device__ __forceinline__ uint32_t word(const uint4& r, int q) const {
    const uint32_t v = (&r.x)[q & 1];
    return low_nibbles(q < 2 ? v : v >> 4);
  }
};

// slab column L of the output: half L / 64 (low or high nibbles), byte
// column b0 + L % 64, held by lane group (L % 64) / 8 as its column
// L % 8 + 8 * half
struct HalvesCols {
  int b0, Nh;
  __device__ __forceinline__ void operator()(int L, int& gn,
                                             int& idx) const {
    const int half = L >> 6, bc = L & 63;
    gn = b0 + bc < Nh ? half * Nh + b0 + bc : -1;
    idx = s8gv::red_index((bc & 7) + 8 * half, bc >> 3);
  }
};

struct Scale {
  const float* __restrict__ scale;
  __device__ __forceinline__ float operator()(int n, int acc) const {
    return __fmul_rn(__int2float_rn(acc), __ldg(scale + n));
  }
};

// ---------------------------------------------------------------------------
// Small M: split-K GEMV on the packed bytes
// ---------------------------------------------------------------------------

// grid (ceil(N/2 / 64), splits).  With splits > 1, part (M, N) int32 and
// counters (one per slab) must be zeroed.
template <class OutT, int VEC>
__global__ void __launch_bounds__(s8gv::THREADS)
int4_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                 const float* __restrict__ scale, OutT* __restrict__ out,
                 int* __restrict__ part, unsigned* __restrict__ counters,
                 int M, int N, int K, int steps) {
  const int Nh = N / 2;
  const NibbleRows<VEC> rows{wp, K, Nh};
  const int* red = s8gv::gemv_partial(rows, x, M, K, steps);
  const Scale epi{scale};
  s8gv::finish(red, M, N, part, counters,
               HalvesCols{static_cast<int>(blockIdx.x) * SLAB_BYTES, Nh},
               [&](int r, int n, int v) {
                 s8wg::put1(out + static_cast<size_t>(r) * N + n, epi(n, v));
               });
}

template <class OutT>
int launch_gemv(const int8_t* x, const uint8_t* wp, const float* scale,
                OutT* out, void* scratch, int M, int N, int K, int steps,
                cudaStream_t stream) {
  const int Nh = N / 2;
  const int total = (K + 31) / 32;
  const int splits = (total + steps - 1) / steps;
  const int slabs = (Nh + SLAB_BYTES - 1) / SLAB_BYTES;
  const dim3 grid(slabs, splits);
  const size_t smem = s8gv::gemv_smem(steps);
  int* part;
  unsigned* counters;
  const cudaError_t e = s8gv::split_scratch(scratch, M, N, slabs, splits,
                                            stream, &part, &counters);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wp);
  if (Nh % 8 == 0 && wa % 8 == 0)
    int4_gemv_kernel<OutT, 8><<<grid, s8gv::THREADS, smem, stream>>>(
        x, wp, scale, out, part, counters, M, N, K, steps);
  else if (Nh % 4 == 0 && wa % 4 == 0)
    int4_gemv_kernel<OutT, 4><<<grid, s8gv::THREADS, smem, stream>>>(
        x, wp, scale, out, part, counters, M, N, K, steps);
  else
    int4_gemv_kernel<OutT, 1><<<grid, s8gv::THREADS, smem, stream>>>(
        x, wp, scale, out, part, counters, M, N, K, steps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Large M: unpacking pre-pass and wgmma GEMM
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(s8gv::PRE_THREADS)
int4_prepass_kernel(const uint8_t* __restrict__ wp, int8_t* __restrict__ wt,
                    const int8_t* __restrict__ x, int8_t* __restrict__ xp,
                    int M, int N, int K, int Kp, int w_blocks) {
  s8gv::prepass(Nibbles{wp, N / 2}, wt, x, xp, M, N, K, Kp, w_blocks);
}

template <class OutT>
__global__ void __launch_bounds__(s8wg::THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ scale, OutT* __restrict__ out,
                  int M, int N, int K) {
  const Scale epi{scale};
  s8wg::gemm_tiles(&map_x, &map_w, M, N, K,
                   [&](const int (&acc)[64], int wg, int m0, int n0) {
                     s8wg::store_tile(acc, wg, m0, n0, out, M, N, epi);
                   });
}

// scratch: the unpacked K-major weight wt (N, K'), then (copy_x) xp
// (M, K')
template <class OutT>
int launch_large(const int8_t* x, const uint8_t* wp, const float* scale,
                 OutT* out, int8_t* scratch, int M, int N, int K,
                 bool copy_x, cudaStream_t stream) {
  const int Kp = (K + 15) / 16 * 16;
  int8_t* wt = scratch;
  int8_t* xp = copy_x ? scratch + static_cast<size_t>(N) * Kp : nullptr;
  int w_blocks = 0;
  const unsigned blocks =
      s8gv::prepass_blocks(M, N, K, Kp, copy_x, &w_blocks);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  int4_prepass_kernel<<<blocks, s8gv::PRE_THREADS, 0, stream>>>(
      wp, wt, x, xp, M, N, K, Kp, w_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap map_x, map_w;
  if (!s8wg::make_maps(&map_x, &map_w, x, xp, wt, M, N, K, Kp))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;          // one per output type
  e = s8wg::allow_smem(int4_wgmma_kernel<OutT>, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  int4_wgmma_kernel<OutT><<<s8wg::grid_blocks(M, N), s8wg::THREADS,
                            s8wg::SMEM_BYTES, stream>>>(map_x, map_w, scale,
                                                        out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <class OutT>
int run(const int8_t* x, const uint8_t* wp, const float* scale, OutT* out,
        void* scratch, int M, int N, int K, int gemv_steps, bool copy_x,
        cudaStream_t stream) {
  if (gemv_steps > 0)
    return launch_gemv(x, wp, scale, out, scratch, M, N, K, gemv_steps,
                       stream);
  return launch_large(x, wp, scale, out, static_cast<int8_t*>(scratch), M, N,
                      K, copy_x, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  N is the logical (unpacked)
// width; out is f32 (out_bf16 == 0) or bf16.  gemv_steps > 0 runs the
// small-M regime with that many k32 steps per split (M <= 16); when that
// splits K, `scratch` holds the int32 partial (M, N) and one counter per
// slab of 64 byte columns.  gemv_steps == 0 runs the large-M regime, with
// `scratch` (16-byte aligned) holding the unpacked K-major weight (N, K')
// and, with copy_x, x re-pitched to (M, K'), K' = K rounded up to 16;
// without copy_x, x's rows must be 16-byte aligned (TMA).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// plan the kernels do not take; the Python wrapper raises on anything
// but 0.
extern "C" int int4_matmul_s4(const void* x, const void* wp,
                              const void* scale, void* out, void* scratch,
                              int M, int N, int K, int out_bf16,
                              int gemv_steps, int copy_x, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (gemv_steps > 0) {
    const int splits = ((K + 31) / 32 + gemv_steps - 1) / gemv_steps;
    if (M > s8gv::ROWS || gemv_steps > s8gv::MAX_STEPS || splits > 65535 ||
        (splits > 1 && scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (scratch == nullptr ||
             reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
             (!copy_x && !s8wg::tma_x_ok(x, K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cx = copy_x != 0;
  if (out_bf16)
    return run(xp, w, s, static_cast<__nv_bfloat16*>(out), scratch, M, N, K,
               gemv_steps, cx, st);
  return run(xp, w, s, static_cast<float*>(out), scratch, M, N, K,
             gemv_steps, cx, st);
}
