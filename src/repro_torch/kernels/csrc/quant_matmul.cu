// Fused int8 GEMM + dequant (+ bias, + activation) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py
// (`quant_matmul`, pallas_call at line 64): int8 x (M, K) times int8
// w (K, N), accumulated exactly in int32, then
//     out[m, n] = act(f32(acc) * scale[n] + bias[n])
// with act in {none, relu, silu, gelu (tanh form)}, written as f32 or
// bf16.  `act` and the output type are template parameters.
//
// What bounds it on this card: bytes at every shape of the AlexNet path
// (the weight at M = 16; x and the output at large M); the epilogue's few
// f32 operations per output are noise beside them.  The two regimes are
// the bit-plane kernel's at the full 8 planes, each with the epilogue on
// the whole int32 sum; the wrapper's plan() (kernels/bitplane_matmul.py,
// shared) picks one from (M, K, N) and x's alignment.
//
// * Small M (M <= 16: AlexNet fc6-fc8).  s8_gemv.cuh's split-K GEMV:
//   16-byte loads of w along N (8 or 1 bytes when its rows are not
//   16-byte aligned), prmt into K-packed mma.sync m16n8k32 fragments, K
//   split over one wave of 2 blocks per SM.  The epilogue is not linear,
//   so it must see the whole sum: when K is split, each block adds its int32
//   partial by atomicAdd into a zeroed (M, N) scratch, and the last block
//   of each 128-column slab to arrive (a per-slab counter taken after
//   __threadfence) reads the sums back from L2 and applies the epilogue
//   in the same launch.  (A second, elementwise epilogue launch instead
//   ran within a few percent of it on the device clock at the AlexNet
//   and Qwen3-4B GEMV shapes, this one ahead at most of them; it keeps
//   one launch and one memset per call.)  Unsplit (K <= 480, or N wide
//   enough to fill the card alone), a block applies the epilogue to its
//   own partial.  Integer atomics are exact and independent of order, so
//   none and relu equal the plain version.
// * Large M (conv1-conv5).  s8_gemv.cuh's pre-pass writes w K-major into
//   an (N, K') scratch (and re-pitches an x whose rows are not 16-byte
//   aligned, conv1's K = 363), then s8_wgmma.cuh's persistent wgmma tile
//   runs with the epilogue on its accumulator registers: the int32 tile
//   is staged in shared memory and leaves as f32 or bf16 rows, so it
//   never reaches device memory.
//
// Rounding follows the plain version step by step: the multiply and the
// add are separate IEEE roundings (__fmul_rn, __fadd_rn: nvcc would
// otherwise contract them into one FMA), silu is y * (1 / (1 + exp(-y))),
// gelu is y * (0.5 * (1 + tanh(sqrt(2/pi) * (y + 0.044715 * y^3)))) in
// that order, and bf16 output rounds to nearest even.  expf and tanhf
// are CUDA's (within 2 ulp), so silu and gelu agree with the plain
// version to a tolerance, none and relu exactly.  Ragged edges are
// masked in the kernels.

#include <cuda_bf16.h>

#include "s8_gemv.cuh"
#include "s8_wgmma.cuh"

namespace {

enum Act { kNone = 0, kRelu = 1, kSilu = 2, kGelu = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == kRelu) return fmaxf(y, 0.0f);
  if (ACT == kSilu)
    return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
  if (ACT == kGelu) {
    const float c = 0.7978845608028654f;      // sqrt(2 / pi) in f32
    const float y3 = __fmul_rn(__fmul_rn(y, y), y);
    const float u = __fmul_rn(c, __fadd_rn(y, __fmul_rn(0.044715f, y3)));
    return __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
  }
  return y;
}

// the epilogue of column n's whole int32 sum
template <int ACT>
struct Epilogue {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  __device__ __forceinline__ float operator()(int n, int acc) const {
    return activate<ACT>(__fadd_rn(
        __fmul_rn(__int2float_rn(acc), __ldg(scale + n)), __ldg(bias + n)));
  }
};

// ---------------------------------------------------------------------------
// Small M: split-K GEMV, epilogue after the slab's last arrival
// ---------------------------------------------------------------------------

// grid (ceil(N / 128), splits).  With splits > 1, part (M, N) int32 and
// counters (one per slab) must be zeroed.
template <int ACT, class OutT, int VEC>
__global__ void __launch_bounds__(s8gv::THREADS)
quant_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, OutT* __restrict__ out,
                  int* __restrict__ part, unsigned* __restrict__ counters,
                  int M, int N, int K, int steps) {
  const s8gv::FieldRows<8, VEC> rows{reinterpret_cast<const uint8_t*>(w), K,
                                     N};
  const int* red = s8gv::gemv_partial(rows, x, M, K, steps);
  const Epilogue<ACT> epi{scale, bias};
  s8gv::finish(red, M, N, part, counters,
               s8gv::SlabCols{static_cast<int>(blockIdx.x) * s8gv::COLS, N},
               [&](int r, int n, int v) {
                 s8wg::put1(out + static_cast<size_t>(r) * N + n, epi(n, v));
               });
}

// scratch (splits > 1): part (M, N) int32, then one counter per slab
template <int ACT, class OutT>
int launch_gemv(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, OutT* out, void* scratch, int M, int N,
                int K, int steps, cudaStream_t stream) {
  const int total = (K + 31) / 32;
  const int splits = (total + steps - 1) / steps;
  const int slabs = (N + s8gv::COLS - 1) / s8gv::COLS;
  const dim3 grid(slabs, splits);
  const size_t smem = s8gv::gemv_smem(steps);
  int* part;
  unsigned* counters;
  const cudaError_t e = s8gv::split_scratch(scratch, M, N, slabs, splits,
                                            stream, &part, &counters);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (N % 16 == 0 && wa % 16 == 0)
    quant_gemv_kernel<ACT, OutT, 16><<<grid, s8gv::THREADS, smem, stream>>>(
        x, w, scale, bias, out, part, counters, M, N, K, steps);
  else if (N % 8 == 0 && wa % 8 == 0)
    quant_gemv_kernel<ACT, OutT, 8><<<grid, s8gv::THREADS, smem, stream>>>(
        x, w, scale, bias, out, part, counters, M, N, K, steps);
  else
    quant_gemv_kernel<ACT, OutT, 1><<<grid, s8gv::THREADS, smem, stream>>>(
        x, w, scale, bias, out, part, counters, M, N, K, steps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Large M: pre-pass and wgmma GEMM, epilogue on the accumulators
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(s8gv::PRE_THREADS)
quant_prepass_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                     const int8_t* __restrict__ x, int8_t* __restrict__ xp,
                     int M, int N, int K, int Kp, int w_blocks) {
  s8gv::prepass(s8gv::Field<8>{w, N}, wt, x, xp, M, N, K, Kp, w_blocks);
}

template <int ACT, class OutT>
__global__ void __launch_bounds__(s8wg::THREADS, 1)
quant_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int M, int N, int K) {
  const Epilogue<ACT> epi{scale, bias};
  s8wg::gemm_tiles(&map_x, &map_w, M, N, K,
                   [&](const int (&acc)[64], int wg, int m0, int n0) {
                     s8wg::store_tile(acc, wg, m0, n0, out, M, N, epi);
                   });
}

// scratch: the K-major weight wt (N, K'), then (copy_x) xp (M, K')
template <int ACT, class OutT>
int launch_large(const int8_t* x, const int8_t* w, const float* scale,
                 const float* bias, OutT* out, int8_t* scratch, int M, int N,
                 int K, bool copy_x, cudaStream_t stream) {
  const int Kp = (K + 15) / 16 * 16;
  int8_t* wt = scratch;
  int8_t* xp = copy_x ? scratch + static_cast<size_t>(N) * Kp : nullptr;
  int w_blocks = 0;
  const unsigned blocks =
      s8gv::prepass_blocks(M, N, K, Kp, copy_x, &w_blocks);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  quant_prepass_kernel<<<blocks, s8gv::PRE_THREADS, 0, stream>>>(
      w, wt, x, xp, M, N, K, Kp, w_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap map_x, map_w;
  if (!s8wg::make_maps(&map_x, &map_w, x, xp, wt, M, N, K, Kp))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;          // one per instantiation
  e = s8wg::allow_smem(quant_wgmma_kernel<ACT, OutT>, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  quant_wgmma_kernel<ACT, OutT><<<s8wg::grid_blocks(M, N), s8wg::THREADS,
                                  s8wg::SMEM_BYTES, stream>>>(
      map_x, map_w, scale, bias, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT, class OutT>
int run(const int8_t* x, const int8_t* w, const float* scale,
        const float* bias, OutT* out, void* scratch, int M, int N, int K,
        int gemv_steps, bool copy_x, cudaStream_t stream) {
  if (gemv_steps > 0)
    return launch_gemv<ACT>(x, w, scale, bias, out, scratch, M, N, K,
                            gemv_steps, stream);
  return launch_large<ACT>(x, w, scale, bias, out,
                           static_cast<int8_t*>(scratch), M, N, K, copy_x,
                           stream);
}

template <class OutT>
int run_act(int act, const int8_t* x, const int8_t* w, const float* scale,
            const float* bias, OutT* out, void* scratch, int M, int N, int K,
            int gemv_steps, bool copy_x, cudaStream_t stream) {
  switch (act) {
    case kRelu:
      return run<kRelu>(x, w, scale, bias, out, scratch, M, N, K, gemv_steps,
                        copy_x, stream);
    case kSilu:
      return run<kSilu>(x, w, scale, bias, out, scratch, M, N, K, gemv_steps,
                        copy_x, stream);
    case kGelu:
      return run<kGelu>(x, w, scale, bias, out, scratch, M, N, K, gemv_steps,
                        copy_x, stream);
    default:
      return run<kNone>(x, w, scale, bias, out, scratch, M, N, K, gemv_steps,
                        copy_x, stream);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  act: 0 none, 1 relu, 2 silu,
// 3 gelu; out is f32 (out_bf16 == 0) or bf16.  gemv_steps > 0 runs the
// small-M regime with that many k32 steps per split (M <= 16); when that
// splits K, `scratch` holds the int32 partial (M, N) and one counter per
// 128-column slab.  gemv_steps == 0 runs the large-M regime, with
// `scratch` (16-byte aligned) holding the K-major weight (N, K') and, with
// copy_x, x re-pitched to (M, K'), K' = K rounded up to 16; without
// copy_x, x's rows must be 16-byte aligned (TMA).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// plan the kernels do not take; the Python wrapper raises on anything
// but 0.
extern "C" int quant_matmul_s8(const void* x, const void* w,
                               const void* scale, const void* bias,
                               void* out, void* scratch, int M, int N, int K,
                               int act, int out_bf16, int gemv_steps,
                               int copy_x, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < 0 || act > 3)
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
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cx = copy_x != 0;
  if (out_bf16)
    return run_act(act, xp, wp, s, b, static_cast<__nv_bfloat16*>(out),
                   scratch, M, N, K, gemv_steps, cx, st);
  return run_act(act, xp, wp, s, b, static_cast<float*>(out), scratch, M, N,
                 K, gemv_steps, cx, st);
}
