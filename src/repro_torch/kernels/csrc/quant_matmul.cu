// Fused int8 GEMM + dequant (+ bias, + activation) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py
// (`quant_matmul`, pallas_call at line 64): int8 x (M, K) times int8
// w (K, N), accumulated exactly in int32, then
//     out[m, n] = act(f32(acc) * scale[n] + bias[n])
// with act in {none, relu, silu, gelu (tanh form)}, written as f32 or
// bf16.  It is the bit-plane kernel's tile at the full 8 planes (int8
// copied as is into shared memory, mma.sync m16n8k32 s8 -> s32,
// s8_tile.cuh) with the epilogue applied to the accumulator registers,
// so the int32 tile never reaches device memory.
//
// What bounds it on this card: bytes at decode-like M (the weight, read
// once per row block) and int8 operations at large M; the epilogue's few
// f32 operations per output are noise beside either.  Single-buffered,
// mma.sync: a simple kernel that is right comes first.
//
// Rounding follows the plain version step by step: the multiply and the
// add are separate IEEE roundings (__fmul_rn, __fadd_rn: nvcc would
// otherwise contract them into one FMA), silu is y * (1 / (1 + exp(-y))),
// gelu is y * (0.5 * (1 + tanh(sqrt(2/pi) * (y + 0.044715 * y^3)))) in
// that order, and bf16 output rounds to nearest even.  expf and tanhf
// are CUDA's (within 2 ulp), so silu and gelu agree with the plain
// version to a tolerance, none and relu exactly.  Ragged edges are
// masked in the kernel.

#include <cuda_bf16.h>

#include "s8_tile.cuh"

namespace {

using namespace s8tile;

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

__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

template <int ACT, class OutT, bool VEC_X>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, OutT* __restrict__ out,
                    int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc;
  gemm_tile<VEC_X>(acc, sA, sB, x, M, K, m0, [&](int8_t* sb, int k0) {
#pragma unroll 4
    for (int it = 0; it < (BK * BN) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int kr = idx / BN;
      const int nc = idx % BN;
      const int gk = k0 + kr, gn = n0 + nc;
      sb[nc * LDS + kr] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0;
    }
  });

  const bool pair_ok = (N % 2) == 0;
  for_each_pair(acc, m0, [&](int row, int nc, int v0, int v1) {
    const int col = n0 + nc;
    if (row >= M || col >= N) return;
    const float y0 = activate<ACT>(
        __fadd_rn(__fmul_rn(__int2float_rn(v0), scale[col]), bias[col]));
    OutT* o = out + (size_t)row * N + col;
    if (col + 1 < N) {
      const float y1 = activate<ACT>(__fadd_rn(
          __fmul_rn(__int2float_rn(v1), scale[col + 1]), bias[col + 1]));
      if (pair_ok) {
        put2(o, y0, y1);
      } else {
        put(o, y0);
        put(o + 1, y1);
      }
    } else {
      put(o, y0);
    }
  });
}

template <int ACT, class OutT>
void launch(const int8_t* x, const int8_t* w, const float* scale,
            const float* bias, OutT* out, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (vec_x_ok(x, K))
    quant_matmul_kernel<ACT, OutT, true><<<grid, THREADS, 0, stream>>>(
        x, w, scale, bias, out, M, N, K);
  else
    quant_matmul_kernel<ACT, OutT, false><<<grid, THREADS, 0, stream>>>(
        x, w, scale, bias, out, M, N, K);
}

template <class OutT>
void launch_act(int act, const int8_t* x, const int8_t* w,
                const float* scale, const float* bias, OutT* out, int M,
                int N, int K, cudaStream_t stream) {
  switch (act) {
    case kRelu: launch<kRelu>(x, w, scale, bias, out, M, N, K, stream); break;
    case kSilu: launch<kSilu>(x, w, scale, bias, out, M, N, K, stream); break;
    case kGelu: launch<kGelu>(x, w, scale, bias, out, M, N, K, stream); break;
    default: launch<kNone>(x, w, scale, bias, out, M, N, K, stream); break;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  act: 0 none, 1 relu, 2 silu,
// 3 gelu; out is f32 (out_bf16 == 0) or bf16.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel
// does not take; the Python wrapper raises on anything but 0.
extern "C" int quant_matmul_s8(const void* x, const void* w,
                               const void* scale, const void* bias,
                               void* out, int M, int N, int K, int act,
                               int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (N + BN - 1) / BN > 65535 || act < 0 ||
      act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch_act(act, xp, wp, s, b, static_cast<__nv_bfloat16*>(out), M, N, K,
               st);
  else
    launch_act(act, xp, wp, s, b, static_cast<float*>(out), M, N, K, st);
  return static_cast<int>(cudaGetLastError());
}
