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
// N = 1000 put the halves' seam inside a tile there).  A block owns 32
// BYTE columns [b0, b0 + 32) of w: both nibbles of each byte are unpacked
// and sign-extended as the byte is copied into shared memory, the low
// ones into tile columns 0..31 (logical b0 + j), the high ones into
// 32..63 (logical N/2 + b0 + j), so every packed byte is read once per
// row block, and the 64-column int8 tile then runs on the tensor cores
// (mma.sync m16n8k32 s8 -> s32, s8_tile.cuh).
//
// What bounds it on this card: at the fixed-INT4 AlexNet forward's shapes
// the bound is bytes.  conv1 and conv3 read im2col'd activations (M in
// the thousands) and write an f32 output; fc6..fc8 at M = 16 are GEMVs
// whose cost is the packed weight (fc6: 18.9 MB), half the bytes of an
// int8 container.  This simple kernel loads w byte by byte (a packed row
// is N/2 bytes, 500 for fc8: no 16-byte alignment to rely on), is
// single-buffered, and gives a 16-row GEMV only N/64 blocks; split-K,
// wider loads, TMA and wgmma are later work.
//
// The epilogue multiplies in f32 with one rounding (__fmul_rn) and rounds
// to bf16 to nearest even, as the plain version does.  Ragged M, K and
// byte columns are masked in the kernel.

#include <cuda_bf16.h>

#include "s8_tile.cuh"

namespace {

using namespace s8tile;

constexpr int BB = BN / 2;          // byte columns per block

__device__ __forceinline__ int8_t sign_extend_nibble(unsigned u) {
  return static_cast<int8_t>(static_cast<int>(u << 28) >> 28);
}

__device__ __forceinline__ void store2(float* o, float a, float b,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (second) o[1] = b;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16_rn(a);
    if (second) o[1] = __float2bfloat16_rn(b);
  }
}

template <class OutT, bool VEC_X>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const int8_t* __restrict__ x,
                   const uint8_t* __restrict__ wp,
                   const float* __restrict__ scale, OutT* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int Nh = N / 2;
  const int m0 = blockIdx.x * BM;
  const int b0 = blockIdx.y * BB;

  Acc acc;
  gemm_tile<VEC_X>(acc, sA, sB, x, M, K, m0, [&](int8_t* sb, int k0) {
    // BK x 32 packed bytes -> both nibbles, sign-extended, into sB[n][k]
#pragma unroll 4
    for (int it = 0; it < (BK * BB) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int kr = idx / BB;
      const int bc = idx % BB;
      const int gk = k0 + kr, gb = b0 + bc;
      const unsigned v =
          (gk < K && gb < Nh) ? wp[(size_t)gk * Nh + gb] : 0u;
      sb[bc * LDS + kr] = sign_extend_nibble(v & 0xFu);
      sb[(bc + BB) * LDS + kr] = sign_extend_nibble(v >> 4);
    }
  });

  // tile column nc -> logical column: low half b0 + nc, high half
  // N/2 + b0 + (nc - 32); nc is even and nc + 1 is in the same half
  for_each_pair(acc, m0, [&](int row, int nc, int v0, int v1) {
    const int bcol = b0 + (nc & (BB - 1));
    if (row >= M || bcol >= Nh) return;
    const int col = (nc < BB ? 0 : Nh) + bcol;
    const bool second = bcol + 1 < Nh;
    const float y0 = __fmul_rn(__int2float_rn(v0), scale[col]);
    const float y1 = second ? __fmul_rn(__int2float_rn(v1), scale[col + 1])
                            : 0.0f;
    // N is even, so (row * N + col) is even exactly when col is
    store2(out + (size_t)row * N + col, y0, y1, second && (col % 2 == 0),
           second);
  });
}

template <class OutT>
void launch(const int8_t* x, const uint8_t* wp, const float* scale,
            OutT* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N / 2 + BB - 1) / BB);
  if (vec_x_ok(x, K))
    int4_matmul_kernel<OutT, true><<<grid, THREADS, 0, stream>>>(
        x, wp, scale, out, M, N, K);
  else
    int4_matmul_kernel<OutT, false><<<grid, THREADS, 0, stream>>>(
        x, wp, scale, out, M, N, K);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  N is the logical (unpacked)
// width; out is f32 (out_bf16 == 0) or bf16.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel
// does not take; the Python wrapper raises on anything but 0.
extern "C" int int4_matmul_s4(const void* x, const void* wp,
                              const void* scale, void* out, int M, int N,
                              int K, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 2 != 0 ||
      (N / 2 + BB - 1) / BB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch(xp, w, s, static_cast<__nv_bfloat16*>(out), M, N, K, st);
  else
    launch(xp, w, s, static_cast<float*>(out), M, N, K, st);
  return static_cast<int>(cudaGetLastError());
}
