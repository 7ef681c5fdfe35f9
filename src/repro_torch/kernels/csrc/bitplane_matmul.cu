// Bit-plane int8 GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bitplane_matmul.py
// (`bitplane_matmul`, pallas_call at line 86): int8 x (M, K) times the low
// `n_planes` two's-complement field of an int8 weight container w (K, N),
// accumulated exactly in int32 -> out (M, N).  The TPU kernel walks the
// weight's bit planes (one MXU dot per plane); the sum of weighted planes
// is identically one dot with the sign-extended field, so here every
// weight is sign-extended ONCE, as it is copied into shared memory, and
// the tile runs on the int8 tensor cores (mma.sync m16n8k32 s8 -> s32).
// `n_planes` is a template parameter: the per-plane masking is two shifts.
//
// What bounds it on this card: at the serve path's shapes (im2col'd
// activations, M in the tens of thousands, K <= 4608, N <= 1000) the
// int8 work sits far below the tensor cores' 1979 TOPS, so the bound is
// bytes: the int8 im2col input read once and the int32 output written
// once (4 bytes per output element).  The design keeps each input byte
// to one device-memory read per block column (16-byte vector loads when
// K is a multiple of 16), keeps weights in L2 (a 64-column slice of w is
// shared by every row block), and writes the int32 tile straight from
// the accumulator registers.  It is single-buffered and uses mma.sync,
// not TMA and wgmma: a simple kernel that is right comes first.
//
// Ragged edges (K = 147 for conv1, N = 1000 for the fc, M = batch) are
// masked in the kernel: out-of-range tile elements load as zero and are
// never stored.  The tile itself (x loads, fragments, mma loop) is
// s8_tile.cuh, shared with int4_matmul.cu and quant_matmul.cu.

#include "s8_tile.cuh"

namespace {

using namespace s8tile;

template <int NP>
__device__ __forceinline__ int8_t sign_extend_field(int8_t v) {
  // low NP bits of the container, read as an NP-bit two's-complement value
  const unsigned u = static_cast<unsigned>(static_cast<int>(v)) << (32 - NP);
  return static_cast<int8_t>(static_cast<int>(u) >> (32 - NP));
}

template <int NP, bool VEC_X>
__global__ void __launch_bounds__(THREADS)
bitplane_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       int32_t* __restrict__ out, int M, int N, int K) {
  // sA[m][k]: x tile, row-major.  sB[n][k]: sign-extended w tile,
  // transposed so that a B fragment's four k values are one 32-bit word.
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc;
  gemm_tile<VEC_X>(acc, sA, sB, x, M, K, m0, [&](int8_t* sb, int k0) {
    // w tile -> sB, sign-extending the low NP-bit field once
#pragma unroll 4
    for (int it = 0; it < (BK * BN) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int kr = idx / BN;
      const int nc = idx % BN;
      const int gk = k0 + kr, gn = n0 + nc;
      const int8_t v = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0;
      sb[nc * LDS + kr] = sign_extend_field<NP>(v);
    }
  });

  // accumulators -> out
  const bool pair_ok = (N % 2) == 0;
  for_each_pair(acc, m0, [&](int row, int nc, int v0, int v1) {
    const int col = n0 + nc;
    if (row >= M) return;
    int32_t* o = out + (size_t)row * N + col;
    if (pair_ok && col + 1 < N) {
      *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
    } else {
      if (col < N) o[0] = v0;
      if (col + 1 < N) o[1] = v1;
    }
  });
}

template <int NP>
void launch(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
            int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (vec_x_ok(x, K))
    bitplane_matmul_kernel<NP, true><<<grid, THREADS, 0, stream>>>(
        x, w, out, M, N, K);
  else
    bitplane_matmul_kernel<NP, false><<<grid, THREADS, 0, stream>>>(
        x, w, out, M, N, K);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel
// does not take; the Python wrapper raises on anything but 0.
extern "C" int bitplane_matmul_s8(const void* x, const void* w, void* out,
                                  int M, int N, int K, int n_planes,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (N + BN - 1) / BN > 65535 ||
      n_planes < 1 || n_planes > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1: launch<1>(xp, wp, op, M, N, K, s); break;
    case 2: launch<2>(xp, wp, op, M, N, K, s); break;
    case 3: launch<3>(xp, wp, op, M, N, K, s); break;
    case 4: launch<4>(xp, wp, op, M, N, K, s); break;
    case 5: launch<5>(xp, wp, op, M, N, K, s); break;
    case 6: launch<6>(xp, wp, op, M, N, K, s); break;
    case 7: launch<7>(xp, wp, op, M, N, K, s); break;
    default: launch<8>(xp, wp, op, M, N, K, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
