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
// never stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // rows of x per block
constexpr int BN = 64;              // columns of w per block
constexpr int BK = 64;              // depth per shared-memory stage
constexpr int LDS = BK + 16;        // padded row stride: conflict-free frags
constexpr int THREADS = 256;        // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;              // rows per warp
constexpr int WN = 32;              // columns per warp

template <int NP>
__device__ __forceinline__ int8_t sign_extend_field(int8_t v) {
  // low NP bits of the container, read as an NP-bit two's-complement value
  const unsigned u = static_cast<unsigned>(static_cast<int>(v)) << (32 - NP);
  return static_cast<int8_t>(static_cast<int>(u) >> (32 - NP));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // groupID
  const int t = lane & 3;           // threadID_in_group
  const int wm = (warp >> 1) * WM;  // warp's row offset in the tile
  const int wn = (warp & 1) * WN;   // warp's column offset in the tile
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // ---- x tile -> sA (zero outside M x K)
    if (VEC_X) {
      // K % 16 == 0 and x 16-byte aligned: 16-byte loads, 2 per thread
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
    // ---- w tile -> sB, sign-extending the low NP-bit field once
#pragma unroll 4
    for (int it = 0; it < (BK * BN) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int kr = idx / BN;
      const int nc = idx % BN;
      const int gk = k0 + kr, gn = n0 + nc;
      const int8_t v = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0;
      sB[nc * LDS + kr] = sign_extend_field<NP>(v);
    }
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

  // ---- accumulators -> out: c0,c1 at row g, c2,c3 at row g + 8
  const bool pair_ok = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
        int32_t* o = out + (size_t)row * N + col;
        if (pair_ok && col + 1 < N) {
          *reinterpret_cast<int2*>(o) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (col < N) o[0] = acc[i][j][2 * h];
          if (col + 1 < N) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

template <int NP>
void launch(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
            int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const bool vec_x =
      (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (vec_x)
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
