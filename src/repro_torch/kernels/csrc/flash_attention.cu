// Flash attention forward for Hopper (sm_90a): one pass of
// softmax(q k^T * scale) v per flat head, with an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, pallas_call at line 94).  Contract, as there:
//   * s = (q . k^T) * scale, accumulated in f32;
//   * key j is visible to query i iff j < k_len, and j <= i when causal,
//     and j > i - window when window > 0 (the window applies whether or
//     not the mask is causal);
//   * masked scores are -1e30 (not -inf) and their p is zeroed
//     explicitly: a tile wholly masked for a row would otherwise give
//     exp(0) = 1;
//   * running max m, sum l and accumulator acc are f32; p is rounded to
//     bf16 before the P.V product; out = acc / max(l, 1e-30) in bf16.
// The exponential is exp2f on scores pre-multiplied by scale * log2(e)
// (the max is tracked in the same base-2 domain): the same function as
// exp(s - m) up to f32 rounding.
//
// Layout: q (BH, Sq, HD), k and v (BH, Sk, HD), bf16, contiguous; out is
// (BH, Sq, HD) bf16.  Sq != Sk is allowed.  HD is a template parameter in
// {64, 128}; the Python wrapper zero-pads other head dims up to one of
// these (zero columns change no score) and passes the real hd^-0.5 scale.
// Ragged edges are masked here: query rows past Sq are computed but not
// stored, and keys past Sk load as zero and are invisible.
//
// What bounds it on this card: at the serve path's prefill shape
// (BH = 128 flat heads, S = 4096, HD = 128, causal) the two products do
// 5.5e11 flop against 0.54 GB of q/k/v/out traffic, so the bound is the
// tensor cores (0.556 ms at 989 TFLOP/s bf16), not memory (0.160 ms).
// The design keeps the S x S scores out of device memory entirely (one
// 64 x 64 tile per warp group lives in registers), reads each K/V tile
// once per 64-row query tile through shared memory, and skips the key
// tiles a causal or windowed mask hides wholly (exact: such a tile
// changes neither m, l nor acc).  Query tiles are issued heaviest first
// so that the causal triangle's long rows do not trail the grid.  It
// uses mma.sync m16n8k16 (bf16 -> f32) with single-buffered shared
// memory, not TMA and wgmma: a simple kernel that is right comes first.
//
// One block per (flat head, 64-row query tile): four warps, each owning
// 16 query rows for the whole key loop.  Per 64-key tile a warp computes
// its 16 x 64 score fragment (8 n-blocks of m16n8k16), reduces row max
// and row sum across each quad with __shfl_xor_sync, re-packs the f32
// probabilities in registers as the bf16 A fragments of P.V, and reads
// V's B fragments with the transposing ldmatrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BKV = 64;             // keys per tile
constexpr int THREADS = 128;        // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lanes 8m..8m+7 give the row
// addresses of matrix m; register m of lane l receives elements
// [2(l%4)][l/4] and [2(l%4)+1][l/4] of matrix m (the mma B layout).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x HD bf16 tile from global (row stride HD) into shared memory (row
// stride LD), 16 bytes per thread per step; rows at or past n_rows are
// zero-filled.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int n_rows, int tid) {
  constexpr int CHUNKS = HD / 8;                 // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < (BKV * CHUNKS) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                       int k_len, int causal, int window, float scale) {
  constexpr int LD = HD + 8;        // padded row: conflict-free fragments
  constexpr int KSTEPS = HD / 16;   // k16 steps of the QK^T product
  constexpr int NB_S = BKV / 8;     // n8 blocks of a score tile
  constexpr int NB_O = HD / 8;      // n8 blocks of the output
  __shared__ __align__(16) __nv_bfloat16 sK[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BKV * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // groupID: fragment row
  const int t = lane & 3;           // thread in group: fragment column pair
  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int q0 = qt * BQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qh = q + bh * (size_t)Sq * HD;
  const __nv_bfloat16* kh = k + bh * (size_t)Sk * HD;
  const __nv_bfloat16* vh = v + bh * (size_t)Sk * HD;
  const int limit = k_len < Sk ? k_len : Sk;     // keys past it: invisible
  const float scale2 = scale * LOG2E;

  // ---- Q tile -> registers (staged through sK), A fragments per k16 step
  load_tile<HD, LD>(sK, qh, q0, Sq, tid);
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* base = sK + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const __nv_bfloat16* p = base + ks * 16;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(p);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
    }
  }

  // rows this thread holds: r = 0 -> row g, r = 1 -> row g + 8
  const int qpos0 = q0 + warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF};   // running max, base-2 scaled domain
  float l[2] = {0.f, 0.f};
  float acc[NB_O][4];
#pragma unroll
  for (int j = 0; j < NB_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // key tiles: skip those a window hides from every row of the block,
  // stop after the diagonal tile when causal (exact either way)
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BKV;
  int kt_end = (limit + BKV - 1) / BKV;
  if (causal) {
    const int diag = (q0 + BQ - 1) / BKV + 1;
    kt_end = kt_end < diag ? kt_end : diag;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                 // previous tile (or Q staging) consumed
    load_tile<HD, LD>(sK, kh, k0, Sk, tid);
    load_tile<HD, LD>(sV, vh, k0, Sk, tid);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys
    float s[NB_S][4];
#pragma unroll
    for (int j = 0; j < NB_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kb = sK + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + ks * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kb + ks * 16 + 8);
        mma_bf16(s[j], qa[ks], b0, b1);
      }
    }

    // ---- mask, scale, running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NB_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qpos = qpos0 + 8 * r;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        bool vis = kpos < limit;
        if (causal) vis = vis && kpos <= qpos;
        if (window > 0) vis = vis && kpos > qpos - window;
        const float val = vis ? s[j][e] * scale2 : NEG_INF;
        s[j][e] = val;
        mx[r] = fmaxf(mx[r], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    // ---- p = exp(s - m_new), zeroed where masked; rescale l and acc
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) corr[r] = exp2f(m[r] - mx[r]);
#pragma unroll
    for (int j = 0; j < NB_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            s[j][e] == NEG_INF ? 0.f : exp2f(s[j][e] - mx[r]);
        s[j][e] = p;
        rs[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NB_O; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // ---- acc += bf16(P) V: P's A fragments straight from the score
    // registers (n-blocks 2kk and 2kk+1 form one k16 step)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lane's row address for ldmatrix: matrix mi = lane / 8 covers keys
      // kk*16 + (mi & 1) * 8 .. + 7 and dims (mi >> 1) * 8 .. + 7
      const int mi = lane >> 3;
      const __nv_bfloat16* vrow =
          sV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int jn = 0; jn < NB_O; jn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + jn * 8);
        mma_bf16(acc[jn], pa, vb[0], vb[1]);
        mma_bf16(acc[jn + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // ---- out = acc / max(l, 1e-30), rows past Sq not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + (bh * (size_t)Sq + qpos) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < NB_O; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel
// does not take; the Python wrapper raises on anything but 0.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int BH, int Sq,
                                    int Sk, int hd, int k_len, int causal,
                                    int window, float scale, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 65535 || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    flash_attention_kernel<64><<<grid, THREADS, 0, s>>>(
        qp, kp, vp, op, Sq, Sk, k_len, causal, window, scale);
  else
    flash_attention_kernel<128><<<grid, THREADS, 0, s>>>(
        qp, kp, vp, op, Sq, Sk, k_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}
