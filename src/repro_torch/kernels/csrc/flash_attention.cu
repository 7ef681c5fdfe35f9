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
// {64, 128, 160}; the Python wrapper zero-pads other head dims up to one
// of these (zero columns change no score) and passes the real hd^-0.5
// scale.
//
// What bounds it on this card: at the serve path's prefill shape
// (BH = 128 flat heads, S = 4096, HD = 128, causal) the two products do
// 5.5e11 flop against 0.54 GB of q/k/v/out traffic, so the bound is the
// tensor cores (0.556 ms at 989 TFLOP/s bf16), not memory (0.160 ms).
// Only wgmma reaches that rate, and only if the tiles it reads arrive
// while the previous ones are multiplied.  The design:
//   * One block per (flat head, 128-row query tile), heaviest causal
//     tiles first.  Three warpgroups: two consumers of 64 query rows
//     each, and a producer whose one thread issues every copy.
//     setmaxnreg gives the producer's registers to the consumers
//     (24 / 240 a thread).
//   * Q arrives once by TMA and stays in shared memory for the whole key
//     loop.  K and V tiles (BKV = 128 keys) arrive by TMA into a ring of
//     3 slots (4 at HD = 64) under mbarriers (K and V land separately;
//     a slot is refilled once both consumers release it), so copies run
//     ahead of the math.  The tensor maps are 3-D
//     (hd, S, BH): rows past S load as zero and a tile never reads the
//     next head's rows.  With the 128-byte swizzle a 128-wide head is two
//     64-column boxes.  160 is not a multiple of 64, and padding it to 192
//     would not fit Q and two K and V slots in a block's 227 KB, so HD =
//     160 is five 32-column boxes under the 64-byte swizzle, with a ring
//     of 2 slots (40 KB of Q and 4 x 40 KB of K and V).
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory.  O += P V is wgmma m64n64k16 per 64 columns of the head
//     (m64n32k16 per 32 at HD = 160),
//     with P from registers (the f32 scores re-packed as bf16 A
//     fragments, whose per-warp layout is mma.sync's) and V read
//     MN-major from shared memory through the transpose bit.  m, l and O
//     stay in registers (rows g and g + 8 of each warp, as with
//     mma.sync).  A consumer issues O += P V and the next tile's
//     S = Q K^T back to back and waits only for the older of the two, so
//     its products run while the other warpgroup does its softmax.  (Two
//     schemes of FlashAttention-3 were tried and ran slower here: strict
//     turns between the warpgroups at named barriers, and overlapping a
//     tile's softmax with the previous tile's P V inside a warpgroup.)
//   * A key tile that every row of a warpgroup sees skips the per-element
//     mask; only tiles that straddle the diagonal, the window edge or
//     k_len test each score, and tiles hidden from all of a block's rows
//     are never loaded (exact: such a tile changes neither m, l nor O).
// Query rows past Sq are computed but not stored.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;             // query rows per block
constexpr int BKV = 128;            // keys per tile
constexpr int CONSUMERS = 256;      // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory layout (bytes from a 1024-byte-aligned base): Q, then a
// ring of K tiles and a ring of V tiles (as many slots as fit: 4 at
// HD = 64, 3 at HD = 128, 2 at HD = 160), then the mbarriers.  Every
// tile is stored as boxes of BOXW columns, each a column block of ROWB-
// byte swizzled rows
template <int HD>
struct Layout {
  static constexpr int STAGES = HD == 64 ? 4 : HD == 128 ? 3 : 2;
  static constexpr int BOXW = HD % 64 == 0 ? 64 : 32;  // columns per box
  static constexpr int ROWB = BOXW * 2;        // 128- or 64-byte swizzle
  static constexpr int BOXES = HD / BOXW;
  static constexpr int KS_PER_BOX = BOXW / 16; // k16 steps along a row
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;        // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// 2^x on the special-function unit (one instruction; results below
// 2^-126 flush to zero, far below the tolerance of a bf16 P)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the wgmma descriptor of a tile in the layout's swizzle
template <int ROWB>
__device__ __forceinline__ uint64_t desc_tile(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return ROWB == 128 ? desc_sw128(p, lbo, sbo) : desc_sw64(p, lbo, sbo);
}

__device__ __forceinline__ void wgmma_pv32(float (&d)[16],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                       int k_len, int causal, int window, float scale) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sK = smem + L::K_OFF;
  uint8_t* sV = smem + L::V_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = q_bar + 1;       // K tile landed
  uint64_t* full_v = full_k + L::STAGES;   // V tile landed
  uint64_t* empty = full_v + L::STAGES;    // both warpgroups done with it
  constexpr int STAGES = L::STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int bh = blockIdx.y;
  const int limit = k_len < Sk ? k_len : Sk;     // keys past it: invisible

  // key tiles: skip those a window hides from every row of the block,
  // stop after the diagonal tile when causal (exact either way)
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BKV;
  int kt_end = (limit + BKV - 1) / BKV;
  if (causal) {
    const int diag = (q0 + BQ - 1) / BKV + 1;
    kt_end = kt_end < diag ? kt_end : diag;
  }
  const int n_tiles = kt_end > kt_begin ? kt_end - kt_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA copy
    regs_dealloc<24>();
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int b = 0; b < L::BOXES; ++b)
        tma_load_3d(sQ + b * BQ * L::ROWB, &map_q, q_bar, b * L::BOXW, q0,
                    bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (kt_begin + i) * BKV;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_k[s], L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < L::BOXES; ++b)
          tma_load_3d(sK + s * L::KV_BYTES + b * BKV * L::ROWB, &map_k,
                      &full_k[s], b * L::BOXW, k0, bh);
        mbar_arrive_expect_tx(&full_v[s], L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < L::BOXES; ++b)
          tma_load_3d(sV + s * L::KV_BYTES + b * BKV * L::ROWB, &map_v,
                      &full_v[s], b * L::BOXW, k0, bh);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.  Per key tile: wait
    // for K, S = Q K^T, softmax, then O += P V issued asynchronously with
    // the next tile's Q K^T behind it, so the tensor cores run one while
    // this warpgroup waits for the other.
    regs_alloc<240>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;          // accumulator row within 8
    const int t = lane & 3;           // accumulator column pair
    const int row_lo = q0 + wg * 64;  // the warpgroup's first row
    const int qpos0 = row_lo + warp * 16 + g;   // rows qpos0, qpos0 + 8
    const float scale2 = scale * LOG2E;
    constexpr int ROWB = L::ROWB;
    const uint8_t* sQw = sQ + wg * 64 * ROWB;

    float m[2] = {NEG_INF, NEG_INF};  // running max, base-2 scaled domain
    float l[2] = {0.f, 0.f};
    // O: register i holds row g + 8 * ((i >> 1) & 1), column
    // 8 * (i >> 2) + 2t + (i & 1)
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.f;

    // descriptors of the Q rows, slot 0's K and slot 0's V; the others
    // are fixed offsets from these
    const uint64_t dq = desc_tile<ROWB>(sQw, 16, 8 * ROWB);
    const uint64_t dk = desc_tile<ROWB>(sK, 16, 8 * ROWB);
    const uint64_t dv = desc_tile<ROWB>(sV, BKV * ROWB, 8 * ROWB);

    // S = Q K^T for ring slot s: 64 rows x 128 keys, K-major operands
    auto issue_qk = [&](int s) {
      const uint64_t dks = desc_add(dk, s * L::KV_BYTES);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int box = ks / L::KS_PER_BOX;
        const int off = (ks % L::KS_PER_BOX) * 32;
        wgmma_qk(sacc, desc_add(dq, box * BQ * ROWB + off),
                 desc_add(dks, box * BKV * ROWB + off), ks > 0);
      }
      wgmma_commit();
    };

    // O += bf16(P) V for ring slot s, P's A fragments from registers; V
    // is MN-major, one m64n64k16 (m64n32k16) per 64- (32-) column box
    auto issue_pv = [&](int s, const uint32_t (&pa)[BKV / 16][4]) {
      const uint64_t dvs = desc_add(dv, s * L::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::BOXES; ++b) {
          const uint64_t db = desc_add(dvs, b * BKV * ROWB + kk * 16 * ROWB);
          if constexpr (L::BOXW == 64)
            wgmma_pv(*reinterpret_cast<float(*)[32]>(o + 32 * b), pa[kk], db,
                     1);
          else
            wgmma_pv32(*reinterpret_cast<float(*)[16]>(o + 16 * b), pa[kk],
                       db, 1);
        }
      wgmma_commit();
    };

    // Online softmax of tile `it` in place in sacc: p = exp(s * scale -
    // m_new) with masked scores at -1e30 and their p zeroed; updates m
    // and this thread's part of l (its quad's parts are summed at the
    // end: the correction factors agree across the quad) and returns O's
    // correction factors.  Register i holds row
    // g + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + 2t + (i & 1).
    auto softmax = [&](int it, float (&corr)[2]) {
      const int k0 = (kt_begin + it) * BKV;
      const int k_hi = k0 + BKV - 1;
      // a tile every row of the warpgroup sees in full skips the mask
      const bool whole = k_hi < limit && (!causal || k_hi <= row_lo) &&
                         (window <= 0 || k0 > row_lo + 63 - window);
      float mx[2] = {m[0], m[1]};
      if (whole) {
        float raw[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < 64; ++i)
          raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], sacc[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], raw[r] * scale2);
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          const int qpos = qpos0 + 8 * r;
          const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          bool vis = kpos < limit;
          if (causal) vis = vis && kpos <= qpos;
          if (window > 0) vis = vis && kpos > qpos - window;
          sacc[i] = vis ? sacc[i] * scale2 : NEG_INF;
          mx[r] = fmaxf(mx[r], sacc[i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) corr[r] = exp2_fast(m[r] - mx[r]);
      if (whole) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          sacc[i] = exp2_fast(fmaf(sacc[i], scale2, -mx[r]));
          rs[r] += sacc[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          sacc[i] = sacc[i] == NEG_INF ? 0.f : exp2_fast(sacc[i] - mx[r]);
          rs[r] += sacc[i];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * corr[r] + rs[r];  // this thread's columns only
        m[r] = mx[r];
      }
    };

    // bf16(P) as the A fragments of P V: key blocks 2kk and 2kk + 1 of
    // the score registers form k16 step kk
    uint32_t pa[BKV / 16][4];
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };

    // Per key tile: softmax of S, then O += P V issued with the next
    // tile's S = Q K^T behind it; wait for P V (the older group), release
    // the slot, then for S.
    mbar_wait(q_bar, 0);
    if (n_tiles > 0) {
      mbar_wait(&full_k[0], 0);
      fence_regs(sacc);
      wgmma_fence();
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sacc);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const bool more = it + 1 < n_tiles;
      float corr[2];
      softmax(it, corr);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p();
      mbar_wait(&full_v[s], (it / STAGES) & 1);
      fence_regs(sacc);
      fence_regs(o);
      wgmma_fence();
      issue_pv(s, pa);
      if (more) {
        const int s1 = (it + 1) % STAGES;
        mbar_wait(&full_k[s1], ((it + 1) / STAGES) & 1);
        issue_qk(s1);
        wgmma_wait<1>();              // P V done; the next S may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(o);
      mbar_arrive(&empty[s]);         // this warpgroup is done with slot s
      if (more) {
        wgmma_wait<0>();
        fence_regs(sacc);
      }
    }

    // ---- out = O / max(l, 1e-30), rows past Sq not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      if (qpos >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          out + (static_cast<size_t>(bh) * Sq + qpos) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int k_len, int causal, int window, float scale,
           cudaStream_t stream) {
  using L = Layout<HD>;
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t dims_q[3] = {HD, static_cast<cuuint64_t>(Sq),
                                static_cast<cuuint64_t>(BH)};
  const cuuint64_t dims_k[3] = {HD, static_cast<cuuint64_t>(Sk),
                                static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides_q[2] = {HD * 2, static_cast<cuuint64_t>(Sq) * HD * 2};
  const cuuint64_t strides_k[2] = {HD * 2, static_cast<cuuint64_t>(Sk) * HD * 2};
  const cuuint32_t box_q[3] = {L::BOXW, BQ, 1};
  const cuuint32_t box_k[3] = {L::BOXW, BKV, 1};
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto swz = L::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!make_map(&map_q, bf16, 3, q, dims_q, strides_q, box_q, swz) ||
      !make_map(&map_k, bf16, 3, k, dims_k, strides_k, box_k, swz) ||
      !make_map(&map_v, bf16, 3, v, dims_k, strides_k, box_k, swz))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;       // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_attention_kernel<HD><<<grid, THREADS, L::BYTES, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), Sq, Sk, k_len,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel
// does not take (or tensor maps the driver refuses); the Python wrapper
// raises on anything but 0.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int BH, int Sq,
                                    int Sk, int hd, int k_len, int causal,
                                    int window, float scale, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 65535 ||
      (hd != 64 && hd != 128 && hd != 160))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorInvalidValue);    // TMA needs 16 B
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, out, BH, Sq, Sk, k_len, causal, window, scale,
                      s);
  if (hd == 128)
    return launch<128>(q, k, v, out, BH, Sq, Sk, k_len, causal, window, scale,
                       s);
  return launch<160>(q, k, v, out, BH, Sq, Sk, k_len, causal, window, scale,
                     s);
}
