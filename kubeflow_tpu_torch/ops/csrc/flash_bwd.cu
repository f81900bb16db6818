// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the Pallas TPU kernels of kubeflow_tpu/ops/flash.py launched by
// _flash_bwd_bhsd:
//   - flash_dq_kernel  <- _flash_dq_kernel:  dq = sum_k ds k
//   - flash_dkv_kernel <- _flash_dkv_kernel: dv = sum_q p^T g,
//                                            dk = sum_q ds^T q
// with, per (query, key) pair, s = q.k * scale (masked above the causal
// diagonal, q_pos >= k_pos in absolute positions also when sq != sk),
// p = exp(s - lse) (0 where lse is the NEG_INF sentinel of a row with no
// valid key), dp = g.v and ds = p * (dp - delta) * scale rounded to bf16
// before its product; p is rounded to bf16 before dv's.  lse is the
// forward's m + log(l) and delta = rowsum(g * o), both float32 and
// computed outside the kernels.
//
// What bounds them on an H100: at the training shape (bh 64, s 2048,
// d 128, causal) the dq kernel does three products per live (query, key)
// pair (s, dp, dq: 6 d operations) and the dkv kernel four (s, dp, dv,
// dk: 8 d), which at 989 TFLOP/s take 0.104 and 0.139 ms, two to three
// times as long as moving q, k, v, g, lse, delta and the gradients through
// device memory once.  So the design keeps the tensor cores fed, with the
// forward's tools (hopper.cuh):
//   - every product on wgmma.  dq: S = Q K^T and dP = G V^T with all
//     operands K-major in shared memory, issued back to back and waited
//     on once; dQ += dS K with dS from registers (the S accumulators turned
//     into ds and rounded to bf16 in place: their layout is wgmma's A
//     fragment) and K read MN-major (transposed).  dkv works in the
//     transposed [keys, queries] space of the Pallas kernel, so no
//     fragment is ever transposed: S^T = K Q^T and dP^T = V G^T, then
//     dV += P^T G and dK += dS^T Q with G and Q read MN-major;
//   - one CTA of two consumer warpgroups (64 rows each) and one producer
//     warpgroup: dq per (bh, 128-row query tile), the producer loading
//     Q and G once and streaming 128-key K and V tiles through a two-stage
//     ring; dkv per (bh, 128-key tile), K and V loaded once and 64-query Q
//     and G tiles, with their rows' lse and delta, streamed through a
//     two-stage ring from the first query tile that reaches the causal
//     diagonal.  TMA loads over 3-D tensor maps [bh, s, d] (a box past a
//     head's end is zero-filled, never the next head's rows), full and
//     empty mbarriers, setmaxnreg moving registers from the producer
//     warpgroup to the consumers;
//   - each consumer waits for its own register-A products (dQ; dV and dK)
//     before the next tile's S, so their fragments never live beside the
//     next tile's accumulators and no instance spills; the two consumers
//     overlap each other, and dq issues dQ += dS K in two halves of the
//     key tile, the first running while the second half's ds is computed;
//   - mask code only in the tiles that need it: causal diagonal tiles and
//     dq's ragged key edge.  The sentinel test is one per row (dq, once,
//     in registers) or per column of each tile (dkv, by the producer):
//     each row's base-2 offset of p is lse log2(e), or +inf where lse is
//     the sentinel or the row lies past sq, so exp2 gives p = 0 there
//     without a per-element test;
//   - heaviest tiles first (dq: last query tiles; dkv: first key tiles);
//   - no atomics: each CTA owns its output rows, so gradients repeat bit
//     for bit.
// Any length works: tails are zero-filled by TMA and masked, without the
// TPU's divisor search (_fit_block).
//
// Interface: plain C, launched on the caller's stream; each entry point
// returns the cudaError_t of its launch (0 = launched).  The tensor maps
// are encoded on the host per call and passed as __grid_constant__.

#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace kft;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + producer warpgroup
// setmaxnreg rebalances the entry allotment (65536 / 384 = 168 a thread).
// A dq consumer holds S, dP and dQ (192 floats at 128-key tiles) and
// takes 240, the producer warpgroup (one TMA thread) 24; a dkv consumer
// holds dK, dV, S^T and dP^T (192 floats) and takes 232, its producer
// threads (which also load row statistics) 40.  Both fit in 65,536.
constexpr int kDqProducerRegs = 24;
constexpr int kDqConsumerRegs = 240;
constexpr int kDkvProducerRegs = 40;
constexpr int kDkvConsumerRegs = 232;
static_assert(128 * (kConsumers * kDqConsumerRegs + kDqProducerRegs) <= 65536
              && 128 * (kConsumers * kDkvConsumerRegs + kDkvProducerRegs)
                     <= 65536, "register file");
// dq: 128 query rows a CTA; 128-key K and V tiles in a two-stage ring;
// dQ += dS K issued in two parts of the key tile, the first running while
// the second part's ds is computed.
constexpr int kDqRows = 64 * kConsumers;
constexpr int kDqKeys = 128;
constexpr int kDqStages = 2;
constexpr int kDqParts = 2;
// dkv: 128 keys a CTA; 64-query Q and G tiles in a two-stage ring.
constexpr int kDkvKeys = 64 * kConsumers;
constexpr int kDkvRows = 64;
constexpr int kDkvStages = 2;

// Dynamic shared memory of a dq CTA, from a 1024-byte aligned base: Q and
// G [D / 64 panels][kDqRows], then the K and V rings [D / 64][kDqKeys],
// then the mbarriers.
template <int D>
struct DqSmem {
  static constexpr int kQBytes = kDqRows * D * 2;
  static constexpr int kTileBytes = kDqKeys * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kG = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kDqStages * kTileBytes;
  static constexpr int kBar = kV + kDqStages * kTileBytes;
  // qg_full; per stage full (K and V), empty.
  static constexpr int kBars = 1 + 2 * kDqStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + align slack
};

// Dynamic shared memory of a dkv CTA: K and V [D / 64][kDkvKeys], the Q
// and G rings [D / 64][kDkvRows], per stage the tile's kDkvRows base-2
// offsets of p and kDkvRows deltas (float32), then the mbarriers.
template <int D>
struct DkvSmem {
  static constexpr int kKBytes = kDkvKeys * D * 2;
  static constexpr int kTileBytes = kDkvRows * D * 2;
  static constexpr int kStatBytes = 2 * kDkvRows * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kKBytes;
  static constexpr int kQ = 2 * kKBytes;
  static constexpr int kG = kQ + kDkvStages * kTileBytes;
  static constexpr int kStats = kG + kDkvStages * kTileBytes;
  static constexpr int kBar = kStats + kDkvStages * kStatBytes;
  // kv_full; per stage full (Q, G and the row statistics), empty.
  static constexpr int kBars = 1 + 2 * kDkvStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + align slack
};

// The base-2 offset of a row's p = exp2(s scale log2(e) - offset):
// lse log2(e), or +inf (so that p = 0) for a row at or past `rows` or one
// whose lse is the NEG_INF sentinel.  The sentinel is tested before
// log2(e) is folded in: NEG_INF log2(e) overflows float32 to -inf.
__device__ __forceinline__ float exp2_offset(const float* __restrict__ lse,
                                             int row, int rows) {
  if (row >= rows) return INFINITY;
  const float l = lse[row];
  return l > kNegInf / 2 ? l * kLog2e : INFINITY;
}

// acc[64 x N] = A[64 x D] B[N x D]^T: A the 64 rows of a tile whose
// panels lie a_panel bytes apart, B a tile of N rows; both K-major.
template <int D, int N>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], uint32_t a,
                                        uint32_t a_panel, uint32_t b) {
  // Head_dim in steps of 16 (32 bytes) within a 64-wide panel, then the
  // next panel.
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = desc_k_major(a + (kk / 4) * a_panel + col);
    const uint64_t db = desc_k_major(b + (kk / 4) * N * kRowBytes + col);
    if constexpr (N == 128) {
      wgmma_ss_n128(acc, da, db, kk > 0);
    } else {
      wgmma_ss_n64(acc, da, db, kk > 0);
    }
  }
}

// acc[64 x D] += A[64 x K] B[K x D]: A as K / 16 bf16 register fragments,
// B a tile of K rows read MN-major (transposed).
template <int D, int K, int kK0 = 0, int kK1 = K / 16>
__device__ __forceinline__ void gemm_rs(float (&acc)[D / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
  // The reduction in steps of 16 rows (those of [16 kK0, 16 kK1)); all of
  // head_dim (D / 64 panels, K rows each) at once.
#pragma unroll
  for (int kk = kK0; kk < kK1; ++kk) {
    const uint64_t desc = desc_mn_major(b + kk * 16 * kRowBytes,
                                        K * kRowBytes);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, a[kk], desc);
    } else {
      wgmma_rs_n64(acc, a[kk], desc);
    }
  }
}

// The bf16 A fragments of a [64 x N] float32 accumulator: its layout
// (c[4 j + e] row g, column 8 j + 2 t + e; c[4 j + 2 + e] row g + 8) is
// wgmma's A fragment layout.
template <int N, int kK0 = 0, int kK1 = N / 16>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4],
                                         const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = kK0; kk < kK1; ++kk) {
    f[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    f[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    f[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    f[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Write a thread's share of a [64 x D] float32 accumulator as bf16 rows
// row_a and row_a + 8 of a [rows, D] matrix; rows at or past `rows` are
// not written.
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* __restrict__ out,
                                           const float (&acc)[D / 2],
                                           int row_a, int rows, int t) {
  const int row_b = row_a + 8;
  uint16_t* o_a = out + static_cast<size_t>(row_a) * D;
  uint16_t* o_b = o_a + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_a < rows) {
      *reinterpret_cast<uint32_t*>(o_a + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    }
    if (row_b < rows) {
      *reinterpret_cast<uint32_t*>(o_b + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The two query rows of a dq thread: keys before `lim` are live (those
// before sk, and under the causal mask those up to the row), the base-2
// offset of p, and delta * scale.
struct DqRows {
  int lim_a, lim_b;
  float off_a, off_b, dls_a, dls_b;
};

// One key tile of dq (its keys [8 kJ0, 8 kJ1)): ds = p (dp - delta)
// scale in place of s, with p = exp2(s scale log2(e) - offset).  kMask
// (the diagonal and ragged tiles only) zeroes p of the keys past each
// row's limit: key k0 + 8 j + 2 t + e, so the test is 8 j + e against the
// limit less k0 + 2 t.
template <int N, bool kMask, int kJ0, int kJ1>
__device__ __forceinline__ void dq_ds(float (&s)[N / 2],
                                      const float (&dp)[N / 2],
                                      const DqRows& r, int k0, int t,
                                      float sl2, float scale) {
  const int ca = r.lim_a - k0 - 2 * t, cb = r.lim_b - k0 - 2 * t;
#pragma unroll
  for (int j = kJ0; j < kJ1; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float pa = fast_exp2(fmaf(s[4 * j + e], sl2, -r.off_a));
      float pb = fast_exp2(fmaf(s[4 * j + 2 + e], sl2, -r.off_b));
      if constexpr (kMask) {
        if (8 * j + e >= ca) pa = 0.f;
        if (8 * j + e >= cb) pb = 0.f;
      }
      s[4 * j + e] = pa * fmaf(dp[4 * j + e], scale, -r.dls_a);
      s[4 * j + 2 + e] = pb * fmaf(dp[4 * j + 2 + e], scale, -r.dls_b);
    }
  }
}

// Part kPart of kDqParts of a dq key tile: its ds (the mask chosen per
// tile), rounded to bf16 A fragments, and its share of dQ += dS K issued
// and committed.
template <int D, int kPart>
__device__ __forceinline__ void dq_part(bool mask, float (&s)[kDqKeys / 2],
                                        const float (&dp)[kDqKeys / 2],
                                        uint32_t (&ds)[kDqKeys / 16][4],
                                        float (&acc)[D / 2],
                                        const DqRows& r, int k0, int t,
                                        float sl2, float scale,
                                        uint32_t k_tile) {
  constexpr int kJ = kDqKeys / 8 / kDqParts, kK = kDqKeys / 16 / kDqParts;
  if (mask) {
    dq_ds<kDqKeys, true, kPart * kJ, (kPart + 1) * kJ>(s, dp, r, k0, t, sl2,
                                                       scale);
  } else {
    dq_ds<kDqKeys, false, kPart * kJ, (kPart + 1) * kJ>(s, dp, r, k0, t,
                                                        sl2, scale);
  }
  to_frags<kDqKeys, kPart * kK, (kPart + 1) * kK>(ds, s);
  wgmma_fence();
  gemm_rs<D, kDqKeys, kPart * kK, (kPart + 1) * kK>(acc, ds, k_tile);
  wgmma_commit();
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(__grid_constant__ const CUtensorMap tm_q,
                __grid_constant__ const CUtensorMap tm_g,
                __grid_constant__ const CUtensorMap tm_k,
                __grid_constant__ const CUtensorMap tm_v,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                uint16_t* __restrict__ dq, int sq, int sk, float scale) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qg_full = base + L::kBar;
  auto full = [&](int st) { return qg_full + 8 * (1 + st); };
  auto empty = [&](int st) { return qg_full + 8 * (1 + kDqStages + st); };

  const int bh = blockIdx.y;
  // Heaviest causal tiles (last query rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  // Live key tiles: none wholly above the diagonal of this query tile.
  int n_tiles = (sk + kDqKeys - 1) / kDqKeys;
  if (kCausal) {
    n_tiles = min(n_tiles, (min(q0 + kDqRows, sq) - 1) / kDqKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
#pragma unroll
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kDqProducerRegs));
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      mbar_expect_tx(qg_full, 2 * L::kQBytes);
#pragma unroll
      for (int p = 0; p < D / kPanel; ++p) {
        tma_load(base + L::kQ + p * kDqRows * kRowBytes, &tm_q, qg_full,
                 p * kPanel, q0, bh);
        tma_load(base + L::kG + p * kDqRows * kRowBytes, &tm_g, qg_full,
                 p * kPanel, q0, bh);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(empty(st), phase ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTileBytes);
#pragma unroll
        for (int p = 0; p < D / kPanel; ++p) {
          const uint32_t off = st * L::kTileBytes + p * kDqKeys * kRowBytes;
          tma_load(base + L::kK + off, &tm_k, full(st), p * kPanel,
                   it * kDqKeys, bh);
          tma_load(base + L::kV + off, &tm_v, full(st), p * kPanel,
                   it * kDqKeys, bh);
        }
        if (++st == kDqStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kDqConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const int r_lo = q0 + wg * 64;
    const int row_a = r_lo + warp * 16 + (lane >> 2), row_b = row_a + 8;
    const float* lse_h = lse + static_cast<size_t>(bh) * sq;
    const float* delta_h = delta + static_cast<size_t>(bh) * sq;
    DqRows r;
    r.lim_a = kCausal ? min(row_a + 1, sk) : sk;
    r.lim_b = kCausal ? min(row_b + 1, sk) : sk;
    r.off_a = exp2_offset(lse_h, row_a, sq);
    r.off_b = exp2_offset(lse_h, row_b, sq);
    r.dls_a = row_a < sq ? delta_h[row_a] * scale : 0.f;
    r.dls_b = row_b < sq ? delta_h[row_b] * scale : 0.f;
    // The warpgroup's least limit: a tile that reaches it needs the mask.
    const int wg_lim = kCausal ? min(r_lo + 1, sk) : sk;
    const float sl2 = scale * kLog2e;
    float acc[D / 2];
    float s[kDqKeys / 2], dp[kDqKeys / 2];
    uint32_t ds[kDqKeys / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) s[i] = dp[i] = 0.f;

    if (n_tiles > 0) {
      mbar_wait(qg_full, 0);
      const uint32_t q_tile = base + L::kQ + wg * 64 * kRowBytes;
      const uint32_t g_tile = base + L::kG + wg * 64 * kRowBytes;
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int k0 = it * kDqKeys;
        const uint32_t k_tile = base + L::kK + st * L::kTileBytes;
        const uint32_t v_tile = base + L::kV + st * L::kTileBytes;
        mbar_wait(full(st), phase);
        // S = Q K^T and dP = G V^T, waited on together.
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        gemm_ss<D, kDqKeys>(s, q_tile, kDqRows * kRowBytes, k_tile);
        gemm_ss<D, kDqKeys>(dp, g_tile, kDqRows * kRowBytes, v_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // dQ += dS K, part by part (each part's product runs while the
        // next part's ds is computed); K (and V) are released once all
        // have completed.
        const bool mask = k0 + kDqKeys > wg_lim;
        fence_regs(acc);
        dq_part<D, 0>(mask, s, dp, ds, acc, r, k0, t, sl2, scale, k_tile);
        dq_part<D, 1>(mask, s, dp, ds, acc, r, k0, t, sl2, scale, k_tile);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        mbar_arrive(empty(st));
        if (++st == kDqStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    store_rows<D>(dq + static_cast<size_t>(bh) * sq * D, acc, row_a, sq, t);
  }
}

// One query tile of dkv, in the transposed space (rows are keys, columns
// queries): p^T in place of s^T.  Each column's base-2 offset (and, in
// dkv_ds, delta) comes from the tile's row statistics in shared memory
// (`stats`: kDkvRows offsets, then kDkvRows deltas); a thread reads those
// of its own fragment columns.  A query past sq has offset +inf (so
// p = 0), whatever the zero-filled Q and G tiles hold there.  kMask (the
// causal diagonal tiles only) zeroes p where query q0 + 8 j + 2 t + e
// precedes the key: 8 j + e against the key less q0 + 2 t.
template <bool kMask>
__device__ __forceinline__ void dkv_p(float (&s_t)[kDkvRows / 2],
                                      const float* stats, int key_a, int q0,
                                      int t, float sl2) {
  const int ca = key_a - q0 - 2 * t, cb = ca + 8;
#pragma unroll
  for (int j = 0; j < kDkvRows / 8; ++j) {
    const float2 off = *reinterpret_cast<const float2*>(stats + 8 * j +
                                                        2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float o = e ? off.y : off.x;
      float pa = fast_exp2(fmaf(s_t[4 * j + e], sl2, -o));
      float pb = fast_exp2(fmaf(s_t[4 * j + 2 + e], sl2, -o));
      if constexpr (kMask) {
        if (8 * j + e < ca) pa = 0.f;
        if (8 * j + e < cb) pb = 0.f;
      }
      s_t[4 * j + e] = pa;
      s_t[4 * j + 2 + e] = pb;
    }
  }
}

// ds^T = p^T (dp^T - delta) scale in place of dp^T, p^T from dkv_p.
__device__ __forceinline__ void dkv_ds(const float (&p_t)[kDkvRows / 2],
                                       float (&dp_t)[kDkvRows / 2],
                                       const float* stats, int t,
                                       float scale) {
#pragma unroll
  for (int j = 0; j < kDkvRows / 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(
        stats + kDkvRows + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dls = (e ? dl.y : dl.x) * scale;
      dp_t[4 * j + e] = p_t[4 * j + e] * fmaf(dp_t[4 * j + e], scale, -dls);
      dp_t[4 * j + 2 + e] =
          p_t[4 * j + 2 + e] * fmaf(dp_t[4 * j + 2 + e], scale, -dls);
    }
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(__grid_constant__ const CUtensorMap tm_q,
                 __grid_constant__ const CUtensorMap tm_g,
                 __grid_constant__ const CUtensorMap tm_k,
                 __grid_constant__ const CUtensorMap tm_v,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                 int sq, int sk, float scale) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  // The same base as a generic pointer, for the row statistics.
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + L::kBar;
  auto full = [&](int st) { return kv_full + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8 * (1 + kDkvStages + st); };
  auto stats = [&](int st) {
    return reinterpret_cast<float*>(gbase + L::kStats + st * L::kStatBytes);
  };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kDkvKeys;  // the causal-heaviest tiles first
  // Live query tiles: from the first whose last row reaches this CTA's
  // first key (q_start + kDkvRows - 1 >= k0).  None (causal, k0 >= sq):
  // the CTA still writes its zero dk and dv.
  const int qt_begin = kCausal ? k0 / kDkvRows : 0;
  const int n_tiles = max((sq + kDkvRows - 1) / kDkvRows - qt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < kDkvStages; ++st) {
      // Every producer thread arrives (one with the TMA bytes).
      mbar_init(full(st), 128);
      mbar_init(empty(st), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer warpgroup: one thread issues the TMA loads; each of the
    // 128 writes one row statistic of the tile (threads 0-63 the base-2
    // offsets of p, 64-127 the deltas), read within bounds.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kDkvProducerRegs));
    const int pt = threadIdx.x - kConsumers * 128;
    if (n_tiles > 0) {
      if (pt == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKBytes);
#pragma unroll
        for (int p = 0; p < D / kPanel; ++p) {
          tma_load(base + L::kK + p * kDkvKeys * kRowBytes, &tm_k, kv_full,
                   p * kPanel, k0, bh);
          tma_load(base + L::kV + p * kDkvKeys * kRowBytes, &tm_v, kv_full,
                   p * kPanel, k0, bh);
        }
      }
      const float* lse_h = lse + static_cast<size_t>(bh) * sq;
      const float* delta_h = delta + static_cast<size_t>(bh) * sq;
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int q0 = (qt_begin + it) * kDkvRows;
        const int qi = q0 + pt % kDkvRows;
        mbar_wait(empty(st), phase ^ 1);
        stats(st)[pt] = pt < kDkvRows ? exp2_offset(lse_h, qi, sq)
                                      : (qi < sq ? delta_h[qi] : 0.f);
        if (pt == 0) {
          mbar_expect_tx(full(st), 2 * L::kTileBytes);
#pragma unroll
          for (int p = 0; p < D / kPanel; ++p) {
            const uint32_t off = st * L::kTileBytes + p * kDkvRows * kRowBytes;
            tma_load(base + L::kQ + off, &tm_q, full(st), p * kPanel, q0, bh);
            tma_load(base + L::kG + off, &tm_g, full(st), p * kPanel, q0, bh);
          }
        } else {
          mbar_arrive(full(st));
        }
        if (++st == kDkvStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 keys each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kDkvConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const int kr_lo = k0 + wg * 64;
    const int key_a = kr_lo + warp * 16 + (lane >> 2);
    const float sl2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
    float s_t[kDkvRows / 2], dp_t[kDkvRows / 2];
    uint32_t pf[kDkvRows / 16][4], dsf[kDkvRows / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDkvRows / 2; ++i) s_t[i] = dp_t[i] = 0.f;

    if (n_tiles > 0) {
      mbar_wait(kv_full, 0);
      const uint32_t k_tile = base + L::kK + wg * 64 * kRowBytes;
      const uint32_t v_tile = base + L::kV + wg * 64 * kRowBytes;
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int q0 = (qt_begin + it) * kDkvRows;
        const uint32_t q_tile = base + L::kQ + st * L::kTileBytes;
        const uint32_t g_tile = base + L::kG + st * L::kTileBytes;
        mbar_wait(full(st), phase);
        // S^T = K Q^T and dP^T = V G^T, waited on together.
        fence_regs(s_t);
        fence_regs(dp_t);
        wgmma_fence();
        gemm_ss<D, kDkvRows>(s_t, k_tile, kDkvKeys * kRowBytes, q_tile);
        gemm_ss<D, kDkvRows>(dp_t, v_tile, kDkvKeys * kRowBytes, g_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s_t);
        fence_regs(dp_t);

        // Causal: only a tile that starts before this warpgroup's last key
        // holds a query that precedes a key.
        if (kCausal && q0 < kr_lo + 63) {
          dkv_p<true>(s_t, stats(st), key_a, q0, t, sl2);
        } else {
          dkv_p<false>(s_t, stats(st), key_a, q0, t, sl2);
        }
        // dV += P^T G and dK += dS^T Q; the stage is released once both
        // have completed.
        dkv_ds(s_t, dp_t, stats(st), t, scale);
        to_frags<kDkvRows>(pf, s_t);
        to_frags<kDkvRows>(dsf, dp_t);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
        gemm_rs<D, kDkvRows>(dv_acc, pf, g_tile);
        gemm_rs<D, kDkvRows>(dk_acc, dsf, q_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pf);
        fence_regs(dsf);
        mbar_arrive(empty(st));
        if (++st == kDkvStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    const size_t head = static_cast<size_t>(bh) * sk * D;
    store_rows<D>(dk + head, dk_acc, key_a, sk, t);
    store_rows<D>(dv + head, dv_acc, key_a, sk, t);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *out0, *out1;  // dq; or dk, dv
  int bh, sq, sk;
  float scale;
  cudaStream_t stream;
};

template <bool kDkv, int D, bool kCausal>
struct Instance {
  static auto kernel() {
    if constexpr (kDkv) {
      return flash_dkv_kernel<D, kCausal>;
    } else {
      return flash_dq_kernel<D, kCausal>;
    }
  }
  static constexpr int kSmemBytes =
      kDkv ? DkvSmem<D>::kBytes : DqSmem<D>::kBytes;

  static cudaError_t launch(const Args& a) {
    static std::atomic<uint64_t> allowed{0};
    cudaError_t err = allow_smem(kernel(), kSmemBytes, allowed);
    if (err != cudaSuccess) return err;
    // Query-side boxes (Q, G) and key-side boxes (K, V) of the CTA's
    // tiles.
    const int q_box = kDkv ? kDkvRows : kDqRows;
    const int k_box = kDkv ? kDkvKeys : kDqKeys;
    CUtensorMap tq, tg, tk, tv;
    if ((err = make_map(&tq, a.q, a.bh, a.sq, D, q_box)) != cudaSuccess ||
        (err = make_map(&tg, a.g, a.bh, a.sq, D, q_box)) != cudaSuccess ||
        (err = make_map(&tk, a.k, a.bh, a.sk, D, k_box)) != cudaSuccess ||
        (err = make_map(&tv, a.v, a.bh, a.sk, D, k_box)) != cudaSuccess) {
      return err;
    }
    const auto fn = kernel();
    if constexpr (kDkv) {
      const dim3 grid((a.sk + kDkvKeys - 1) / kDkvKeys, a.bh);
      fn<<<grid, kThreads, kSmemBytes, a.stream>>>(
          tq, tg, tk, tv, a.lse, a.delta, static_cast<uint16_t*>(a.out0),
          static_cast<uint16_t*>(a.out1), a.sq, a.sk, a.scale);
    } else {
      const dim3 grid((a.sq + kDqRows - 1) / kDqRows, a.bh);
      fn<<<grid, kThreads, kSmemBytes, a.stream>>>(
          tq, tg, tk, tv, a.lse, a.delta, static_cast<uint16_t*>(a.out0),
          a.sq, a.sk, a.scale);
    }
    return cudaGetLastError();
  }

  // info[0] registers a thread at entry (the loaded kernel's, as ptxas
  // reports them), info[1] shared memory a CTA in bytes as launched.
  static cudaError_t attributes(int* info) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel());
    if (err != cudaSuccess) return err;
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.sharedSizeBytes) + kSmemBytes;
    return cudaSuccess;
  }
};

// Call f with the instance of this kernel (dq or dkv), head_dim and mask.
template <bool kDkv, typename F>
cudaError_t with_instance(int d, bool causal, F&& f) {
  switch (d) {
    case 64:
      return causal ? f(Instance<kDkv, 64, true>())
                    : f(Instance<kDkv, 64, false>());
    case 128:
      return causal ? f(Instance<kDkv, 128, true>())
                    : f(Instance<kDkv, 128, false>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, g [bh, sq, d], k, v [bh, sk, d] contiguous, 16-byte aligned bf16;
// lse, delta [bh, sq] f32; dq [bh, sq, d] bf16.  Returns a cudaError_t;
// cudaErrorInvalidValue for a head_dim the kernel has no instance of.
int kft_flash_dq_bf16(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int d, int causal,
                      float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dq, nullptr, bh, sq, sk, scale,
               static_cast<cudaStream_t>(stream)};
  return with_instance<false>(
      d, causal != 0, [&](auto inst) { return decltype(inst)::launch(a); });
}

// As kft_flash_dq_bf16; dk, dv [bh, sk, d] bf16.
int kft_flash_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       int causal, float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale,
               static_cast<cudaStream_t>(stream)};
  return with_instance<true>(
      d, causal != 0, [&](auto inst) { return decltype(inst)::launch(a); });
}

// What the instance that the calls above launch uses (dkv 0: the dq
// kernel, 1: the dkv kernel): two ints into info, as
// Instance::attributes lists them.
int kft_flash_bwd_instance_bf16(int dkv, int d, int causal, int* info) {
  auto query = [&](auto inst) { return decltype(inst)::attributes(info); };
  return dkv ? with_instance<true>(d, causal != 0, query)
             : with_instance<false>(d, causal != 0, query);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
