// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/flash.py
// _flash_fwd_kernel (both its plain and its masked=True variant): a
// single-pass online-softmax forward over [bh, s, d] inputs that emits
// o and lse = m + log(l), skips dead key tiles (above the causal
// diagonal; before the row's first valid key when masked), zeroes p
// where the score sits at the NEG_INF sentinel, and writes o = 0,
// lse = NEG_INF for a row with no valid key.
//
// The same kernel, instanced by kPass, also replaces the two passes of the
// TPU's two-pass causal forward (_flash_fwd_two_pass, sq == sk):
//   - kFull <- _flash_fwd_full_kernel: row r attends keys
//     [0, boundary(r)) with no mask, boundary(r) = ((r / bq) * bq / bk) * bk
//     for the fitted TPU blocks bq, bk; a row with boundary 0 writes
//     o = 0, lse = NEG_INF (an empty partial);
//   - kDiag <- _flash_fwd_diag_kernel: row r attends keys
//     [boundary(r), r] under the causal mask.
// Their (o, lse) partials are merged in log space outside the kernel.
// When bq and bk are multiples of the 128-row and 128-key tiles, every
// row of a CTA shares one tile-aligned boundary and pass A carries no
// mask code at all; otherwise (kRowBounds) each row's bound is applied
// per element in the tiles it cuts.  The TPU's block sizes set nothing
// else here: the tiles are this kernel's own.
//
// What bounds it on an H100: at the training shape (bh 64, s 2048, d 128,
// causal) and at pass A of the training split, the two products' bf16
// operations at 989 TFLOP/s take longer than reading q, k, v and writing
// o once at 3.35 TB/s (0.070 and 0.035 ms against 0.040 and 0.025 ms);
// pass B and the serving shapes (bh 16-32) sit near the balance point or
// on the bytes side.  So the design is built to keep the tensor cores fed:
//   - both products on wgmma: S = Q K^T with Q and K read from shared
//     memory through matrix descriptors (both K-major, head_dim the
//     reduction), O += P V with P taken from registers (the S
//     accumulators rounded to bf16 in place: their layout is wgmma's A
//     fragment) and V as an MN-major operand ([key][d], transposed);
//   - one CTA per (bh, 128-row query tile): two consumer warpgroups of
//     64 rows each, and one producer warpgroup whose single thread issues
//     TMA loads (3-D tensor maps over [bh, s, d], so a box that runs past
//     a head's end is zero-filled instead of reading the next head) of Q
//     once and of 128-key K and V tiles into a two-stage ring with full
//     and empty mbarriers; setmaxnreg moves registers from the producer
//     (40) to the consumers (232).  Tiles are 128-byte swizzled rows of 64
//     bf16, so d 128 takes two boxes (panels) per tile;
//   - each consumer issues O += P V for tile j and S = Q K^T for tile
//     j + 1 back to back and waits once, so the tensor cores see the two
//     products together while the other warpgroup runs its softmax;
//   - mask code only in the tiles that need it: a tile wholly below the
//     diagonal, past the first valid key, inside the sequence and not cut
//     by a row bound runs the unmasked softmax (no per-element test, no
//     sentinel test); the masked one runs only on the diagonal, first-key,
//     tail and boundary tiles;
//   - the softmax works in base 2: scale * log2(e) folds into one FMA per
//     score before exp2, and lse goes back to natural log at the end.
// Every instance (single pass causal / non-causal / masked, kFull, kDiag,
// with or without row bounds, d 64 and 128) is this one mainloop.  No
// atomics: each CTA owns its rows, so results repeat bit for bit.
//
// Interface: plain C, launched on the caller's stream; returns the
// cudaError_t of the launch (0 = launched).  The tensor maps are encoded
// on the host per call (cuTensorMapEncodeTiled, fetched from the driver
// through the runtime) and passed by value as __grid_constant__.

#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace kft;

// The tiling, measured against one consumer warpgroup, 64-key tiles and
// a third stage on an H100 (PERF.md, "The tiling, measured").
constexpr int kConsumers = 2;              // warpgroups of 64 rows
constexpr int kBM = 64 * kConsumers;       // query rows per CTA
constexpr int kBN = 128;                   // keys per K / V tile
constexpr int kStages = 2;                 // K / V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);  // + producer warpgroup
// setmaxnreg rebalances the entry allotment (65536 / 384 = 168 a thread).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Dynamic shared memory of one CTA, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows): Q [D / 64 panels][kBM rows],
// then kStages K tiles and kStages V tiles [D / 64][kBN], then the
// mbarriers.
template <int D>
struct Smem {
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full; per stage k_full, k_empty, v_full, v_empty.
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + align slack
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Which keys a launch attends (see the header): all of them (the single
// pass), or one of the two passes of the two-pass causal forward.
enum Pass : int { kSingle = 0, kFull = 1, kDiag = 2 };

// First key of row r's diagonal band: the coarse boundary of the TPU's
// two-pass split for fitted blocks bq, bk.
__device__ __forceinline__ int coarse_boundary(int r, int bq, int bk) {
  return (r / bq) * bq / bk * bk;
}

// What the mask of one thread's two query rows needs.
struct KeyMask {
  int sk, start;        // keys at or past sk, or before start, are dead
  int row_a, row_b;     // this thread's rows (accumulator rows g, g + 8)
  int bnd_a, bnd_b;     // their coarse boundaries (kRowBounds)
};

template <bool kCausal, bool kMasked, int kPass, bool kRowBounds>
__device__ __forceinline__ bool dead_key(const KeyMask& km, int kj, int row,
                                         int bnd) {
  bool dead = kj >= km.sk;
  if (kMasked) dead = dead || kj < km.start;
  if (kCausal) dead = dead || kj > row;
  // Pass A: keys at or past the row's boundary are pass B's; pass B:
  // keys before it are pass A's.
  if (kRowBounds) dead = dead || (kPass == kFull ? kj >= bnd : kj < bnd);
  return dead;
}

// Running max (of the raw scores) and lane-partial sum of the two rows.
struct RowState {
  float m_a, m_b, l_a, l_b;
};

// One key tile's online softmax on the S accumulators of a thread
// (s[4 j + c] is row a, key 8 j + 2 t + c; s[4 j + 2 + c] row b): mask
// (kMask only), new row maxima, p = exp2(s * scale log2(e) - m scale
// log2(e)) in place of s, and the rescale of l and of the O accumulators.
// Without kMask every score is finite and no sentinel test is needed.
template <int D, bool kCausal, bool kMasked, int kPass, bool kRowBounds,
          bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2],
                                             float (&acc)[D / 2],
                                             RowState& rs, const KeyMask& km,
                                             int k0, int t, float sl2) {
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if constexpr (kMask) {
        const int kj = k0 + 8 * j + 2 * t + c;
        if (dead_key<kCausal, kMasked, kPass, kRowBounds>(km, kj, km.row_a,
                                                          km.bnd_a)) {
          s[4 * j + c] = kNegInf;
        }
        if (dead_key<kCausal, kMasked, kPass, kRowBounds>(km, kj, km.row_b,
                                                          km.bnd_b)) {
          s[4 * j + 2 + c] = kNegInf;
        }
      }
      mx_a = fmaxf(mx_a, s[4 * j + c]);
      mx_b = fmaxf(mx_b, s[4 * j + 2 + c]);
    }
  }
  const float mn_a = fmaxf(rs.m_a, quad_max(mx_a));
  const float mn_b = fmaxf(rs.m_b, quad_max(mx_b));
  const float ms_a = mn_a * sl2, ms_b = mn_b * sl2;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float pa = fast_exp2(fmaf(s[4 * j + c], sl2, -ms_a));
      float pb = fast_exp2(fmaf(s[4 * j + 2 + c], sl2, -ms_b));
      if constexpr (kMask) {
        // A row whose keys are all masked so far keeps m at the sentinel,
        // where exp2 would give 1 on masked entries: p is zeroed wherever
        // the score is the sentinel.
        if (!(s[4 * j + c] > kNegInf / 2)) pa = 0.f;
        if (!(s[4 * j + 2 + c] > kNegInf / 2)) pb = 0.f;
      }
      s[4 * j + c] = pa;
      s[4 * j + 2 + c] = pb;
      ps_a += pa;
      ps_b += pb;
    }
  }
  const float alpha_a = fast_exp2((rs.m_a - mn_a) * sl2);
  const float alpha_b = fast_exp2((rs.m_b - mn_b) * sl2);
  rs.l_a = alpha_a * rs.l_a + ps_a;
  rs.l_b = alpha_b * rs.l_b + ps_b;
  rs.m_a = mn_a;
  rs.m_b = mn_b;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= alpha_a;
    acc[4 * j + 1] *= alpha_a;
    acc[4 * j + 2] *= alpha_b;
    acc[4 * j + 3] *= alpha_b;
  }
}

template <int D>
__device__ __forceinline__ void wgmma_qk(float (&s)[kBN / 2], uint32_t q,
                                         uint32_t k) {
  // Head_dim in steps of 16 (32 bytes) within a 64-wide panel, then the
  // next panel.
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t dq = desc_k_major(q + (kk / 4) * kBM * kRowBytes + col);
    const uint64_t dk = desc_k_major(k + (kk / 4) * kBN * kRowBytes + col);
    wgmma_ss_n128(s, dq, dk, kk > 0);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[kBN / 16][4],
                                         uint32_t v) {
  // Keys in steps of 16 rows; all of head_dim (D / 64 panels) at once.
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t desc = desc_mn_major(v + kk * 16 * kRowBytes,
                                        kBN * kRowBytes);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, p[kk], desc);
    } else {
      wgmma_rs_n64(acc, p[kk], desc);
    }
  }
}

template <int D, bool kCausal, bool kMasked, int kPass, bool kRowBounds>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap tm_q,
                 __grid_constant__ const CUtensorMap tm_k,
                 __grid_constant__ const CUtensorMap tm_v,
                 const int32_t* __restrict__ kv_start,
                 uint16_t* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, float scale, int bq, int bk) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(kPass == kSingle || !kMasked, "two-pass takes no kv_start");
  static_assert(kPass != kSingle || !kRowBounds, "row bounds are two-pass");
  static_assert(kPass != kDiag || kCausal, "pass B is causal");
  // Pass A with CTA-uniform, tile-aligned boundaries touches no masked
  // key: no mask code, no sentinel test.
  constexpr bool kNoMask = kPass == kFull && !kRowBounds;
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kStages + st); };

  const int bh = blockIdx.y;
  // Heaviest causal tiles (last query rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int start = kMasked ? max(kv_start[bh], 0) : 0;
  // Live key tiles: none wholly before the first valid key, none wholly
  // above the diagonal of this query tile; the passes' own ranges.
  const int last = min(q0 + kBM, sq) - 1;
  int kt_begin = start / kBN;
  int kt_end = (sk + kBN - 1) / kBN;
  if (kCausal) kt_end = min(kt_end, last / kBN + 1);
  if constexpr (kPass == kFull) {
    kt_end = (coarse_boundary(last, bq, bk) + kBN - 1) / kBN;
  } else if constexpr (kPass == kDiag) {
    kt_begin = coarse_boundary(q0, bq, bk) / kBN;
  }
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), kConsumers * 128);
      mbar_init(v_full(st), 1);
      mbar_init(v_empty(st), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < D / kPanel; ++p) {
        tma_load(base + L::kQ + p * kBM * kRowBytes, &tm_q, q_full,
                 p * kPanel, q0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        const int k0 = (kt_begin + it) * kBN;
        mbar_wait(k_empty(st), phase ^ 1);
        mbar_expect_tx(k_full(st), L::kTileBytes);
#pragma unroll
        for (int p = 0; p < D / kPanel; ++p) {
          tma_load(base + L::kK + st * L::kTileBytes + p * kBN * kRowBytes,
                   &tm_k, k_full(st), p * kPanel, k0, bh);
        }
        mbar_wait(v_empty(st), phase ^ 1);
        mbar_expect_tx(v_full(st), L::kTileBytes);
#pragma unroll
        for (int p = 0; p < D / kPanel; ++p) {
          tma_load(base + L::kV + st * L::kTileBytes + p * kBN * kRowBytes,
                   &tm_v, v_full(st), p * kPanel, k0, bh);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int r_lo = q0 + wg * 64;
    KeyMask km;
    km.sk = sk;
    km.start = start;
    km.row_a = r_lo + warp * 16 + g;
    km.row_b = km.row_a + 8;
    km.bnd_a = km.bnd_b = 0;
    // Two-pass, rows of unequal boundaries in one tile: each row's own
    // (rows past the end take the last row's; they are not written), and
    // the warpgroup's least and greatest.
    int bnd_lo = 0, bnd_hi = 0;
    if constexpr (kRowBounds) {
      km.bnd_a = coarse_boundary(min(km.row_a, sq - 1), bq, bk);
      km.bnd_b = coarse_boundary(min(km.row_b, sq - 1), bq, bk);
      bnd_lo = coarse_boundary(min(r_lo, sq - 1), bq, bk);
      bnd_hi = coarse_boundary(min(r_lo + 63, sq - 1), bq, bk);
    }
    const float sl2 = scale * kLog2e;
    RowState rs = {kNegInf, kNegInf, 0.f, 0.f};
    float acc[D / 2];
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;

    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      const uint32_t q_tile = base + L::kQ + wg * 64 * kRowBytes;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        const int k0 = (kt_begin + it) * kBN;
        mbar_wait(k_full(st), phase);
        // S = Q K^T, queued behind the previous tile's O += P V.
        fence_regs(s);
        wgmma_fence();
        wgmma_qk<D>(s, q_tile, base + L::kK + st * L::kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(acc);
        mbar_arrive(k_empty(st));
        if (it > 0) mbar_arrive(v_empty((it - 1) % kStages));

        bool need_mask = false;
        if constexpr (!kNoMask) {
          need_mask = k0 + kBN > sk;
          if (kMasked) need_mask = need_mask || k0 < start;
          if (kCausal) need_mask = need_mask || k0 + kBN - 1 > r_lo;
          if (kRowBounds) {
            need_mask = need_mask ||
                (kPass == kFull ? k0 + kBN > bnd_lo : k0 < bnd_hi);
          }
        }
        if (need_mask) {
          softmax_tile<D, kCausal, kMasked, kPass, kRowBounds, true>(
              s, acc, rs, km, k0, t, sl2);
        } else {
          softmax_tile<D, kCausal, kMasked, kPass, kRowBounds, false>(
              s, acc, rs, km, k0, t, sl2);
        }
        // P (bf16) straight from the S accumulators: their layout is
        // wgmma's A fragment.
        uint32_t p[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        mbar_wait(v_full(st), phase);
        fence_regs(acc);
        wgmma_fence();
        wgmma_pv<D>(acc, p, base + L::kV + st * L::kTileBytes);
        wgmma_commit();
      }
      // The last V stage needs no release: nothing is loaded after it.
      wgmma_wait<0>();
      fence_regs(acc);
    }

    const float l_a = quad_sum(rs.l_a);
    const float l_b = quad_sum(rs.l_b);
    // A row with no valid key has l == 0 and acc == 0: o = 0,
    // lse = NEG_INF (the contract the backward and log-space merges use).
    const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
    const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
    const int row_a = km.row_a, row_b = km.row_b;
    uint16_t* o_a = o + (static_cast<size_t>(bh) * sq + row_a) * D;
    uint16_t* o_b = o_a + 8 * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row_a < sq) {
        *reinterpret_cast<uint32_t*>(o_a + col) =
            pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      }
      if (row_b < sq) {
        *reinterpret_cast<uint32_t*>(o_b + col) =
            pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
      }
    }
    if (t == 0) {
      if (row_a < sq) {
        lse[static_cast<size_t>(bh) * sq + row_a] =
            l_a == 0.f ? kNegInf : rs.m_a * scale + logf(l_a);
      }
      if (row_b < sq) {
        lse[static_cast<size_t>(bh) * sq + row_b] =
            l_b == 0.f ? kNegInf : rs.m_b * scale + logf(l_b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int32_t* kv_start;
  void* o;
  float* lse;
  int bh, sq, sk;
  float scale;
  cudaStream_t stream;
  int bq, bk;
};

template <int D, bool kCausal, bool kMasked, int kPass = kSingle,
          bool kRowBounds = false>
struct Instance {
  static cudaError_t launch(const Args& a) {
    const auto kernel = flash_fwd_kernel<D, kCausal, kMasked, kPass,
                                         kRowBounds>;
    static std::atomic<uint64_t> allowed{0};
    cudaError_t err = allow_smem(kernel, Smem<D>::kBytes, allowed);
    if (err != cudaSuccess) return err;
    CUtensorMap tq, tk, tv;
    // With no key the K / V maps are never read: q stands in for them.
    const void* kp = a.sk > 0 ? a.k : a.q;
    const void* vp = a.sk > 0 ? a.v : a.q;
    if ((err = make_map(&tq, a.q, a.bh, a.sq, D, kBM)) != cudaSuccess ||
        (err = make_map(&tk, kp, a.bh, a.sk, D, kBN)) != cudaSuccess ||
        (err = make_map(&tv, vp, a.bh, a.sk, D, kBN)) != cudaSuccess) {
      return err;
    }
    const dim3 grid((a.sq + kBM - 1) / kBM, a.bh);
    kernel<<<grid, kThreads, Smem<D>::kBytes, a.stream>>>(
        tq, tk, tv, a.kv_start, static_cast<uint16_t*>(a.o), a.lse, a.sq,
        a.sk, a.scale, a.bq, a.bk);
    return cudaGetLastError();
  }

  // info[0] registers a thread at entry (the loaded kernel's, as ptxas
  // reports them), info[1] shared memory a CTA in bytes as launched.
  static cudaError_t attributes(int* info) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(
        &attr, flash_fwd_kernel<D, kCausal, kMasked, kPass, kRowBounds>);
    if (err != cudaSuccess) return err;
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.sharedSizeBytes) + Smem<D>::kBytes;
    return cudaSuccess;
  }
};

// Per-row bounds unless every 128-row tile has one boundary that is a
// multiple of the 128-key tile (bq and bk both multiples of the tiles).
bool needs_row_bounds(int bq, int bk) { return bq % kBM != 0 || bk % kBN != 0; }

// Call f with the instance for these flags: the single pass (causal or
// not, masked or not), or one pass of the two-pass forward (kFull
// without a causal mask, kDiag with it, each with or without row bounds).
template <int D, typename F>
cudaError_t with_instance(bool causal, bool masked, int pass, bool row_bounds,
                          F&& f) {
  if (pass == kFull) {
    return row_bounds ? f(Instance<D, false, false, kFull, true>())
                      : f(Instance<D, false, false, kFull, false>());
  }
  if (pass == kDiag) {
    return row_bounds ? f(Instance<D, true, false, kDiag, true>())
                      : f(Instance<D, true, false, kDiag, false>());
  }
  if (causal) {
    return masked ? f(Instance<D, true, true>()) : f(Instance<D, true, false>());
  }
  return masked ? f(Instance<D, false, true>()) : f(Instance<D, false, false>());
}

template <typename F>
cudaError_t with_head_dim(int d, bool causal, bool masked, int pass,
                          bool row_bounds, F&& f) {
  switch (d) {
    case 64:
      return with_instance<64>(causal, masked, pass, row_bounds, f);
    case 128:
      return with_instance<128>(causal, masked, pass, row_bounds, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned bf16;
// kv_start [bh] int32 or NULL; o [bh, sq, d] bf16, lse [bh, sq] f32.
// Returns a cudaError_t; cudaErrorInvalidValue for a head_dim the kernel
// has no instance of.
int kft_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const int32_t* kv_start, void* o, float* lse, int bh,
                       int sq, int sk, int d, int causal, float scale,
                       void* stream) {
  const Args a{q, k, v, kv_start, o, lse, bh, sq, sk, scale,
               static_cast<cudaStream_t>(stream), 0, 0};
  return with_head_dim(d, causal != 0, kv_start != nullptr, kSingle, false,
                       [&](auto inst) { return decltype(inst)::launch(a); });
}

// One pass of the two-pass causal forward over q, k, v [bh, s, d]
// contiguous bf16: pass 1 (keys before each row's coarse boundary) or
// pass 2 (keys from it up to the row), for the fitted TPU blocks bq, bk
// (each dividing s); o [bh, s, d] bf16, lse [bh, s] f32.  Returns a
// cudaError_t; cudaErrorInvalidValue for another pass, a block that is
// not positive, or a head_dim the kernel has no instance of.
int kft_flash_fwd_pass_bf16(const void* q, const void* k, const void* v,
                            void* o, float* lse, int bh, int s, int d,
                            int pass, int bq, int bk, float scale,
                            void* stream) {
  if ((pass != kFull && pass != kDiag) || bq <= 0 || bk <= 0) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, k, v, nullptr, o, lse, bh, s, s, scale,
               static_cast<cudaStream_t>(stream), bq, bk};
  return with_head_dim(d, pass == kDiag, false, pass,
                       needs_row_bounds(bq, bk),
                       [&](auto inst) { return decltype(inst)::launch(a); });
}

// What the instance that the calls above launch for these arguments
// uses (pass 0 = the single pass; bq, bk only for passes 1 and 2): two
// ints into info, as Instance::attributes lists them.
int kft_flash_fwd_instance_bf16(int d, int causal, int masked, int pass,
                                int bq, int bk, int* info) {
  if (pass != kSingle && (bq <= 0 || bk <= 0)) return cudaErrorInvalidValue;
  const bool row_bounds = pass != kSingle && needs_row_bounds(bq, bk);
  return with_head_dim(
      d, causal != 0 || pass == kDiag, masked != 0, pass, row_bounds,
      [&](auto inst) { return decltype(inst)::attributes(info); });
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
