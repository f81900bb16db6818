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
// What bounds it: at the serving prefill shape (s = 2048, d = 128) a full
// causal forward does 2*bh*s*s*d operations, which at the card's bf16
// tensor-core rate take longer than moving q, k, v and o through device
// memory once; a left-padded batch skips its pad rows and sits near the
// balance point.  This design is simple and right first:
//   - one CTA of 4 warps per (bh, 64-row query tile); each warp owns
//     16 query rows, so every row's m and l live in one quad of lanes,
//     and its Q fragments stay in registers for the whole key loop;
//   - 64-key K and V tiles in shared memory, loaded with cp.async
//     (16 bytes a thread, zero-filled past the sequence end) so that the
//     V tile lands while S = Q K^T and the softmax run, and the next K
//     tile while O += P V runs;
//   - both products on mma.sync m16n8k16 (bf16 -> f32) with their B
//     fragments from ldmatrix (transposed for V); P is taken straight
//     from the S accumulators (their C layout is the A layout of the
//     next product), f32 accumulators in registers.
// TMA, wgmma, deeper pipelines and warp specialisation are later work.
// The tiles are this kernel's own: the TPU block sizes
// (cfg.flash_block_q / flash_block_k) are not used here.
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
// On the TPU the split saved the masked work of (512, 1024) blocks on the
// diagonal; here the 64-key tiles already waste little there, so each
// pass does about half the single pass's work, at the same tiles.  The
// TPU's fine band tiles (block_diag) set nothing here.  When bq and bk
// are multiples of the 64-row tile, every row of a CTA shares one
// 64-aligned boundary, and pass A carries no mask code at all; otherwise
// (kRowBounds) each row's bound is applied per element in the tiles it
// cuts.
//
// Interface: plain C, launched on the caller's stream; returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr int kWarps = 4;     // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 pad per smem row: conflict-free ldmatrix
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the sentinel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and register j receives this lane's pair of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two floats -> packed bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Start copying rows [row0, row0 + 64) of a [rows, D] bf16 matrix into
// smem; rows at or past `rows` become zero, so masked keys multiply
// finite values.
template <int D>
__device__ __forceinline__ void load_tile_async(uint16_t (*dst)[D + kPad],
                                                const uint16_t* __restrict__ src,
                                                int row0, int rows) {
  constexpr int kVec = 8;  // bf16 per 16-byte copy
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool valid = row0 + r < rows;
    cp_async_16(&dst[r][c],
                src + static_cast<size_t>(valid ? row0 + r : 0) * D + c,
                valid);
  }
}

// Which keys a launch attends (see the header): all of them (the single
// pass), or one of the two passes of the two-pass causal forward.
enum Pass : int { kSingle = 0, kFull = 1, kDiag = 2 };

// First key of row r's diagonal band: the coarse boundary of the TPU's
// two-pass split for fitted blocks bq, bk.
__device__ __forceinline__ int coarse_boundary(int r, int bq, int bk) {
  return (r / bq) * bq / bk * bk;
}

template <int D, bool kCausal, bool kMasked, int kPass, bool kRowBounds>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q,
                 const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v,
                 const int32_t* __restrict__ kv_start,
                 uint16_t* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, float scale, int bq, int bk) {
  static_assert(kPass == kSingle || !kMasked, "two-pass takes no kv_start");
  static_assert(kPass != kSingle || !kRowBounds, "row bounds are two-pass");
  static_assert(kPass != kDiag || kCausal, "pass B is causal");
  // Pass A with CTA-uniform, tile-aligned boundaries touches no masked
  // key: no mask code, no sentinel test.
  constexpr bool kNoMask = kPass == kFull && !kRowBounds;
  __shared__ __align__(16) uint16_t ks[kBK][D + kPad];
  __shared__ __align__(16) uint16_t vs[kBK][D + kPad];

  const int bh = blockIdx.y;
  // Heaviest causal tiles (last query rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wr = warp * 16;

  const uint16_t* qh = q + static_cast<size_t>(bh) * sq * D;
  const uint16_t* kh = k + static_cast<size_t>(bh) * sk * D;
  const uint16_t* vh = v + static_cast<size_t>(bh) * sk * D;

  const int start = kMasked ? kv_start[bh] : 0;
  // Live key tiles: none wholly before the first valid key, none wholly
  // above the diagonal of this query tile.
  int kt_begin = kMasked ? max(start, 0) / kBK : 0;
  int kt_end = (sk + kBK - 1) / kBK;
  if (kCausal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  if constexpr (kPass == kFull) {
    // Keys before the largest boundary of the tile's rows.
    const int last = min(q0 + kBQ, sq) - 1;
    kt_end = (coarse_boundary(last, bq, bk) + kBK - 1) / kBK;
  } else if constexpr (kPass == kDiag) {
    kt_begin = coarse_boundary(q0, bq, bk) / kBK;
  }

  // Stage this CTA's query tile through the K buffer and keep each
  // warp's 16 rows as mma A fragments for the whole key loop (a CTA with
  // no live key tile, as pass A's first rows, needs none).
  uint32_t qf[D / 16][4];
  if (kt_begin < kt_end) {
    load_tile_async<D>(ks, qh, q0, sq);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(&ks[wr + g][c]);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(&ks[wr + g + 8][c]);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(&ks[wr + g][c + 8]);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(&ks[wr + g + 8][c + 8]);
    }
    __syncthreads();
  }

  const int row_a = q0 + wr + g;  // this lane's two query rows
  const int row_b = row_a + 8;
  // Two-pass, rows of unequal boundaries in one tile: each row's own
  // (rows past the end take the last row's; they are not written).
  int bnd_a = 0, bnd_b = 0;
  if constexpr (kRowBounds) {
    bnd_a = coarse_boundary(min(row_a, sq - 1), bq, bk);
    bnd_b = coarse_boundary(min(row_b, sq - 1), bq, bk);
  }
  float m_a = kNegInf, m_b = kNegInf;
  float l_a = 0.f, l_b = 0.f;  // lane-partial sums, reduced at the end
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  // Copy groups in flight at the top of each iteration: K(kt), V(kt).
  if (kt_begin < kt_end) {
    load_tile_async<D>(ks, kh, kt_begin * kBK, sk);
    cp_async_commit();
    load_tile_async<D>(vs, vh, kt_begin * kBK, sk);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane (see ldmatrix_x4): for K, row
  // lane % 8 of an 8-key slab at d offset 8 * (lane / 8); for V, key
  // row 8 * ((lane / 8) % 2) + lane % 8 at d offset 8 * (lane / 16).
  const int k_row = lane & 7, k_col = (lane >> 3) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    const bool more = kt + 1 < kt_end;
    cp_async_wait<1>();  // K(kt) has landed
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, &ks[nt * 8 + k_row][kk * 16 + k_col]);
        mma_bf16_16816(s[nt], qf[kk], b[0], b[1]);
        mma_bf16_16816(s[nt], qf[kk + 1], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done reading ks
    if (more) load_tile_async<D>(ks, kh, k0 + kBK, sk);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    // Scale, mask to the sentinel, and take the tile's row maxima.
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sa = s[nt][e] * scale;
        float sb = s[nt][2 + e] * scale;
        if constexpr (!kNoMask) {
          const int kj = k0 + nt * 8 + t * 2 + e;
          const bool dead = kj >= sk || (kMasked && kj < start);
          bool dead_a = dead || (kCausal && kj > row_a);
          bool dead_b = dead || (kCausal && kj > row_b);
          if constexpr (kRowBounds) {
            // Pass A: keys at or past the row's boundary are pass B's;
            // pass B: keys before it are pass A's.
            dead_a = dead_a || (kPass == kFull ? kj >= bnd_a : kj < bnd_a);
            dead_b = dead_b || (kPass == kFull ? kj >= bnd_b : kj < bnd_b);
          }
          if (dead_a) sa = kNegInf;
          if (dead_b) sb = kNegInf;
        }
        s[nt][e] = sa;
        s[nt][2 + e] = sb;
        mx_a = fmaxf(mx_a, sa);
        mx_b = fmaxf(mx_b, sb);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // A row whose keys are all masked so far keeps m at the sentinel;
    // exp(s - m) would then be exp(0) = 1 on masked entries, so p is
    // zeroed wherever the score is the sentinel.
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sa = s[nt][e], sb = s[nt][2 + e];
        const float pa =
            kNoMask || sa > kNegInf / 2 ? __expf(sa - mn_a) : 0.f;
        const float pb =
            kNoMask || sb > kNegInf / 2 ? __expf(sb - mn_b) : 0.f;
        s[nt][e] = pa;
        s[nt][2 + e] = pb;
        ps_a += pa;
        ps_b += pb;
      }
    }
    const float alpha_a = __expf(m_a - mn_a);
    const float alpha_b = __expf(m_b - mn_b);
    l_a = alpha_a * l_a + ps_a;
    l_b = alpha_b * l_b + ps_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha_a;
      acc[dt][1] *= alpha_a;
      acc[dt][2] *= alpha_b;
      acc[dt][3] *= alpha_b;
    }

    cp_async_wait<1>();  // V(kt) has landed; K(kt + 1) may still fly
    __syncthreads();

    // O += P V: P (bf16) from the S accumulators, V fragments by
    // transposed ldmatrix, two 8-column d tiles per load.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &vs[kk * 16 + v_row][dt * 8 + v_col]);
        mma_bf16_16816(acc[dt], pa, b[0], b[1]);
        mma_bf16_16816(acc[dt + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done reading vs
    if (more) load_tile_async<D>(vs, vh, k0 + kBK, sk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // A row with no valid key has l == 0 and acc == 0: o = 0,
  // lse = NEG_INF (the contract the backward and log-space merges use).
  const float safe_a = l_a == 0.f ? 1.f : l_a;
  const float safe_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row_a < sq) {
      *reinterpret_cast<uint32_t*>(
          o + (static_cast<size_t>(bh) * sq + row_a) * D + col) =
          pack_bf16(acc[dt][0] / safe_a, acc[dt][1] / safe_a);
    }
    if (row_b < sq) {
      *reinterpret_cast<uint32_t*>(
          o + (static_cast<size_t>(bh) * sq + row_b) * D + col) =
          pack_bf16(acc[dt][2] / safe_b, acc[dt][3] / safe_b);
    }
  }
  if (t == 0) {
    if (row_a < sq) {
      lse[static_cast<size_t>(bh) * sq + row_a] =
          l_a == 0.f ? kNegInf : m_a + logf(safe_a);
    }
    if (row_b < sq) {
      lse[static_cast<size_t>(bh) * sq + row_b] =
          l_b == 0.f ? kNegInf : m_b + logf(safe_b);
    }
  }
}

template <int D, bool kCausal, bool kMasked, int kPass = kSingle,
          bool kRowBounds = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* kv_start, void* o, float* lse, int bh,
                   int sq, int sk, float scale, cudaStream_t stream,
                   int bq = 0, int bk = 0) {
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<D, kCausal, kMasked, kPass, kRowBounds>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
          static_cast<const uint16_t*>(v), kv_start,
          static_cast<uint16_t*>(o), lse, sq, sk, scale, bq, bk);
  return cudaGetLastError();
}

// One pass of the two-pass forward: kFull without a causal mask, kDiag
// with it; per-row bounds unless every 64-row tile has one 64-aligned
// boundary (bq and bk both multiples of the tiles).
template <int D>
cudaError_t dispatch_pass(const void* q, const void* k, const void* v,
                          void* o, float* lse, int bh, int s, int pass,
                          int bq, int bk, float scale, cudaStream_t stream) {
  const bool row_bounds = bq % kBQ != 0 || bk % kBK != 0;
  if (pass == kFull) {
    return row_bounds
        ? launch<D, false, false, kFull, true>(q, k, v, nullptr, o, lse, bh,
                                               s, s, scale, stream, bq, bk)
        : launch<D, false, false, kFull, false>(q, k, v, nullptr, o, lse,
                                                bh, s, s, scale, stream, bq,
                                                bk);
  }
  return row_bounds
      ? launch<D, true, false, kDiag, true>(q, k, v, nullptr, o, lse, bh, s,
                                            s, scale, stream, bq, bk)
      : launch<D, true, false, kDiag, false>(q, k, v, nullptr, o, lse, bh, s,
                                             s, scale, stream, bq, bk);
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int32_t* kv_start, void* o, float* lse, int bh,
                     int sq, int sk, int causal, float scale,
                     cudaStream_t stream) {
  if (causal) {
    return kv_start ? launch<D, true, true>(q, k, v, kv_start, o, lse, bh,
                                            sq, sk, scale, stream)
                    : launch<D, true, false>(q, k, v, kv_start, o, lse, bh,
                                             sq, sk, scale, stream);
  }
  return kv_start ? launch<D, false, true>(q, k, v, kv_start, o, lse, bh, sq,
                                           sk, scale, stream)
                  : launch<D, false, false>(q, k, v, kv_start, o, lse, bh,
                                            sq, sk, scale, stream);
}

}  // namespace

extern "C" {

// q [bh, sq, d], k/v [bh, sk, d] contiguous bf16; kv_start [bh] int32 or
// NULL; o [bh, sq, d] bf16, lse [bh, sq] f32.  Returns a cudaError_t;
// cudaErrorInvalidValue for a head_dim the kernel has no instance of.
int kft_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const int32_t* kv_start, void* o, float* lse, int bh,
                       int sq, int sk, int d, int causal, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dispatch<64>(q, k, v, kv_start, o, lse, bh, sq, sk, causal,
                          scale, s);
    case 128:
      return dispatch<128>(q, k, v, kv_start, o, lse, bh, sq, sk, causal,
                           scale, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((pass != kFull && pass != kDiag) || bq <= 0 || bk <= 0) {
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 64:
      return dispatch_pass<64>(q, k, v, o, lse, bh, s, pass, bq, bk, scale,
                               st);
    case 128:
      return dispatch_pass<128>(q, k, v, o, lse, bh, s, pass, bq, bk, scale,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
