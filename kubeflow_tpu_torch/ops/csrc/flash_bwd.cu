// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the Pallas TPU kernels of kubeflow_tpu/ops/flash.py launched by
// _flash_bwd_bhsd:
//   - flash_dq_kernel  <- _flash_dq_kernel:  dq = sum_k ds k
//   - flash_dkv_kernel <- _flash_dkv_kernel: dv = sum_q p^T g,
//                                            dk = sum_q ds^T q
// with, per (query, key) pair, s = q.k * scale (masked to NEG_INF above
// the causal diagonal), p = exp(s - lse) (0 where lse is the NEG_INF
// sentinel of a row with no valid key), dp = g.v and
// ds = p * (dp - delta) * scale rounded to bf16 before its product; p is
// rounded to bf16 before dv's.  lse is the forward's m + log(l) and
// delta = rowsum(g * o), both float32 and computed outside the kernels.
//
// What bounds them: at the training shape (bh 64, s 2048, d 128, causal)
// the dq kernel does three products per live (query, key) pair (s, dp,
// dq: 6 d operations) and the dkv kernel four (s, dp, dv, dk: 8 d), which
// at the card's bf16 tensor-core rate take about twice as long as moving
// q, k, v, g and the gradients through device memory once.  This design is
// simple and right first:
//   - the TPU's sequential innermost grid axis becomes a loop inside the
//     CTA: one CTA of 4 warps per (bh, 64-row tile), no atomics, so the
//     gradients are the same from run to run;
//   - dq: each warp owns 16 query rows whose Q and G fragments stay in
//     registers; 64-key K and V tiles are double-buffered in shared memory
//     by cp.async (zero-filled past the sequence end), so the next tile
//     lands while this one is used;
//   - dkv: each warp owns 16 key rows of the CTA's K and V tiles, which
//     stay in shared memory for the whole loop (their mma A fragments are
//     read by ldmatrix where used, which keeps the two [16, d] float32
//     accumulators of dk and dv in registers without spilling at d 128);
//     64-query Q and G tiles are double-buffered and walked from the
//     first tile that reaches the causal diagonal; it works in the
//     transposed [keys, queries] space of the Pallas kernel, so no
//     fragment is ever transposed in registers;
//   - every product is mma.sync m16n8k16 (bf16 -> f32); each 16-column
//     slab of p or ds is fed to the next product straight from the
//     accumulators (their C layout is the next product's A layout);
//   - any length: tails are zero-filled and masked per element, without
//     the TPU's divisor search (_fit_block).
// A fused single kernel (dq by atomics), wgmma, TMA and warp
// specialisation are later work.
//
// Interface: plain C, launched on the caller's stream; each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // key rows per tile
constexpr int kWarps = 4;     // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 pad per smem row: conflict-free ldmatrix
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the sentinel

static_assert(kBQ == kBK, "the causal tile walk assumes square tiles");

template <int D>
using Row = uint16_t[D + kPad];

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

// Start copying rows [row0, row0 + 64) of a [rows, D] bf16 matrix into
// smem; rows at or past `rows` become zero.
template <int D>
__device__ __forceinline__ void load_tile_async(Row<D>* dst,
                                                const uint16_t* __restrict__ src,
                                                int row0, int rows) {
  constexpr int kVec = 8;  // bf16 per 16-byte copy
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool valid = row0 + r < rows;
    cp_async_16(&dst[r][c],
                src + static_cast<size_t>(valid ? row0 + r : 0) * D + c,
                valid);
  }
}

// mma A fragments (16 rows x D) of rows [r0, r0 + 16) of a smem tile,
// read straight from shared memory: fragment kk covers columns
// [16 kk, 16 kk + 16).
template <int D>
__device__ __forceinline__ void row_fragments(uint32_t f[][4],
                                              Row<D>* tile, int r0) {
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g][c]);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g + 8][c]);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g][c + 8]);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(&tile[r0 + g + 8][c + 8]);
  }
}

// acc[2][4] += A (this warp's 16 rows, fragments a[kk]) times the
// transpose of rows [n0, n0 + 16) of `tile` (B from ldmatrix): a
// [16 rows, 16 columns] slab of A tile^T.
template <int D>
__device__ __forceinline__ void slab_from_regs(float acc[2][4],
                                               uint32_t a[][4],
                                               Row<D>* tile, int n0) {
  const int lane = threadIdx.x % 32;
  const int b_row = lane & 7, b_col = (lane >> 3) * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, &tile[n0 + j * 8 + b_row][kk * 16 + b_col]);
      mma_bf16_16816(acc[j], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[j], a[kk + 1], b[2], b[3]);
    }
  }
}

// As slab_from_regs, with A = rows [r0, r0 + 16) of smem tile `at`
// (fragments by ldmatrix, two 16-column steps per pass).
template <int D>
__device__ __forceinline__ void slab_from_smem(float acc[2][4],
                                               Row<D>* at, int r0,
                                               Row<D>* tile, int n0) {
  const int lane = threadIdx.x % 32;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = lane & 7, b_col = (lane >> 3) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; kk += 2) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, &at[r0 + a_row][kk * 16 + a_col]);
    ldmatrix_x4(a1, &at[r0 + a_row][(kk + 1) * 16 + a_col]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, &tile[n0 + j * 8 + b_row][kk * 16 + b_col]);
      mma_bf16_16816(acc[j], a0, b[0], b[1]);
      mma_bf16_16816(acc[j], a1, b[2], b[3]);
    }
  }
}

// acc[D/8][4] += A (16 x 16, fragment a) times rows [r0, r0 + 16) of
// `tile` (16 x D, B by transposed ldmatrix).
template <int D>
__device__ __forceinline__ void accumulate_rows(float acc[][4],
                                                const uint32_t a[4],
                                                Row<D>* tile, int r0) {
  const int lane = threadIdx.x % 32;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int v_col = (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; dt += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, &tile[r0 + v_row][dt * 8 + v_col]);
    mma_bf16_16816(acc[dt], a, b[0], b[1]);
    mma_bf16_16816(acc[dt + 1], a, b[2], b[3]);
  }
}

// The bf16 A fragment of a [16, 16] slab held as two C fragments.
__device__ __forceinline__ void slab_to_a(uint32_t a[4], float c[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// Write a warp's [16, D] float32 accumulator as bf16 rows r_a, r_a + 8
// of a [rows, D] matrix.
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* __restrict__ out,
                                           float acc[][4], int row_a,
                                           int rows) {
  const int t = threadIdx.x & 3;
  const int row_b = row_a + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row_a < rows) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_a) * D +
                                   col) = pack_bf16(acc[dt][0], acc[dt][1]);
    }
    if (row_b < rows) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_b) * D +
                                   col) = pack_bf16(acc[dt][2], acc[dt][3]);
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * kBK * static_cast<int>(sizeof(Row<D>));  // K, V double-buffered
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V once; Q, G double-buffered; lse and delta of one query tile.
  return 6 * kBK * static_cast<int>(sizeof(Row<D>)) +
         2 * kBQ * static_cast<int>(sizeof(float));
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const uint16_t* __restrict__ q,
                const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                uint16_t* __restrict__ dq, int sq, int sk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row<D>* ks = reinterpret_cast<Row<D>*>(smem);  // [2][kBK]
  Row<D>* vs = ks + 2 * kBK;                     // [2][kBK]

  const int bh = blockIdx.y;
  // Heaviest causal tiles (last query rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int wr = warp * 16;

  const uint16_t* qh = q + static_cast<size_t>(bh) * sq * D;
  const uint16_t* gh = g + static_cast<size_t>(bh) * sq * D;
  const uint16_t* kh = k + static_cast<size_t>(bh) * sk * D;
  const uint16_t* vh = v + static_cast<size_t>(bh) * sk * D;

  // Stage this CTA's Q and G tiles through the K and V buffers and keep
  // each warp's 16 rows of both as mma A fragments for the key loop.
  load_tile_async<D>(ks, qh, q0, sq);
  load_tile_async<D>(vs, gh, q0, sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
  row_fragments<D>(qf, ks, wr);
  row_fragments<D>(gf, vs, wr);
  __syncthreads();

  const int row_a = q0 + wr + (lane >> 2);  // this lane's two query rows
  const int row_b = row_a + 8;
  const size_t base = static_cast<size_t>(bh) * sq;
  // Rows past sq read as the sentinel: their p is 0.
  const float lse_a = row_a < sq ? lse[base + row_a] : kNegInf;
  const float lse_b = row_b < sq ? lse[base + row_b] : kNegInf;
  const float dl_a = row_a < sq ? delta[base + row_a] : 0.f;
  const float dl_b = row_b < sq ? delta[base + row_b] : 0.f;
  const bool fin_a = lse_a > kNegInf / 2;
  const bool fin_b = lse_b > kNegInf / 2;

  // Live key tiles: none wholly above the diagonal of this query tile.
  int kt_end = (sk + kBK - 1) / kBK;
  if (kCausal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  if (kt_end > 0) {
    load_tile_async<D>(ks, kh, 0, sk);
    load_tile_async<D>(vs, vh, 0, sk);
  }
  cp_async_commit();
  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = kt & 1;
    // The other buffer was released by the barrier that ended the last
    // iteration: fill it with the next tile while this one is used.
    if (kt + 1 < kt_end) {
      load_tile_async<D>(ks + (buf ^ 1) * kBK, kh, (kt + 1) * kBK, sk);
      load_tile_async<D>(vs + (buf ^ 1) * kBK, vh, (kt + 1) * kBK, sk);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    Row<D>* kb = ks + buf * kBK;
    Row<D>* vb = vs + buf * kBK;
    const int k0 = kt * kBK;

#pragma unroll 1
    for (int c = 0; c < kBK / 16; ++c) {
      // s = q k^T and dp = g v^T for 16 keys.
      float s[2][4] = {}, dp[2][4] = {};
      slab_from_regs<D>(s, qf, kb, c * 16);
      slab_from_regs<D>(dp, gf, vb, c * 16);
      // ds = p (dp - delta) scale, p = exp(s scale - lse), dead pairs 0.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + c * 16 + j * 8 + t * 2 + e;
          const bool live_a = fin_a && kj < sk && (!kCausal || kj <= row_a);
          const bool live_b = fin_b && kj < sk && (!kCausal || kj <= row_b);
          const float pa = live_a ? __expf(s[j][e] * scale - lse_a) : 0.f;
          const float pb = live_b ? __expf(s[j][2 + e] * scale - lse_b) : 0.f;
          s[j][e] = pa * (dp[j][e] - dl_a) * scale;
          s[j][2 + e] = pb * (dp[j][2 + e] - dl_b) * scale;
        }
      }
      // dq += ds k.
      uint32_t da[4];
      slab_to_a(da, s);
      accumulate_rows<D>(acc, da, kb, c * 16);
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();
  store_rows<D>(dq + base * D, acc, row_a, sq);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const uint16_t* __restrict__ q,
                 const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v,
                 const uint16_t* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                 int sq, int sk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row<D>* ks = reinterpret_cast<Row<D>*>(smem);  // [kBK]
  Row<D>* vs = ks + kBK;                         // [kBK]
  Row<D>* qs = vs + kBK;                         // [2][kBQ]
  Row<D>* gs = qs + 2 * kBQ;                     // [2][kBQ]
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kBQ);  // [kBQ]
  float* delta_s = lse_s + kBQ;                           // [kBQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;  // the causal-heaviest tiles come first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int wr = warp * 16;

  const uint16_t* qh = q + static_cast<size_t>(bh) * sq * D;
  const uint16_t* gh = g + static_cast<size_t>(bh) * sq * D;
  const uint16_t* kh = k + static_cast<size_t>(bh) * sk * D;
  const uint16_t* vh = v + static_cast<size_t>(bh) * sk * D;
  const float* lh = lse + static_cast<size_t>(bh) * sq;
  const float* dh = delta + static_cast<size_t>(bh) * sq;

  // Live query tiles: from the first whose last row reaches this key
  // tile's first key (q_start + kBQ - 1 >= k0).
  const int qt_begin = kCausal ? k0 / kBQ : 0;
  const int qt_end = (sq + kBQ - 1) / kBQ;

  load_tile_async<D>(ks, kh, k0, sk);
  load_tile_async<D>(vs, vh, k0, sk);
  if (qt_begin < qt_end) {
    load_tile_async<D>(qs, qh, qt_begin * kBQ, sq);
    load_tile_async<D>(gs, gh, qt_begin * kBQ, sq);
  }
  cp_async_commit();

  const int key_a = k0 + wr + (lane >> 2);  // this lane's two key rows
  const int key_b = key_a + 8;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dt][i] = dv_acc[dt][i] = 0.f;
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    const int q0 = qt * kBQ;
    if (qt + 1 < qt_end) {
      load_tile_async<D>(qs + (buf ^ 1) * kBQ, qh, q0 + kBQ, sq);
      load_tile_async<D>(gs + (buf ^ 1) * kBQ, gh, q0 + kBQ, sq);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    // This tile's lse and delta by column; queries past sq read as the
    // sentinel, so their p is 0.
    if (threadIdx.x < kBQ) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < sq ? lh[qi] : kNegInf;
      delta_s[threadIdx.x] = qi < sq ? dh[qi] : 0.f;
    }
    cp_async_wait<1>();  // tile qt (and K, V) have landed
    __syncthreads();
    Row<D>* qb = qs + buf * kBQ;
    Row<D>* gb = gs + buf * kBQ;

#pragma unroll 1
    for (int c = 0; c < kBQ / 16; ++c) {
      // Transposed space, 16 keys x 16 queries: s_t = k q^T and
      // dp_t = v g^T.
      float st[2][4] = {}, dpt[2][4] = {};
      slab_from_smem<D>(st, ks, wr, qb, c * 16);
      slab_from_smem<D>(dpt, vs, wr, gb, c * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * 16 + j * 8 + t * 2 + e;
          const int qi = q0 + col;
          const float l = lse_s[col];
          const float dl = delta_s[col];
          const bool fin = l > kNegInf / 2;
          const bool live_a = fin && (!kCausal || qi >= key_a);
          const bool live_b = fin && (!kCausal || qi >= key_b);
          const float pa = live_a ? __expf(st[j][e] * scale - l) : 0.f;
          const float pb = live_b ? __expf(st[j][2 + e] * scale - l) : 0.f;
          st[j][e] = pa;
          st[j][2 + e] = pb;
          dpt[j][e] = pa * (dpt[j][e] - dl) * scale;
          dpt[j][2 + e] = pb * (dpt[j][2 + e] - dl) * scale;
        }
      }
      // dv += p_t g and dk += ds_t q over these 16 queries.
      uint32_t pf[4], dsf[4];
      slab_to_a(pf, st);
      slab_to_a(dsf, dpt);
      accumulate_rows<D>(dv_acc, pf, gb, c * 16);
      accumulate_rows<D>(dk_acc, dsf, qb, c * 16);
    }
    __syncthreads();  // every warp is done with this buffer and lse_s
  }
  cp_async_wait<0>();
  const size_t base = static_cast<size_t>(bh) * sk * D;
  store_rows<D>(dk + base, dk_acc, key_a, sk);
  store_rows<D>(dv + base, dv_acc, key_a, sk);
}

template <int D, bool kCausal>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_dq_kernel<D, kCausal>;
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(g), lse,
      delta, static_cast<uint16_t*>(dq), sq, sk, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int sq, int sk,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<D, kCausal>;
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBK - 1) / kBK, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(g), lse,
      delta, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), sq, sk,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, g [bh, sq, d], k, v [bh, sk, d] contiguous bf16; lse, delta [bh, sq]
// f32; dq [bh, sq, d] bf16.  Returns a cudaError_t;
// cudaErrorInvalidValue for a head_dim the kernel has no instance of.
int kft_flash_dq_bf16(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int d, int causal,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return causal ? launch_dq<64, true>(q, k, v, g, lse, delta, dq, bh, sq,
                                          sk, scale, s)
                    : launch_dq<64, false>(q, k, v, g, lse, delta, dq, bh,
                                           sq, sk, scale, s);
    case 128:
      return causal ? launch_dq<128, true>(q, k, v, g, lse, delta, dq, bh,
                                           sq, sk, scale, s)
                    : launch_dq<128, false>(q, k, v, g, lse, delta, dq, bh,
                                            sq, sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// As kft_flash_dq_bf16; dk, dv [bh, sk, d] bf16.
int kft_flash_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return causal ? launch_dkv<64, true>(q, k, v, g, lse, delta, dk, dv,
                                           bh, sq, sk, scale, s)
                    : launch_dkv<64, false>(q, k, v, g, lse, delta, dk, dv,
                                            bh, sq, sk, scale, s);
    case 128:
      return causal ? launch_dkv<128, true>(q, k, v, g, lse, delta, dk, dv,
                                            bh, sq, sk, scale, s)
                    : launch_dkv<128, false>(q, k, v, g, lse, delta, dk, dv,
                                             bh, sq, sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
