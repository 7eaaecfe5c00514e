// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces the two TPU kernels of dmlc_tpu/ops/flash_attention.py's
// `_flash_backward`: `_bwd_dkv_kernel` (pallas_call at :475) and
// `_bwd_dq_kernel` (pallas_call at :501).  Both recompute the normalised
// probabilities from the forward's saved log-sum-exp instead of keeping
// any T x T matrix:
//
//   P  = exp(S * scale - lse)           S = Q K^T
//   dV = P^T dO                         (dkv kernel)
//   dS = P o (dO V^T - delta)           delta = rowsum(dO o O), from torch
//   dK = scale * dS^T Q                 (dkv kernel)
//   dQ = scale * dS K                   (dq kernel)
//
// What bounds it on this card: four (dkv) or three (dq) products of a
// 64x64 tile against D per visible (q, k) pair, 8*D and 6*D FLOPs.  At
// the flagship train shape (B=8, H=16, T=1024, D=128, bf16, causal,
// 524,800 visible pairs per (b, h)) that is 68.8 and 51.6 GFLOP, 0.070
// and 0.052 ms on the bf16 tensor cores, against ~0.06 and ~0.05 ms to
// move q, dO, k, v, lse, delta and the gradients once at 3.35 TB/s: both
// are bound by operations, so the products belong on the tensor cores.
//
// Shared by both dtypes:
//   * two kernels and no atomics, as the reference's two passes: the dkv
//     kernel owns one 64-row KV tile of one (b, h) and loops over Q tiles,
//     the dq kernel owns one 64-row Q tile and loops over KV tiles; each
//     sum is taken in one fixed order, so results repeat bit for bit;
//   * causal loops start (dkv) at the first Q tile that can see the KV
//     tile and stop (dq) at the last KV tile the Q tile can see: invisible
//     tiles are never loaded (the TPU visits them as predicated no-ops,
//     `_dispatch_masked_step` :293);
//   * [B, T, H, D] tensors are read through their strides (no transpose
//     to [bh, T, D] as at :455-458); lse and delta are [B, H, Tq] float32
//     (no 8-lane broadcast, a Mosaic tiling artefact at :466-467);
//   * ragged tails are bound-checked instead of padded: rows >= Tq and
//     columns >= Tk are never loaded (zeros in shared memory) and never
//     written.  In the dkv kernel a padded Q row would add into real dK/dV
//     rows, so it is masked; a padded KV row only feeds its own, unwritten
//     accumulators.  In the dq kernel it is the other way round;
//   * the mask is a select, p = keep ? exp(s - lse) : 0, never a multiply
//     by 0 (a masked s is unbounded, exp may overflow, and inf * 0 is
//     NaN), and it runs only on tiles the diagonal or a tail crosses;
//   * every accumulator is f32 and the gradients are rounded once, to the
//     inputs' dtype, at the store.
//
// The dtype picks the tile code at build time, never at run time:
//
// float32 (the card's precision reference; f32 on the tensor cores would
// be TF32): f32 FMA tiles out of shared memory, 256 threads, each owning
// a 4x4 block of the 64x64 score tile (rows 4*ty..4*ty+3, columns
// tx + 16*j) and the same 4 rows of its 64xD accumulators.  Shared rows
// are padded (D + 1, 64 + 4) so column reads and transposed writes do
// not conflict.
//
// bfloat16: wgmma on the tensor cores, one warpgroup (128 threads) per
// block owning the block's 64 rows:
//   * tiles stay bf16 in shared memory, [64][D] as D/64 column blocks of
//     64 rows x 128 bytes with each row's 16-byte chunks XOR-swizzled by
//     row % 8 (the 128-byte swizzle wgmma's descriptors read); one tile
//     serves as a K-major operand (S = Q K^T, both rows along K) and as
//     an MN-major one (dQ += dS K, B read transposed);
//   * loads are 16-byte cp.async copies, zero-filled past the tail; the
//     streamed tiles (Q, dO, lse, delta in dkv; K, V in dq) are double
//     buffered, so the next tile's copy overlaps this tile's products;
//   * dkv computes the transposed tiles S^T = K Q^T and dP^T = V dO^T,
//     so P^T = exp(S^T * scale - lse) and dS^T = P^T o (dP^T - delta)
//     come out of the accumulator already laid out as the register A
//     operand of dV += P^T dO and dK += dS^T Q (dO and Q as B, read
//     MN-major from their row-major tiles); dq computes S = Q K^T and
//     dP = dO V^T and dS in registers as the A operand of dQ += dS K.
//     P and dS never touch shared memory;
//   * P and dS are rounded to bf16 as operands of those products: the
//     one rounding this path adds over the f32 one (dS from the f32 P);
//   * the epilogue rounds the accumulator once to bf16, stages it in a
//     free swizzled tile and writes whole 16-byte chunks;
//   * the dq kernel maps blockIdx.x to Q tiles in reverse, so the
//     heaviest causal tiles (the most KV tiles) start first, as the dkv
//     kernel's low KV tiles (the most Q tiles) already do.
// The tile, copy, descriptor and wgmma helpers live in wgmma.cuh, shared
// with the forward kernel (flash_fwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

struct Strides {
  long long b, t, h;
};

struct Args {
  const void *q, *k, *v, *dout;
  Strides sq, sk, sv, sdo;
  const float *lse, *delta;  // [B, H, Tq]
  void *dq, *dk, *dv;        // contiguous [B, T, H, D]
  int H, Tq, Tk, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// float32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = 64 + 4;  // score rows 4 apart sit 16 banks apart

// rows [t0, t0 + 64) of one (b, h) of a strided [B, T, H, D] tensor into
// a [64][D + 1] f32 tile; rows >= t_end are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride_t, int t0,
                                          int t_end) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[r * (D + 1) + d] = t < t_end ? src[t * stride_t + d] : 0.f;
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BK * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * PP + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel_f32(Args a) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sQ = sV + BK * DP;     // [BQ][DP]
  float* sdO = sQ + BQ * DP;    // [BQ][DP]
  float* sPt = sdO + BQ * DP;   // [BK][PP]: P transposed, row = key
  float* sdSt = sPt + BK * PP;  // [BK][PP]: dS transposed
  float* sLse = sdSt + BK * PP; // [BQ]
  float* sDlt = sLse + BQ;      // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int k0 = blockIdx.x * BK;
  const int Tq = a.Tq, Tk = a.Tk;

  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const size_t row0 = ((size_t)b * a.H + h) * Tq;

  load_tile<D>(sK, kb, a.sk.t, k0, Tk);
  load_tile<D>(sV, vb, a.sv.t, k0, Tk);

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: the first query that can see key k0 is row k0
  const int qt_first = a.causal ? k0 / BQ : 0;
  const int n_qt = (Tq + BQ - 1) / BQ;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers of sQ/sdO/sPt/sdSt are done
    load_tile<D>(sQ, qb, a.sq.t, q0, Tq);
    load_tile<D>(sdO, dob, a.sdo.t, q0, Tq);
    if (tid < BQ) {
      const bool ok = q0 + tid < Tq;
      sLse[tid] = ok ? a.lse[row0 + q0 + tid] : 0.f;
      sDlt[tid] = ok ? a.delta[row0 + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this thread's keys 4ty+i and queries tx+16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty * 4 + i) * DP + d];
        vv[i] = sV[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = sQ[(tx + 16 * c) * DP + d];
        dov[c] = sdO[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], dov[c], dp[i][c]);
        }
    }

    // the element mask only where the Q tail or the diagonal crosses
    const bool masked = (q0 + BQ > Tq) || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ql = tx + 16 * c;
        bool keep = true;
        if (masked) {
          keep = q0 + ql < Tq;
          if (a.causal) keep = keep && (q0 + ql >= k0 + ty * 4 + i);
        }
        const float p = keep ? expf(s[i][c] * a.scale - sLse[ql]) : 0.f;
        sPt[(ty * 4 + i) * PP + ql] = p;
        sdSt[(ty * 4 + i) * PP + ql] = p * (dp[i][c] - sDlt[ql]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this tile's 64 queries
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sPt[(ty * 4 + i) * PP + c];
        ds[i] = sdSt[(ty * 4 + i) * PP + c];
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float dov = sdO[c * DP + tx + 16 * cc];
        const float qv = sQ[c * DP + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][cc] = fmaf(p[i], dov, dv[i][cc]);
          dk[i][cc] = fmaf(ds[i], qv, dk[i][cc]);
        }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Tk) continue;
    const size_t o = (((size_t)b * Tk + row) * a.H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      dkb[o + tx + 16 * cc] = dk[i][cc] * a.scale;
      dvb[o + tx + 16 * cc] = dv[i][cc];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel_f32(Args a) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sdO = sQ + BQ * DP;    // [BQ][DP]
  float* sK = sdO + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sdS = sV + BK * DP;    // [BQ][PP]
  float* sLse = sdS + BQ * PP;  // [BQ]
  float* sDlt = sLse + BQ;      // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BQ;
  const int Tq = a.Tq, Tk = a.Tk;

  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const size_t row0 = ((size_t)b * a.H + h) * Tq;

  load_tile<D>(sQ, qb, a.sq.t, q0, Tq);
  load_tile<D>(sdO, dob, a.sdo.t, q0, Tq);
  if (tid < BQ) {
    const bool ok = q0 + tid < Tq;
    sLse[tid] = ok ? a.lse[row0 + q0 + tid] : 0.f;
    sDlt[tid] = ok ? a.delta[row0 + q0 + tid] : 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // causal: the tile's last query sees keys up to its own row
  const int last_q = min(q0 + BQ, Tq) - 1;
  const int kv_end = a.causal ? min(Tk, last_q + 1) : Tk;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers of sK/sV/sdS are done
    load_tile<D>(sK, kb, a.sk.t, k0, Tk);
    load_tile<D>(sV, vb, a.sv.t, k0, Tk);
    __syncthreads();

    // S and dP for this thread's queries 4ty+i and keys tx+16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * DP + d];
        dov[i] = sdO[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = sK[(tx + 16 * c) * DP + d];
        vv[c] = sV[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }

    // the element mask only where the KV tail or the diagonal crosses
    const bool masked = (k0 + BK > Tk) || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kl = k0 + tx + 16 * c;
        bool keep = true;
        if (masked) {
          keep = kl < Tk;
          if (a.causal) keep = keep && (q0 + ql >= kl);
        }
        const float p = keep ? expf(s[i][c] * a.scale - sLse[ql]) : 0.f;
        sdS[ql * PP + tx + 16 * c] = p * (dp[i][c] - sDlt[ql]);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's 64 keys
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float kv = sK[c * DP + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
      }
    }
  }

  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const size_t o = (((size_t)b * Tq + row) * a.H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      dqb[o + tx + 16 * cc] = acc[i][cc] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles
// ---------------------------------------------------------------------------

using namespace dmlc_tc;

// four [64][D] tiles besides K and V (dkv: Q and dO twice; dq: K and V
// twice besides Q and dO), lse and delta twice (dkv), and the slack to
// align the first tile to the 1024 bytes a swizzle pattern spans
template <int D>
constexpr size_t tc_smem_bytes() {
  return 6 * tile_bytes<D>() + 2 * 2 * ROWS * sizeof(float) + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTC) flash_bwd_dkv_kernel_bf16(Args a) {
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t sK = s0, sV = s0 + TB;
  const uint32_t sQ0 = s0 + 2 * TB, sdO0 = s0 + 4 * TB;  // two buffers each
  // per buffer: lse[64] then delta[64]
  const float* rows = reinterpret_cast<const float*>(sm + 6 * TB);
  const uint32_t sRows = s0 + 6 * TB;

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int k0 = blockIdx.x * ROWS;
  const int Tq = a.Tq, Tk = a.Tk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const size_t row0 = ((size_t)b * a.H + h) * Tq;
  const float* lse = a.lse + row0;
  const float* delta = a.delta + row0;

  // causal: the first query that can see key k0 is row k0
  const int qt_first = a.causal ? k0 / ROWS : 0;
  const int n_qt = (Tq + ROWS - 1) / ROWS;

  auto load_q = [&](int qt, int buf) {
    load_tile_async<D>(sQ0 + buf * TB, qb, a.sq.t, qt * ROWS, Tq);
    load_tile_async<D>(sdO0 + buf * TB, dob, a.sdo.t, qt * ROWS, Tq);
    load_rows_async(sRows + buf * 512, lse, qt * ROWS, Tq);
    load_rows_async(sRows + buf * 512 + 256, delta, qt * ROWS, Tq);
  };
  load_tile_async<D>(sK, kb, a.sk.t, k0, Tk);
  load_tile_async<D>(sV, vb, a.sv.t, k0, Tk);
  if (qt_first < n_qt) load_q(qt_first, 0);
  cp_async_commit();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale2 = a.scale * LOG2E;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int buf = (qt - qt_first) & 1;
    const int q0 = qt * ROWS;
    const uint32_t sQ = sQ0 + buf * TB, sdO = sdO0 + buf * TB;
    if (qt + 1 < n_qt) load_q(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) have landed
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    gemm_abt<D>(st, sK, sQ);
    gemm_abt<D>(dpt, sV, sdO);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in registers, packed as the next products' A operand;
    // the element mask only where the Q tail or the diagonal crosses
    const float* lse_t = rows + buf * 128;
    const float* dlt_t = lse_t + 64;
    const bool masked = (q0 + ROWS > Tq) || (a.causal && k0 + ROWS - 1 > q0);
    uint32_t pf[16], df[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kr = acc_row(i + e), qc = acc_col(i + e);
        bool keep = true;
        if (masked) {
          keep = q0 + qc < Tq;
          if (a.causal) keep = keep && (q0 + qc >= k0 + kr);
        }
        p[e] = keep ? exp2f(st[i + e] * scale2 - lse_t[qc] * LOG2E) : 0.f;
        ds[e] = p[e] * (dpt[i + e] - dlt_t[qc]);
      }
      pf[i / 2] = pack_bf16(p[0], p[1]);
      df[i / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dV += P^T dO and dK += dS^T Q over this tile's 64 queries
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    gemm_fb<D>(dv, pf, sdO);
    gemm_fb<D>(dk, df, sQ);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(df);
    __syncthreads();  // this buffer is free for the copy issued next step
  }

  cp_async_wait<0>();
  __syncthreads();
  const size_t o = ((size_t)b * Tk * a.H + h) * D;
  const long long stride_t = (long long)a.H * D;
  store_tile<D>(dk, a.scale, sm, static_cast<bf16*>(a.dk) + o, stride_t, k0,
                Tk);
  store_tile<D>(dv, 1.f, sm + TB, static_cast<bf16*>(a.dv) + o, stride_t, k0,
                Tk);
}

template <int D>
__global__ void __launch_bounds__(NTC) flash_bwd_dq_kernel_bf16(Args a) {
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t sQ = s0, sdO = s0 + TB;
  const uint32_t sK0 = s0 + 2 * TB, sV0 = s0 + 4 * TB;  // two buffers each

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  // heaviest causal tiles (the most KV tiles to walk) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int Tq = a.Tq, Tk = a.Tk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const size_t row0 = ((size_t)b * a.H + h) * Tq;

  // causal: the tile's last query sees keys up to its own row
  const int last_q = min(q0 + ROWS, Tq) - 1;
  const int kv_end = a.causal ? min(Tk, last_q + 1) : Tk;
  const int n_kt = kv_end > 0 ? (kv_end + ROWS - 1) / ROWS : 0;

  load_tile_async<D>(sQ, qb, a.sq.t, q0, Tq);
  load_tile_async<D>(sdO, dob, a.sdo.t, q0, Tq);
  if (n_kt > 0) {
    load_tile_async<D>(sK0, kb, a.sk.t, 0, Tk);
    load_tile_async<D>(sV0, vb, a.sv.t, 0, Tk);
  }
  cp_async_commit();

  // lse (log2 units) and delta of this thread's two rows
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + acc_row(2 * half);
    const bool ok = q < Tq;
    lse2[half] = ok ? a.lse[row0 + q] * LOG2E : 0.f;
    dlt[half] = ok ? a.delta[row0 + q] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float scale2 = a.scale * LOG2E;

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    const int k0 = j * ROWS;
    const uint32_t sK = sK0 + buf * TB, sV = sV0 + buf * TB;
    if (j + 1 < n_kt) {
      load_tile_async<D>(sK0 + (buf ^ 1) * TB, kb, a.sk.t, k0 + ROWS, Tk);
      load_tile_async<D>(sV0 + (buf ^ 1) * TB, vb, a.sv.t, k0 + ROWS, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) have landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows queries, columns keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    gemm_abt<D>(s, sQ, sK);
    gemm_abt<D>(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // dS in registers, packed as the next product's A operand; the
    // element mask only where the KV tail or the diagonal crosses
    const bool masked = (k0 + ROWS > Tk) || (a.causal && k0 + ROWS - 1 > q0);
    uint32_t df[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int half = ((i + e) >> 1) & 1;
        const int kc = k0 + acc_col(i + e);
        bool keep = true;
        if (masked) {
          keep = kc < Tk;
          if (a.causal) keep = keep && (q0 + acc_row(i + e) >= kc);
        }
        const float p = keep ? exp2f(s[i + e] * scale2 - lse2[half]) : 0.f;
        ds[e] = p * (dp[i + e] - dlt[half]);
      }
      df[i / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dQ += dS K over this tile's 64 keys
    fence_regs(dq);
    wgmma_fence();
    gemm_fb<D>(dq, df, sK);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dq);
    fence_regs(df);
    __syncthreads();  // this buffer is free for the copy issued next step
  }

  cp_async_wait<0>();
  __syncthreads();
  store_tile<D>(dq, a.scale, sm,
                static_cast<bf16*>(a.dq) + ((size_t)b * Tq * a.H + h) * D,
                (long long)a.H * D, q0, Tq);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(bool dq, const Args& a, int B, cudaStream_t stream) {
  auto kern = dq ? flash_bwd_dq_kernel_f32<D> : flash_bwd_dkv_kernel_f32<D>;
  const size_t smem = dq ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dq ? a.Tq : a.Tk;
  dim3 grid((rows + 63) / 64, B * a.H);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(bool dq, const Args& a, int B, cudaStream_t stream) {
  // 16-byte copies: every row of q, k, v and dO must start 16-byte aligned
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const Strides* st[4] = {&a.sq, &a.sk, &a.sv, &a.sdo};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || st[i]->b % 8 ||
        st[i]->t % 8 || st[i]->h % 8)
      return cudaErrorMisalignedAddress;
  auto kern = dq ? flash_bwd_dq_kernel_bf16<D> : flash_bwd_dkv_kernel_bf16<D>;
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dq ? a.Tq : a.Tk;
  dim3 grid((rows + ROWS - 1) / ROWS, B * a.H);
  kern<<<grid, NTC, smem, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(bool dq, const Args& a, int B, int D, int dtype, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((dq ? a.Tq : a.Tk) <= 0 || B * a.H <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_f32<64>(dq, a, B, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(dq, a, B, st);
  if (dtype == 1 && D == 64) return launch_bf16<64>(dq, a, B, st);
  if (dtype == 1 && D == 128) return launch_bf16<128>(dq, a, B, st);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const long long* st, const void* lse, const void* delta,
               int H, int Tq, int Tk, int causal, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.sq = Strides{st[0], st[1], st[2]};
  a.sk = Strides{st[3], st[4], st[5]};
  a.sv = Strides{st[6], st[7], st[8]};
  a.sdo = Strides{st[9], st[10], st[11]};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = a.dk = a.dv = nullptr;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

const char* dmlc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients).
// strides: 12 element strides, (b, t, h) of q, k, v and dout in turn;
// the last dim of each is contiguous.  lse and delta are [B, H, Tq]
// float32; dk and dv are contiguous [B, Tk, H, D], dq [B, Tq, H, D].
int dmlc_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const long long* strides,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int B, int H, int Tq, int Tk, int D, int dtype,
                       int causal, float scale, int device, void* stream) {
  Args a = make_args(q, k, v, dout, strides, lse, delta, H, Tq, Tk, causal,
                     scale);
  a.dk = dk;
  a.dv = dv;
  return dispatch(false, a, B, D, dtype, device, stream);
}

int dmlc_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const long long* strides,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Tq, int Tk, int D, int dtype, int causal,
                      float scale, int device, void* stream) {
  Args a = make_args(q, k, v, dout, strides, lse, delta, H, Tq, Tk, causal,
                     scale);
  a.dq = dq;
  return dispatch(true, a, B, D, dtype, device, stream);
}

}  // extern "C"
