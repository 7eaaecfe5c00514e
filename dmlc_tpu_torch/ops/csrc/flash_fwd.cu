// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of dmlc_tpu/ops/flash_attention.py
// (launched by `_flash_forward`, pallas_call at flash_attention.py:265):
// one Q tile against a KV range with an online softmax, giving the
// unnormalised pv and the row max m and row sum l, with causal and
// padded-tail masks on global positions (q_offset, kv_offset, and the
// KV end = kv_offset + Tk).
//
// What bounds it on this card: the two products QK^T and PV, 4*D FLOPs
// per visible (q, k) pair.  At the train step's shape (B=8, H=16,
// T=1024, D=128, bf16, causal) that is 34.4 GFLOP a launch, 0.035 ms on
// the bf16 tensor cores, against ~0.013 ms to move q, k, v and o once at
// 3.35 TB/s; at B=1 x T=8192 275 GFLOP against the same bytes.  So the
// products belong on the tensor cores.  At the serving prefill (B=1,
// T=512) the bytes (8 MB, 2.5 us) are the larger bound, and with 128
// tiles of at most 8 KV steps each, latency sets the time.
//
// Shared by both dtypes:
//   * one thread block per (64-row Q tile, b*h pair); the [B, T, H, D]
//     tensors are read through their strides, so there is no transpose
//     to [bh, T, D] as on the TPU (flash_attention.py:235);
//   * the KV loop stops at the last tile the tile's last query can see,
//     min(Tk, q_offset + last_q + 1 - kv_offset): invisible tiles are
//     never loaded (the TPU visits them as predicated no-ops,
//     `_dispatch_masked_step` :293);
//   * the element mask runs only on tiles the diagonal or the KV tail
//     crosses; clean tiles take the unmasked path;
//   * scores, the running max and sum and pv are f32, and masked
//     probabilities are exactly 0 (:99-100), so a row with no visible key
//     ends with l = 0, pv = 0 and m = -1e30, finite.
//   With NORMALIZE the epilogue writes o = pv / max(l, 1e-20) in the
//   input's dtype (the public `flash_attention`); without it, pv in f32
//   (the ring-step contract).  m and l are written either way.
//
// The dtype picks the tile code at build time:
//
// float32 (the card's precision reference; f32 on the tensor cores would
// be TF32): f32 FMA tiles, 256 threads, each owning a 4x4 block of the
// 64x64 score tile (rows 4*ty..4*ty+3, columns tx + 16*j) and the same 4
// rows of the 64xD accumulator (columns tx + 16*j), so the softmax
// statistics of a row live in the 16 lanes of one half-warp and are
// reduced with shuffles; shared rows are padded so column reads do not
// conflict.
//
// bfloat16: wgmma on the tensor cores (helpers in wgmma.cuh, shared with
// the backward kernels), one warpgroup (128 threads) per 64-row Q tile:
//   * the Q tile is copied once, K and V tiles are double buffered:
//     16-byte cp.async copies into 128-byte-swizzled bf16 tiles, the next
//     KV tile's copy in flight under this tile's products;
//   * S = Q K^T reads both tiles K-major; the online softmax runs on the
//     accumulator layout, where a row's 64 columns sit in one quad of
//     lanes (max reduced with __shfl_xor 1 and 2; the sum is kept per
//     thread and reduced once at the end), with exp2 and scale*log2(e)
//     folded into one FMA;
//   * P is rounded to bf16 in registers as the A operand of O += P V (V
//     read MN-major as B): the one rounding this path adds over the f32
//     one (the TPU kernel multiplies P V in f32, :103-110); l sums the
//     f32 P.  Before each PV product the D/2 f32 accumulators of a
//     thread are rescaled by exp(m_old - m_new);
//   * masked scores are -inf, whose exp2 is exactly 0 (no select, no
//     inf * 0);
//   * blockIdx.x maps to Q tiles in reverse, so the heaviest causal
//     tiles (the most KV tiles) start first;
//   * with NORMALIZE the epilogue rounds o to bf16 once, stages it in the
//     free Q tile and writes whole 16-byte chunks.
//   Rows must start on 16 bytes (the wrapper copies those that do not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------------------
// float32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = BK + 4;  // sP row stride: the two rows a warp reads sit 16 banks apart

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP);
}

template <int D, bool NORMALIZE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Strides sq, Strides sk,
                     Strides sv, float* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int Tq, int Tk, int q_offset, int kv_offset,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][DP]
  float* sK = sQ + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    sQ[r * DP + d] = t < Tq ? qb[t * sq.t + d] : 0.f;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_BIG;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int last_q = min(q0 + BQ, Tq) - 1;
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, q_offset + last_q + 1 - kv_offset);
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool ok = t < Tk;
      sK[r * DP + d] = ok ? kb[t * sk.t + d] : 0.f;
      sV[r * D + d] = ok ? vb[t * sv.t + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // the element mask only where the diagonal or the KV tail crosses
    const bool masked = (k0 + BK > Tk) ||
                        (causal && kv_offset + k0 + BK - 1 > q_offset + q0);
    bool keep[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] *= scale;
        keep[i][c] = true;
        if (masked) {
          const int kl = k0 + tx + 16 * c;
          bool kp = kl < Tk;
          if (causal) kp = kp && (q_offset + q0 + ty * 4 + i >= kv_offset + kl);
          keep[i][c] = kp;
          if (!kp) s[i][c] = NEG_BIG;
        }
      }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = keep[i][c] ? expf(s[i][c] - m_new) : 0.f;
        sP[(ty * 4 + i) * PP + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = sV[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const size_t ml = ((size_t)b * H + h) * Tq + row;
    if (tx == 0) {
      m_out[ml] = m_i[i];
      l_out[ml] = l_i[i];
    }
    float* ob = out + (((size_t)b * Tq + row) * H + h) * D;
    const float mul = NORMALIZE ? 1.f / fmaxf(l_i[i], 1e-20f) : 1.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) ob[tx + 16 * cc] = acc[i][cc] * mul;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles
// ---------------------------------------------------------------------------

using namespace dmlc_tc;

// the Q tile, K and V twice each, and the slack to align the first tile
// to the 1024 bytes a swizzle pattern spans
template <int D>
constexpr size_t tc_smem_bytes() {
  return 5 * tile_bytes<D>() + 1024;
}

template <int D, bool NORMALIZE>
__global__ void __launch_bounds__(NTC)
flash_fwd_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, Strides sq, Strides sk,
                      Strides sv, void* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int H, int Tq, int Tk, int q_offset, int kv_offset,
                      int causal, float scale) {
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t sQ = s0, sK0 = s0 + TB, sV0 = s0 + 3 * TB;  // K, V: two buffers each

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  // heaviest causal tiles (the most KV tiles to walk) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  const int last_q = min(q0 + ROWS, Tq) - 1;
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, q_offset + last_q + 1 - kv_offset);
  const int n_kt = kv_end > 0 ? (kv_end + ROWS - 1) / ROWS : 0;

  load_tile_async<D>(sQ, qb, sq.t, q0, Tq);
  if (n_kt > 0) {
    load_tile_async<D>(sK0, kb, sk.t, 0, Tk);
    load_tile_async<D>(sV0, vb, sv.t, 0, Tk);
  }
  cp_async_commit();

  // this thread's two rows (acc_row(0) and acc_row(2)): the running max
  // of the scaled scores and this thread's share of the row sum
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const float scale2 = scale * LOG2E;
  const int gq[2] = {q_offset + q0 + acc_row(0), q_offset + q0 + acc_row(2)};

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    const int k0 = j * ROWS;
    const uint32_t sK = sK0 + buf * TB, sV = sV0 + buf * TB;
    if (j + 1 < n_kt) {
      load_tile_async<D>(sK0 + (buf ^ 1) * TB, kb, sk.t, k0 + ROWS, Tk);
      load_tile_async<D>(sV0 + (buf ^ 1) * TB, vb, sv.t, k0 + ROWS, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();

    // S = Q K^T: rows queries, columns keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    gemm_abt<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // the element mask only where the diagonal or the KV tail crosses
    const bool masked = (k0 + ROWS > Tk) ||
                        (causal && kv_offset + k0 + ROWS - 1 > q_offset + q0);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kc = k0 + acc_col(i);
        bool keep = kc < Tk;
        if (causal) keep = keep && (gq[(i >> 1) & 1] >= kv_offset + kc);
        if (!keep) s[i] = neg_inf();
      }
    }

    // online softmax: the row max over the quad, then P in registers
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // max(s) * scale == max(s * scale): rounding is monotone
      const float m_new = fmaxf(m[r], mx[r] * scale);
      corr[r] = exp2f((m[r] - m_new) * LOG2E);
      mb[r] = m_new * LOG2E;
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    uint32_t pf[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(fmaf(s[i], scale2, -mb[r]));
      const float p1 = exp2f(fmaf(s[i + 1], scale2, -mb[r]));
      l[r] += p0 + p1;
      pf[i / 2] = pack_bf16(p0, p1);
    }

    // O += P V over this tile's 64 keys
    fence_regs(o);
    wgmma_fence();
    gemm_fb<D>(o, pf, sV);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(pf);
    __syncthreads();  // this buffer is free for the copy issued next step
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t row0 = ((size_t)b * H + h) * Tq;
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + acc_row(2 * r);
      if (row < Tq) {
        m_out[row0 + row] = m[r];
        l_out[row0 + row] = l[r];
      }
    }
  }
  const size_t ob = ((size_t)b * Tq * H + h) * D;
  const long long stride_t = (long long)H * D;
  if constexpr (NORMALIZE) {
    const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
    cp_async_wait<0>();
    __syncthreads();  // every read of the Q tile, the staging tile, is done
    store_tile<D>(o, 1.f, sm, static_cast<bf16*>(out) + ob, stride_t, q0, Tq);
  } else {
    float* of = static_cast<float*>(out) + ob;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = q0 + acc_row(i);
      if (row < Tq)
        *reinterpret_cast<float2*>(of + row * stride_t + acc_col(i)) =
            make_float2(o[i], o[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Launch {
  const void *q, *k, *v;
  Strides sq, sk, sv;
  void* out;
  float *m, *l;
  int B, H, Tq, Tk, q_offset, kv_offset, causal;
  float scale;
  cudaStream_t stream;
};

template <int D, bool NORMALIZE>
cudaError_t launch_f32(const Launch& a) {
  auto kern = flash_fwd_kernel_f32<D, NORMALIZE>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.sq, a.sk, a.sv,
      static_cast<float*>(a.out), a.m, a.l, a.H, a.Tq, a.Tk, a.q_offset,
      a.kv_offset, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D, bool NORMALIZE>
cudaError_t launch_bf16(const Launch& a) {
  // 16-byte copies: every row of q, k and v must start 16-byte aligned
  const void* ptrs[3] = {a.q, a.k, a.v};
  const Strides* st[3] = {&a.sq, &a.sk, &a.sv};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || st[i]->b % 8 ||
        st[i]->t % 8 || st[i]->h % 8)
      return cudaErrorMisalignedAddress;
  auto kern = flash_fwd_kernel_bf16<D, NORMALIZE>;
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + ROWS - 1) / ROWS, a.B * a.H);
  kern<<<grid, NTC, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.sq, a.sk, a.sv, a.out, a.m, a.l, a.H,
      a.Tq, a.Tk, a.q_offset, a.kv_offset, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, int normalize, const Launch& a) {
  if (dtype == 0)
    return normalize ? launch_f32<D, true>(a) : launch_f32<D, false>(a);
  return normalize ? launch_bf16<D, true>(a) : launch_bf16<D, false>(a);
}

}  // namespace

extern "C" {

const char* dmlc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  out is
// [B, Tq, H, D] contiguous (input dtype when normalize, else float32);
// m and l are [B, H, Tq] float32.
int dmlc_flash_fwd(const void* q, const void* k, const void* v,
                   long long sq_b, long long sq_t, long long sq_h,
                   long long sk_b, long long sk_t, long long sk_h,
                   long long sv_b, long long sv_t, long long sv_h,
                   void* out, void* m, void* l, int B, int H, int Tq, int Tk,
                   int D, int dtype, int causal, int q_offset, int kv_offset,
                   float scale, int normalize, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Tq <= 0 || B * H <= 0) return cudaSuccess;
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const Launch a{q, k, v,
                 Strides{sq_b, sq_t, sq_h}, Strides{sk_b, sk_t, sk_h},
                 Strides{sv_b, sv_t, sv_h},
                 out, static_cast<float*>(m), static_cast<float*>(l),
                 B, H, Tq, Tk, q_offset, kv_offset, causal, scale,
                 static_cast<cudaStream_t>(stream)};
  return D == 64 ? launch<64>(dtype, normalize, a)
                 : launch<128>(dtype, normalize, a);
}

}  // extern "C"
