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
// and 0.052 ms on the tensor cores, against ~0.06 and ~0.05 ms to move
// q, dO, k, v, lse, delta and the gradients once at 3.35 TB/s.  This
// first version does the products with f32 FMAs out of shared memory
// (like the forward kernel), so it is bound by FMA throughput and
// shared-memory reads, far from either roofline; mma/wgmma tiles are the
// next step.
//
// Design:
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
//   * S, P, dP, dS and every accumulator are f32; the inputs are upcast
//     on their way into shared memory (the reference's f32 dots at
//     :366-375 and :422-424) and the gradients are rounded once, to the
//     inputs' dtype, at the store;
//   * 256 threads; each owns a 4x4 block of the 64x64 score tile (rows
//     4*ty..4*ty+3, columns tx + 16*j) and the same 4 rows of its 64xD
//     accumulators (columns tx + 16*j).  Shared rows are padded (D + 1,
//     64 + 4) so column reads and transposed writes do not conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = 64 + 4;  // score rows 4 apart sit 16 banks apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// rows [t0, t0 + 64) of one (b, h) of a strided [B, T, H, D] tensor into
// a [64][D + 1] f32 tile; rows >= t_end are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride_t, int t0,
                                          int t_end) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[r * (D + 1) + d] = t < t_end ? to_f32(src[t * stride_t + d]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Args a) {
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

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const size_t row0 = ((size_t)b * a.H + h) * Tq;

  load_tile<T, D>(sK, kb, a.sk.t, k0, Tk);
  load_tile<T, D>(sV, vb, a.sv.t, k0, Tk);

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
    load_tile<T, D>(sQ, qb, a.sq.t, q0, Tq);
    load_tile<T, D>(sdO, dob, a.sdo.t, q0, Tq);
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

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Tk) continue;
    const size_t o = (((size_t)b * Tk + row) * a.H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      dkb[o + tx + 16 * cc] = from_f32<T>(dk[i][cc] * a.scale);
      dvb[o + tx + 16 * cc] = from_f32<T>(dv[i][cc]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
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

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const size_t row0 = ((size_t)b * a.H + h) * Tq;

  load_tile<T, D>(sQ, qb, a.sq.t, q0, Tq);
  load_tile<T, D>(sdO, dob, a.sdo.t, q0, Tq);
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
    load_tile<T, D>(sK, kb, a.sk.t, k0, Tk);
    load_tile<T, D>(sV, vb, a.sv.t, k0, Tk);
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

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const size_t o = (((size_t)b * Tq + row) * a.H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      dqb[o + tx + 16 * cc] = from_f32<T>(acc[i][cc] * a.scale);
  }
}

template <typename T, int D>
cudaError_t launch(bool dq, const Args& a, int B, cudaStream_t stream) {
  auto kern = dq ? flash_bwd_dq_kernel<T, D> : flash_bwd_dkv_kernel<T, D>;
  const size_t smem = dq ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dq ? a.Tq : a.Tk;
  dim3 grid((rows + 63) / 64, B * a.H);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(bool dq, const Args& a, int B, int D, int dtype, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((dq ? a.Tq : a.Tk) <= 0 || B * a.H <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(dq, a, B, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(dq, a, B, st);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(dq, a, B, st);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(dq, a, B, st);
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
