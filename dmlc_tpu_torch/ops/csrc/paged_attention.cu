// Paged decode attention for Hopper (sm_90a), split over the KV length.
//
// Replaces the TPU kernel `_kernel` of dmlc_tpu/ops/paged_attention.py
// (launched by `_pallas_paged_attention`, pallas_call at
// paged_attention.py:154): S window queries per (sequence, head) attend
// that sequence's KV pages in place, reached through block_tables[b, j];
// window row s keeps pool position p iff p <= lengths[b] + s, and the
// output is normalised by max(l, 1e-37).
//
// What bounds it on this card: the bytes.  Each (b, h) reads its visible
// K and V once and does ~4 FLOPs per byte, far below the ~295 FLOP/byte
// ridge (at the serving shape, 8 rows x ~280 tokens x 16 heads x 128 x 2
// tensors x 2 bytes = 18 MB a layer, 5.5 us at 3.35 TB/s).  A 64-row
// wgmma tile would be mostly padding at S <= 8 rows, so this is CUDA-core
// code whose aim is to keep the card's memory busy: many blocks, and many
// 16-byte loads in flight in each.
//
// Design (flash-decoding):
//   * grid (n_split, H, B): each block owns one split of ceil(W /
//     n_split) whole pages of one (b, h).  The caller picks n_split from
//     the table width, which the host knows; `lengths` is read only on
//     the device.  A split that starts at or past
//     min(lengths[b] + S, W * bs) writes an empty partial (m = -1e30,
//     l = 0, pv = 0) and returns, so short rows cost nothing and a long
//     row is spread over as many blocks as it has splits;
//   * inside a block (4 warps) each token is read by D / VEC lanes of one
//     warp, one 16-byte vector each (VEC = 8 bf16 or 4 f32 values): 16
//     lanes per bf16 row at D=128, 32 per f32 row.  A warp holds 32 / (D /
//     VEC) tokens at a time and each lane keeps U tokens' K and V loads in
//     flight before it computes (U = 8 at S = 1);
//   * q sits in registers, pre-scaled by scale * log2(e); each dot
//     product is reduced over its lanes with shuffles; the online softmax
//     (exp2) and the [S, D] accumulator stay in f32 registers per token
//     group; groups merge by shuffles, warps through shared memory, in a
//     fixed order;
//   * each block writes its partial (pv, m, l) to an f32 workspace the
//     wrapper allocates; a second kernel, launched by the same C entry
//     point, merges the splits of each (b, s, h) in split order and
//     writes q's dtype.  No atomics: results repeat bit for bit.
// The TPU kernel's grid (b, h, j) walks all W pages of a row in order on
// one core and predicates the invisible ones (:98); here only the pages a
// window row can see are read, and the walk is cut across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // four warps
constexpr int NW = NT / 32;
constexpr int SMAX = 8;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Partials, in the workspace: pv [B, H, n_split, S, D] then (m, l)
// [B, H, n_split, S, 2], m in log2 units of the scaled score.
template <typename T, int D, int SP>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const T* __restrict__ q, long long sq_b, long long sq_s,
                   long long sq_h, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, float* __restrict__ ws,
                   int H, int S, int W, int bs, int split, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPT = D / VEC;          // lanes per token
  constexpr int GPW = 32 / LPT;         // token groups per warp
  constexpr int NG = GPW * NW;          // token groups per block
  constexpr int U = SP == 1 ? 8 : (SP <= 4 ? 4 : 2);  // tokens in flight a group
  __shared__ float sm_m[NW][SP], sm_l[NW][SP];
  __shared__ float sm_acc[NW][SP][D];

  const int n_split = gridDim.x, sp = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z, B = gridDim.z;
  const size_t part = ((size_t)b * H + h) * n_split + sp;
  float* pv_out = ws + part * S * D;
  float* ml_out = ws + (size_t)B * H * n_split * S * D + part * S * 2;

  const int len = lengths[b];
  const int n_pos = min(len + S, W * bs);  // positions some row can see
  const int p0 = sp * split;
  const int p1 = min(p0 + split, n_pos);
  if (p0 >= n_pos) {
    for (int i = threadIdx.x; i < S * D; i += NT) pv_out[i] = 0.f;
    if (threadIdx.x < S) {
      ml_out[2 * threadIdx.x] = NEG_BIG;
      ml_out[2 * threadIdx.x + 1] = 0.f;
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp * GPW + lane / LPT;  // this lane's token group
  const int c = (lane % LPT) * VEC;       // its first column
  const int* tbl = block_tables + (size_t)b * W;

  float qr[SP][VEC];
  const float qs = scale * LOG2E;
#pragma unroll
  for (int r = 0; r < SP; ++r) {
    float x[VEC];
    if (r < S) {
      unpack(load16(q + b * sq_b + r * sq_s + h * sq_h + c), x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = x[e] * qs;
  }
  float m[SP], l[SP], acc[SP][VEC];
#pragma unroll
  for (int r = 0; r < SP; ++r) {
    m[r] = NEG_BIG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // every lane runs the same trip count: the shuffles need the full warp
  for (int t0 = p0; t0 < p1; t0 += NG * U) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NG + g;
      if (t < p1) {
        const size_t off = (((size_t)tbl[t / bs] * bs + t % bs) * H + h) * D + c;
        kr[u] = load16(k_pool + off);
        vr[u] = load16(v_pool + off);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // scores (log2 units); -inf where the row may not see the token
    float s[U][SP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NG + g;
      float kx[VEC];
      unpack(kr[u], kx);
#pragma unroll
      for (int r = 0; r < SP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[r][e], kx[e], dot);
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][r] = (r < S && t < p1 && t <= len + r) ? dot : neg_inf();
      }
    }

    // one rescale per row for the U tokens, then P V
#pragma unroll
    for (int r = 0; r < SP; ++r) {
      float mx = neg_inf();
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[VEC];
      unpack(vr[u], vx);
#pragma unroll
      for (int r = 0; r < SP; ++r) {
        const float p = exp2f(s[u][r] - m[r]);  // exactly 0 where masked
        l[r] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
      }
    }
  }

  // merge the warp's token groups (lanes LPT, 2 LPT, ... apart)
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < SP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], mo);
      const float ca = exp2f(m[r] - mm), cb = exp2f(mo - mm);
      m[r] = mm;
      l[r] = l[r] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * ca + ao * cb;
      }
    }
  }
  if (lane < LPT) {
#pragma unroll
    for (int r = 0; r < SP; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][r][c + e] = acc[r][e];
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge the warps in order and write this split's partial
  for (int i = threadIdx.x; i < S * D; i += NT) {
    const int r = i / D, d = i % D;
    float mm = NEG_BIG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += sm_acc[w][r][d] * exp2f(sm_m[w][r] - mm);
    pv_out[i] = a;
    if (d == 0) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ls += sm_l[w][r] * exp2f(sm_m[w][r] - mm);
      ml_out[2 * r] = mm;
      ml_out[2 * r + 1] = ls;
    }
  }
}

// out[b, s, h] = sum_j pv_j 2^(m_j - M) / max(sum_j l_j 2^(m_j - M), 1e-37)
// over the splits j in order, M = max_j m_j; grid (H, B)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                     int H, int S, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const size_t part = ((size_t)b * H + h) * n_split;
  const float* pv = ws + part * S * D;
  const float* ml = ws + (size_t)B * H * n_split * S * D + part * S * 2;
  for (int i = threadIdx.x; i < S * D; i += NT) {
    const int r = i / D, d = i % D;
    float mm = NEG_BIG;
    for (int j = 0; j < n_split; ++j) mm = fmaxf(mm, ml[(j * S + r) * 2]);
    float a = 0.f, ls = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float w = exp2f(ml[(j * S + r) * 2] - mm);
      ls += ml[(j * S + r) * 2 + 1] * w;
      a += pv[(size_t)(j * S + r) * D + d] * w;
    }
    out[(((size_t)b * S + r) * H + h) * D + d] = from_f32<T>(a / fmaxf(ls, 1e-37f));
  }
}

template <typename T, int D, int SP>
cudaError_t launch_sp(const T* q, long long sq_b, long long sq_s,
                      long long sq_h, const T* k_pool, const T* v_pool,
                      const int* tables, const int* lengths, T* out,
                      float* ws, int B, int H, int S, int W, int bs,
                      int n_split, float scale, cudaStream_t stream) {
  const int split_pages = W > 0 ? (W + n_split - 1) / n_split : 1;
  paged_split_kernel<T, D, SP><<<dim3(n_split, H, B), NT, 0, stream>>>(
      q, sq_b, sq_s, sq_h, k_pool, v_pool, tables, lengths, ws, H, S, W, bs,
      split_pages * bs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T, D><<<dim3(H, B), NT, 0, stream>>>(ws, out, H, S,
                                                            n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, long long sq_b, long long sq_s,
                   long long sq_h, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, float* ws,
                   int B, int H, int S, int W, int bs, int n_split,
                   float scale, cudaStream_t stream) {
  // 16-byte vector loads: q rows and the pools must start on 16 bytes
  constexpr int VEC = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(q) % 16 || sq_b % VEC || sq_s % VEC ||
      sq_h % VEC || reinterpret_cast<uintptr_t>(k_pool) % 16 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16)
    return cudaErrorMisalignedAddress;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
#define DMLC_PAGED_LAUNCH(SP)                                                \
  return launch_sp<T, D, SP>(qt, sq_b, sq_s, sq_h, kt, vt, tables, lengths, \
                             ot, ws, B, H, S, W, bs, n_split, scale,        \
                             stream)
  if (S == 1) DMLC_PAGED_LAUNCH(1);
  if (S <= 4) DMLC_PAGED_LAUNCH(4);
  DMLC_PAGED_LAUNCH(8);
#undef DMLC_PAGED_LAUNCH
}

}  // namespace

extern "C" {

const char* dmlc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// q strides in elements; pools [n_blocks, bs, H, D], tables [B, W] int32,
// lengths [B] int32 and out [B, S, H, D] are contiguous.  S <= 8.  The
// KV walk is cut into n_split splits of ceil(W / n_split) pages (1 <=
// n_split <= max(W, 1)); workspace holds B * H * n_split * S * (D + 2)
// floats: pv [B, H, n_split, S, D], then (m, l) [B, H, n_split, S, 2].
int dmlc_paged_attention(const void* q, long long sq_b, long long sq_s,
                         long long sq_h, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* lengths, void* out, void* workspace,
                         int B, int H, int S, int W, int bs, int n_split,
                         int D, int dtype, float scale, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (S < 1 || S > SMAX || bs < 1 || W < 0 || n_split < 1 ||
      n_split > (W > 0 ? W : 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb, ln, out,
                             ws, B, H, S, W, bs, n_split, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb, ln,
                              out, ws, B, H, S, W, bs, n_split, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb,
                                     ln, out, ws, B, H, S, W, bs, n_split,
                                     scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb,
                                      ln, out, ws, B, H, S, W, bs,
                                      n_split, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
