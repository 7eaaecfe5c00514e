// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of dmlc_tpu/ops/paged_attention.py
// (launched by `_pallas_paged_attention`, pallas_call at
// paged_attention.py:154): S window queries per (sequence, head) attend
// that sequence's KV pages in place, reached through block_tables[b, j];
// window row s keeps pool position p iff p <= lengths[b] + s, and the
// output is normalised by max(l, 1e-37).
//
// What bounds it on this card: the bytes.  Each (b, h) reads its visible
// K and V once (at the serving shapes, 8 rows x ~300 tokens x 16 heads x
// 128 x 2 tensors x 2 bytes ~ 20 MB a layer, ~6 us at 3.35 TB/s) and does
// 4 FLOPs per byte, far below the ~295 FLOP/byte ridge.  What this design
// does about it: a block walks only the ceil((lengths[b] + S) / bs) pages
// that can be visible (the TPU grid visits all W and predicates, :98),
// reads each token's D contiguous elements of its page coalesced, and
// loads several pages (64 tokens) per step so each barrier covers more
// bytes in flight.
//
// Design: one block per (h, b), 128 threads.  It loads lengths[b] and
// reads its own row of block_tables (the TPU gets both as scalar
// prefetch).  The <= 8 window rows of q sit in shared memory in f32;
// each step stages a chunk of K and V in f32, scores every (row, token)
// pair with one thread, updates the f32 online softmax per row with one
// warp per row, then accumulates pv with each thread owning a fixed set
// of (row, d) outputs.  At B=8, H=16 the grid is 128 blocks, under the
// 132 SMs: splitting the page walk across blocks (flash-decoding) is the
// first redesign to make.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int SMAX = 8;
constexpr int CHUNK = 64;  // tokens staged per step (whole pages)
constexpr float NEG_BIG = -1e30f;

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

template <int D>
size_t smem_bytes(int ct) {
  return sizeof(float) * ((size_t)SMAX * (D + 1) + (size_t)ct * (D + 1) +
                          (size_t)ct * D + (size_t)SMAX * ct);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, long long sq_b,
                       long long sq_s, long long sq_h,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int S, int W, int bs, int ct, float scale) {
  constexpr int DP = D + 1;
  constexpr int ACC = SMAX * D / NT;
  extern __shared__ float smem[];
  float* sQ = smem;                // [SMAX][DP]
  float* sK = sQ + SMAX * DP;      // [ct][DP]
  float* sV = sK + ct * DP;        // [ct][D]
  float* sP = sV + ct * D;         // [SMAX][ct]
  __shared__ float sM[SMAX], sL[SMAX], sC[SMAX];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const int* tbl = block_tables + (size_t)b * W;

  for (int i = tid; i < S * D; i += NT) {
    const int s = i / D, d = i % D;
    sQ[s * DP + d] = to_f32(q[b * sq_b + s * sq_s + h * sq_h + d]);
  }
  if (tid < SMAX) {
    sM[tid] = NEG_BIG;
    sL[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  // positions 0 .. n_pos-1 can be visible to some window row
  const int n_pos = min(len + S, W * bs);
  const int warp = tid >> 5, lane = tid & 31;

  for (int p0 = 0; p0 < n_pos; p0 += ct) {
    __syncthreads();  // previous chunk's readers done (and sQ/sM visible)
    for (int i = tid; i < ct * D; i += NT) {
      const int t = i / D, d = i % D;
      const int pos = p0 + t;
      float kx = 0.f, vx = 0.f;
      if (pos < n_pos) {
        const size_t off =
            (((size_t)tbl[pos / bs] * bs + pos % bs) * H + h) * D + d;
        kx = to_f32(k_pool[off]);
        vx = to_f32(v_pool[off]);
      }
      sK[t * DP + d] = kx;
      sV[t * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < S * ct; i += NT) {
      const int s = i / ct, t = i % ct;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[s * DP + d], sK[t * DP + d], dot);
      sP[s * ct + t] = (p0 + t < n_pos && p0 + t <= len + s) ? dot * scale : NEG_BIG;
    }
    __syncthreads();

    for (int s = warp; s < S; s += NT / 32) {
      float mx = NEG_BIG;
      for (int t = lane; t < ct; t += 32) mx = fmaxf(mx, sP[s * ct + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[s];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ct; t += 32) {
        const float p = (p0 + t < n_pos && p0 + t <= len + s)
                            ? expf(sP[s * ct + t] - m_new) : 0.f;
        sP[s * ct + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[s] = corr;
        sL[s] = sL[s] * corr + sum;
        sM[s] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int idx = tid + a * NT;
      if (idx < S * D) {
        const int s = idx / D, d = idx % D;
        float r = acc[a] * sC[s];
        for (int t = 0; t < ct; ++t) r = fmaf(sP[s * ct + t], sV[t * D + d], r);
        acc[a] = r;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = tid + a * NT;
    if (idx < S * D) {
      const int s = idx / D, d = idx % D;
      out[(((size_t)b * S + s) * H + h) * D + d] =
          from_f32<T>(acc[a] / fmaxf(sL[s], 1e-37f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, long long sq_b, long long sq_s,
                   long long sq_h, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, int B,
                   int H, int S, int W, int bs, float scale,
                   cudaStream_t stream) {
  auto kern = paged_attention_kernel<T, D>;
  const int ct = bs >= CHUNK ? bs : (CHUNK / bs) * bs;
  const size_t smem = smem_bytes<D>(ct);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), sq_b, sq_s, sq_h,
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool), tables,
      lengths, static_cast<T*>(out), H, S, W, bs, ct, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dmlc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// q strides in elements; pools [n_blocks, bs, H, D], tables [B, W] int32,
// lengths [B] int32 and out [B, S, H, D] are contiguous.  S <= 8.
int dmlc_paged_attention(const void* q, long long sq_b, long long sq_s,
                         long long sq_h, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* lengths, void* out, int B, int H, int S,
                         int W, int bs, int D, int dtype, float scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (S < 1 || S > SMAX || bs < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb, ln, out,
                             B, H, S, W, bs, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb, ln, out,
                              B, H, S, W, bs, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb,
                                     ln, out, B, H, S, W, bs, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, sq_b, sq_s, sq_h, k_pool, v_pool, tb,
                                      ln, out, B, H, S, W, bs, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
