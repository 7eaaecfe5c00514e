// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of dmlc_tpu/ops/flash_attention.py
// (launched by `_flash_forward`, pallas_call at flash_attention.py:265):
// one Q tile against a KV range with an online softmax, giving the
// unnormalised pv and the row max m and row sum l, with causal and
// padded-tail masks on global positions (q_offset, kv_offset, and the
// KV end = kv_offset + Tk).
//
// What bounds it on this card: the two products QK^T and PV.  At the
// serving prefill's shapes (B=1, H=16, T<=512, D=128, bf16) the work is
// ~1 GFLOP a layer, which the tensor cores would finish in ~1 us; the
// bytes (q, k, v, o: 4*T*H*D*2 = 8 MB at T=512) are ~2.5 us at
// 3.35 TB/s.  This first version does the products with f32 FMAs out of
// shared memory, so it is bound by FMA issue and shared-memory reads,
// far from either roofline; mma/wgmma tiles are the next step.
//
// Design:
//   * one thread block per (64-row Q tile, b*h pair), 256 threads; the
//     [B, T, H, D] tensors are read through their strides, so there is
//     no transpose to [bh, T, D] as on the TPU (flash_attention.py:235);
//   * the KV loop stops at the last tile the tile's last query can see,
//     min(Tk, q_offset + last_q + 1 - kv_offset): invisible tiles are
//     never loaded (the TPU visits them as predicated no-ops,
//     `_dispatch_masked_step` :293);
//   * the element mask runs only on tiles the diagonal or the KV tail
//     crosses; clean tiles take the unmasked path;
//   * scores, the running max and sum and pv are f32; v is upcast (as the
//     TPU kernel does at :103-110) and masked probabilities are exactly 0
//     (:99-100), so a row with no visible key ends with l = 0, pv = 0 and
//     m = -1e30, finite;
//   * each thread owns a 4x4 block of the 64x64 score tile (rows
//     4*ty..4*ty+3, columns tx + 16*j) and the same 4 rows of the
//     64xD accumulator (columns tx + 16*j), so the softmax statistics of
//     a row live in the 16 lanes of one half-warp and are reduced with
//     shuffles; shared rows are padded so column reads do not conflict.
//   With NORMALIZE the epilogue writes o = pv / max(l, 1e-20) in the
//   input's dtype (the public `flash_attention`); without it, pv in f32
//   (the ring-step contract).  m and l are written either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = BK + 4;  // sP row stride: the two rows a warp reads sit 16 banks apart
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

struct Strides {
  long long b, t, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP);
}

template <typename T, int D, bool NORMALIZE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Strides sq, Strides sk, Strides sv,
                 void* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int Tq, int Tk,
                 int q_offset, int kv_offset, int causal, float scale) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    sQ[r * DP + d] = t < Tq ? to_f32(qb[t * sq.t + d]) : 0.f;
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
      sK[r * DP + d] = ok ? to_f32(kb[t * sk.t + d]) : 0.f;
      sV[r * D + d] = ok ? to_f32(vb[t * sv.t + d]) : 0.f;
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
    const size_t o = (((size_t)b * Tq + row) * H + h) * D;
    if (NORMALIZE) {
      const float inv = 1.f / fmaxf(l_i[i], 1e-20f);
      T* ob = static_cast<T*>(out) + o;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) ob[tx + 16 * cc] = from_f32<T>(acc[i][cc] * inv);
    } else {
      float* ob = static_cast<float*>(out) + o;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) ob[tx + 16 * cc] = acc[i][cc];
    }
  }
}

template <typename T, int D, bool NORMALIZE>
cudaError_t launch(const void* q, const void* k, const void* v, Strides sq,
                   Strides sk, Strides sv, void* out, float* m, float* l,
                   int B, int H, int Tq, int Tk, int q_offset, int kv_offset,
                   int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, NORMALIZE>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sq, sk, sv, out, m, l, H, Tq, Tk, q_offset,
      kv_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_norm(int normalize, const void* q, const void* k,
                        const void* v, Strides sq, Strides sk, Strides sv,
                        void* out, float* m, float* l, int B, int H, int Tq,
                        int Tk, int q_offset, int kv_offset, int causal,
                        float scale, cudaStream_t stream) {
  if (normalize)
    return launch<T, D, true>(q, k, v, sq, sk, sv, out, m, l, B, H, Tq, Tk,
                              q_offset, kv_offset, causal, scale, stream);
  return launch<T, D, false>(q, k, v, sq, sk, sv, out, m, l, B, H, Tq, Tk,
                             q_offset, kv_offset, causal, scale, stream);
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
  const Strides sq{sq_b, sq_t, sq_h}, sk{sk_b, sk_t, sk_h}, sv{sv_b, sv_t, sv_h};
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_norm<float, 64>(normalize, q, k, v, sq, sk, sv, out, mf, lf, B,
                                  H, Tq, Tk, q_offset, kv_offset, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch_norm<float, 128>(normalize, q, k, v, sq, sk, sv, out, mf, lf, B,
                                   H, Tq, Tk, q_offset, kv_offset, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch_norm<__nv_bfloat16, 64>(normalize, q, k, v, sq, sk, sv, out, mf,
                                          lf, B, H, Tq, Tk, q_offset, kv_offset,
                                          causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch_norm<__nv_bfloat16, 128>(normalize, q, k, v, sq, sk, sv, out, mf,
                                           lf, B, H, Tq, Tk, q_offset, kv_offset,
                                           causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
