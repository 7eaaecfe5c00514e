// Hopper tensor-core building blocks shared by the bf16 flash-attention
// kernels (flash_fwd.cu: K1; flash_bwd.cu: K2 and K3), sm_90a only.
//
// Every tile is ROWS = 64 rows of D bf16 values, stored as D/64 column
// blocks of 64 rows x 128 bytes with each row's 16-byte chunks
// XOR-swizzled by row % 8: the 128-byte swizzle that wgmma's matrix
// descriptors read.  One stored tile serves as a K-major operand (rows
// along the reduction: S = Q K^T) and as an MN-major one (B read
// transposed: O += P V, dQ += dS K).  One warpgroup (NTC = 128 threads)
// owns a 64-row block; loads are 16-byte cp.async copies, zero-filled
// past a tail; accumulators are f32 registers in wgmma's layout
// (acc_row / acc_col), from which P or dS pack into the register A
// operand of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmlc_tc {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;   // rows of every tile: BQ = BK = 64
constexpr int NTC = 128;   // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return ROWS * D * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte and 4-byte async copies; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight, then
// make its copies visible to wgmma's (async proxy) reads
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk j of row r in a swizzled [64][D] tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (j >> 3) * (ROWS * 128) + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// rows [t0, t0 + 64) of one (b, h) of a strided [B, T, H, D] bf16 tensor
// into the swizzled tile at dst; rows >= t_end are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                long long stride_t, int t0,
                                                int t_end) {
  constexpr int CH = D / 8;  // 16-byte chunks in a row
#pragma unroll
  for (int n = 0; n < ROWS * CH / NTC; ++n) {
    const int i = threadIdx.x + n * NTC;
    const int r = i / CH, j = i % CH;
    const int t = t0 + r;
    const bool ok = t < t_end;
    cp_async16(dst + swz(r, j), src + (ok ? t * stride_t : 0) + j * 8,
               ok ? 16 : 0);
  }
}

// 64 per-row floats (lse or delta) from t0 on; rows >= t_end are zeros
__device__ __forceinline__ void load_rows_async(uint32_t dst, const float* src,
                                                int t0, int t_end) {
  const int r = threadIdx.x;
  if (r < ROWS) {
    const bool ok = t0 + r < t_end;
    cp_async4(dst + 4 * r, src + (ok ? t0 + r : 0), ok ? 4 : 0);
  }
}

// wgmma matrix descriptor: start address, leading and stride byte
// offsets, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand, k-step kk (16 columns) of a [64][D] tile: 32 bytes
// into the 128-byte rows of column block kk / 4; 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (B read transposed), k-step kk (16 rows) of a [64][D]
// tile whose columns are N: rows 16 kk on; 8-row groups 1 KB apart along
// K (stride offset), column blocks 8 KB apart along N (leading offset)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous product that owns the registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// both K-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16x2
// a thread), B from shared memory MN-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (four bf16x2
// a thread), B from shared memory MN-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// acc[64 x 64] = A B^T over D, A and B [64][D] tiles read K-major
template <int D>
__device__ __forceinline__ void gemm_abt(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// acc[64 x D] += F B over 64 rows: F the [64 x 64] register operand
// (four bf16x2 per 16-column step), B a [64][D] tile read MN-major
template <int D>
__device__ __forceinline__ void gemm_fb(float (&acc)[D / 2],
                                        const uint32_t (&f)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_n64(acc, f + 4 * kk, desc_mn(b, kk));
    else
      wgmma_rs_n128(acc, f + 4 * kk, desc_mn(b, kk));
  }
}

// Accumulator layout of a 64 x N wgmma tile: element i of a thread in
// warp w (lane = 4 g + c) is row 16 w + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 c + (i & 1).  Packing elements 2i and 2i+1 gives the
// register A operand of the next product: its 16-column step kk is
// f[4 kk .. 4 kk + 3].
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// acc [64 x D] * mul rounded to bf16 into rows [r0, r0 + 64) (< r_end)
// of a contiguous [B, T, H, D] output at out (row stride stride_t),
// staged in the free swizzled tile at stile so each thread stores whole
// 16-byte chunks
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2],
                                           float mul, uint8_t* stile,
                                           bf16* out, long long stride_t,
                                           int r0, int r_end) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = acc_row(i), col = acc_col(i);
    *reinterpret_cast<uint32_t*>(stile + swz(r, col >> 3) + 2 * (col & 7)) =
        pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
  __syncthreads();
  constexpr int CH = D / 8;
#pragma unroll
  for (int n = 0; n < ROWS * CH / NTC; ++n) {
    const int i = threadIdx.x + n * NTC;
    const int r = i / CH, j = i % CH;
    if (r0 + r < r_end)
      *reinterpret_cast<uint4*>(out + (r0 + r) * stride_t + j * 8) =
          *reinterpret_cast<const uint4*>(stile + swz(r, j));
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

}  // namespace dmlc_tc
