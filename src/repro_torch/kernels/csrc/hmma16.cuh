// The 16-bit device helpers of the port's bf16 and fp16 kernels on sm_90a:
// the element conversions, the fused activation, the mma.sync m16n8k16
// product with fp32 sums, ldmatrix, the cp.async copies and an ordered
// split-K reduce.  The 16-bit fused Winograd kernel
// (winograd/csrc/winograd_fused_16.cu) runs its products on mma.sync and
// its C split's reduce here; the 16-bit GEMM, implicit-GEMM conv and tuple
// multiply run theirs on wgmma (csrc/wgmma16.cuh) and take the
// conversions, activation and ldmatrix from here; the flash-attention
// backward sums its head split's partials with the reduce, in bf16 and
// fp32.
//
// Math.  mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}.{bf16,f16}.f32:
// the product of two 16-bit values is exact in fp32, so a sum is an fp32
// sum of exact products; the caller rounds once, at its store.  Operand
// fragments come from shared memory by ldmatrix: A's (16 rows x 16 of K)
// by ldmatrix.x4 from rows of K, B's (16 of K x 16 columns, two n8
// fragments) by ldmatrix.x4.trans from rows of N, so B is kept as it lies
// in device memory (K, N) and never transposed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// Internal linkage, as every kernel source here: nothing in this header is
// shared between the libraries that include it.
namespace {
namespace hmma16 {

// ---------------------------------------------------------------------------
// The two element types.

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// v rounded to T, to nearest even.
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// (lo, hi) rounded to T, lo in the low 16 bits.
template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c (16x8 fp32) += a (16x16, row) . b (16x8, col), both of type T.
template <class T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(float (&c)[4],
                                                     const uint32_t (&a)[4],
                                                     uint32_t b0,
                                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// act: 0 linear, 1 relu, 2 leaky (slope 0.1, as Darknet).
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

// ---------------------------------------------------------------------------
// Shared memory, copies and fragments.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 matrices of 16-bit values from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8, and receives row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// The same, transposed: lane l receives rows 2 (l % 4) and 2 (l % 4) + 1
// of column l / 4 of each matrix.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// This lane's row and 8-value column offset for ldmatrix.x4 of a 16x16 A
// fragment at (row0, col0) of a row-major [row][col] array: matrices
// (rows 0-7, 8-15) x (columns 0-7, 8-15) in the register order
// a0 .. a3 of m16n8k16.
__device__ __forceinline__ int a_frag_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_frag_col(int lane) { return (lane >> 4) * 8; }
// ... and for ldmatrix.x4.trans of B (16 of K x 16 columns) from a [k][n]
// array: r0, r1 the b0, b1 of columns 0-7, r2, r3 those of columns 8-15.
__device__ __forceinline__ int b_frag_k(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int b_frag_n(int lane) { return (lane >> 4) * 8; }

// ---------------------------------------------------------------------------
// The ordered split-K reduce.

// out[i .. i + V) = act(sum over the splits of ws[., i .. i + V) + bias)
// rounded to T (float: stored as summed), the partials added in split
// order (V = 4 needs cols % 4 == 0 and rows of out aligned to 4 values:
// 8 bytes in 16 bits, 16 in fp32), i from the thread's global index.
template <class T, int V>
__device__ __forceinline__ void splitk_reduce(const float* __restrict__ ws,
                                              const float* __restrict__ bias,
                                              T* __restrict__ out, size_t n,
                                              int cols, int splits, int act) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float* src = ws + p * n + i;
    if constexpr (V == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src));
      s[0] += t.x; s[1] += t.y; s[2] += t.z; s[3] += t.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += __ldg(src + e);
    }
  }
  const int c = static_cast<int>(i % cols);
#pragma unroll
  for (int e = 0; e < V; ++e)
    s[e] = activate(s[e] + (bias != nullptr ? __ldg(bias + c + e) : 0.f), act);
  if constexpr (std::is_same<T, float>::value && V == 4) {
    *reinterpret_cast<float4*>(out + i) = make_float4(s[0], s[1], s[2], s[3]);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < V; ++e) out[i + e] = s[e];
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(out + i) =
        make_uint2(pack2<T>(s[0], s[1]), pack2<T>(s[2], s[3]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[i + e] = from_f32<T>(s[e]);
  }
}

}  // namespace hmma16
}  // namespace
