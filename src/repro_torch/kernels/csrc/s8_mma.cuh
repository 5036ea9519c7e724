// The int8 tensor-core helpers of the port (sm_90a), shared by the two int8
// kernels: im2col_gemm/csrc/im2col_conv_q8.cu (the implicit-GEMM conv) and
// gemm/csrc/gemm_q8.cu (the 1x1-conv GEMM).  Each kernel owns its grid,
// its staging and its epilogue; what is here is what both do alike.
//
// Products.  mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: a 16x32 s8 A
// fragment times a 32x8 s8 B fragment into a 16x8 int32 accumulator,
// exact.  Both operands are staged in shared memory as rows of consecutive
// K values (A: one row per output row; B: one row per output column), and
// ldmatrix.x4 reads them: the b16 "8x8 matrices" are here 8 rows of 16
// bytes.  Each kernel lays out and swizzles its own rows (the conv 32-byte
// rows, the GEMM 128-byte lines).
//
// B's turn.  The B fragment wants 4 consecutive K bytes of one column,
// while both kernels' weights keep the columns (out channels) contiguous:
// a quad of 4 K rows x 4 columns, as 4 words of 4 columns each, is turned
// by __byte_perm into 4 words of 4 K values, one per column (turn_quad),
// which each kernel stores into its columns' rows.
//
// Epilogue.  float(acc) * scale, then + bias, each rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), then the activation: the
// plain versions' order, so both kernels equal them bit for bit.  Where a
// kernel splits K, its blocks write int32 partials to a workspace
// (splits, rows, cols) and splitk_reduce adds them in split order (exact)
// before the epilogue; each kernel wraps it in a __global__ of its own
// name, so a profile tells the two reduce kernels apart.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage, as every kernel source here: nothing in this header is
// shared between the libraries that include it.
namespace {
namespace s8mma {

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

// act(float(acc) * scale + bias), each operation rounded on its own.
__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool has_bias, int act) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (has_bias) v = __fadd_rn(v, bias);
  return activate(v, act);
}

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

// Four 8x8 b16 matrices (here 8 rows of 16 bytes each) from shared memory;
// lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 int32) += a (16x32 s8, row) . b (32x8 s8, col), exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A quad of B: 4 K rows x 4 columns, as loaded (word r holds columns
// c .. c + 3 of K row r, the lowest column in the lowest byte).
struct Quad {
  uint32_t w[4];
};

// The quad turned: v[j] holds K rows 0 .. 3 of column j, the lowest row in
// the lowest byte (4 consecutive K values of one column, as the B fragment
// of m16n8k32 wants them).
__device__ __forceinline__ void turn_quad(const Quad& q, uint32_t (&v)[4]) {
  const uint32_t lo01 = __byte_perm(q.w[0], q.w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(q.w[0], q.w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(q.w[2], q.w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(q.w[2], q.w[3], 0x7362);
  v[0] = __byte_perm(lo01, lo23, 0x5410);
  v[1] = __byte_perm(lo01, lo23, 0x7632);
  v[2] = __byte_perm(hi01, hi23, 0x5410);
  v[3] = __byte_perm(hi01, hi23, 0x7632);
}

// V consecutive int32 of the workspace (V = 4: one 16-byte load).
template <int V>
__device__ __forceinline__ void load_ints(const int* __restrict__ src,
                                          int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(src));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __ldg(src + e);
  }
}

// out = act(float(sum over the splits of ws) * scale + bias) for the V
// consecutive elements i .. i + V - 1 of the n = rows * cols outputs (V = 4
// needs cols % 4 == 0), i from the thread's global index.  The partials are
// added in split order; their loads go 8 splits at a time, so a thread
// waits for one round trip per 8 splits, not one per split.
template <int V>
__device__ __forceinline__ void splitk_reduce(const int* __restrict__ ws,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              float* __restrict__ out,
                                              size_t n, int cols, int splits,
                                              int act) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  int s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0;
  int p = 0;
  for (; p + 8 <= splits; p += 8) {
    int t[8][V];
#pragma unroll
    for (int q = 0; q < 8; ++q) load_ints<V>(ws + (p + q) * n + i, t[q]);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += t[q][e];
  }
  for (; p < splits; ++p) {
    int t[V];
    load_ints<V>(ws + p * n + i, t);
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] += t[e];
  }
  const int c = static_cast<int>(i % cols);
#pragma unroll
  for (int e = 0; e < V; ++e)
    out[i + e] = dequant(s[e], __ldg(scale + c + e),
                         bias != nullptr ? __ldg(bias + c + e) : 0.f,
                         bias != nullptr, act);
}

}  // namespace s8mma
}  // namespace
