// The fp32 GEMM core of the port, on the tensor cores of sm_90a: one
// 64x64 output tile of C = A.B over a range of K, summed in fp32 registers
// from three TF32 products per fp32 product (3xTF32).  Included by
// gemm/csrc/gemm.cu (the 1x1-conv GEMM, with split-K) and
// winograd/csrc/winograd_3pass.cu (the tuple multiply, one position per
// blockIdx.z); each owns its grid, its K range and its epilogue.
//
// Math.  mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32; 4 warps
// (128 threads) in a 2x2 layout, each warp a 32x32 quarter of the tile:
// 2 x 4 m16n8 accumulator fragments, 32 floats a thread.  Each operand is
// split in registers into hi = rna(x) and lo = rna(x - hi), rna the
// rounding of cvt.rna.tf32.f32 (x - hi is exact in fp32); per k8 step the
// warp issues lo.hi and hi.lo, then hi.hi, into the same fp32
// accumulator.  The lo.lo term (2^-22 of a product) is dropped.  A product
// of two TF32 values is exact in fp32, so the sum keeps fp32's accuracy:
// scripts/tf32x3_replay.py replays this arithmetic on the CPU (about 1e-6
// of max(1, max|ref|) at K = 1024, where plain TF32, at about 3e-4, fails
// the port's 1e-4 gate).
//
// Staging.  A (64 rows x 16 of K) and B (16 of K x 64 columns) tiles go
// into a ring of STAGES stages in shared memory by cp.async: chunk i + 2
// is in flight while chunk i is computed, and one barrier per chunk both
// publishes chunk i and frees the stage chunk i + 2 overwrites.  Ragged M,
// N and K are zero-filled by the copies' source size, so no caller pads an
// operand.  Rows of A and B go as 16-byte copies where the row length is
// a multiple of 4 floats and the base 16-byte aligned (vec), else as
// 4-byte copies (N = 255 heads, ragged K).
//
// Shared memory.  A is stored [m][16 + 4] and B [k][64 + 8]: the fragment
// loads of lanes g = lane / 4, t = lane % 4 then fall on 32 distinct banks
// (20 g + t and 72 t + g, mod 32), and every row start stays 16-byte
// aligned for the copies.  3 stages x (5120 + 4608) bytes = 29,184 bytes,
// static and under 48 KB, so no cudaFuncSetAttribute is needed;
// MIN_BLOCKS blocks a SM (at most 128 registers a thread) are what the
// split-K rule counts (gemm/ops.py::RESIDENT_BLOCKS).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage, as every kernel source here: nothing in this header is
// shared between the libraries that include it.
namespace {
namespace sgemm_tc {

constexpr int BM = 64;          // output rows per tile
constexpr int BN = 64;          // output columns per tile
constexpr int BK = 16;          // K per chunk (two k8 steps)
constexpr int STAGES = 3;       // chunks in the cp.async ring
constexpr int THREADS = 128;    // 4 warps, 2 x 2, 32 x 32 outputs each
constexpr int MIN_BLOCKS = 4;   // __launch_bounds__ minimum blocks a SM
constexpr int A_LD = BK + 4;    // smem row stride of A, floats
constexpr int B_LD = BN + 8;    // smem row stride of B, floats

// load_chunk moves each operand's tile as 2 groups of 4 floats a thread.
static_assert(BM * BK == 8 * THREADS && BK * BN == 8 * THREADS, "tile");

struct Smem {
  float a[STAGES][BM][A_LD];
  float b[STAGES][BK][B_LD];
};
static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");

// One warp's 32x32 accumulator: [m16 tile][n8 tile][fragment element].
using Acc = float[2][4][4];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to 10 mantissa
// bits, ties away from zero): half a TF32 ulp added to the magnitude's
// bits, the 13 low bits cleared.  In integer instructions it times 3-12 %
// faster a call than the cvt (scripts/sgemm_tc_variants.py).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (at most 2^-22 |x|), hi and lo TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16x8 fp32) += a (16x8 tf32, row) . b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A row-major (M, K), B row-major (K, N); vec: 16-byte copies of the
// operand's rows (row length % 4 == 0, base 16-byte aligned).
struct Operands {
  const float* A;
  const float* B;
  int M, N, K;
  bool a_vec, b_vec;
};

__device__ __forceinline__ Operands operands(const float* A, const float* B,
                                             int M, int N, int K) {
  const auto aligned = [](const float* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return {A, B, M, N, K, K % 4 == 0 && aligned(A), N % 4 == 0 && aligned(B)};
}

// Copies chunk `chunk` (K from 16 * chunk) of A's rows [m0, m0 + 64) and
// of B's columns [n0, n0 + 64) into stage `s`: 256 groups of 4 floats of
// each operand, two of each a thread.
__device__ __forceinline__ void load_chunk(Smem& sm, int s, const Operands& op,
                                           int m0, int n0, int chunk) {
  const int k0 = chunk * BK;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + THREADS * j;
    {  // A: 64 rows x 4 groups.
      const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c;
      const float* src = op.A + (size_t)gm * op.K + gk;
      float* dst = &sm.a[s][r][c];
      if (op.a_vec) {
        const bool in = gm < op.M && gk < op.K;
        cp_async16(dst, in ? src : op.A, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = gm < op.M && gk + e < op.K;
          cp_async4(dst + e, in ? src + e : op.A, in);
        }
      }
    }
    {  // B: 16 rows x 16 groups.
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int gk = k0 + r, gn = n0 + c;
      const float* src = op.B + (size_t)gk * op.N + gn;
      float* dst = &sm.b[s][r][c];
      if (op.b_vec) {
        const bool in = gk < op.K && gn < op.N;
        cp_async16(dst, in ? src : op.B, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = gk < op.K && gn + e < op.N;
          cp_async4(dst + e, in ? src + e : op.B, in);
        }
      }
    }
  }
}

// acc += this warp's 32x32 part of stage s's A (64x16) . B (16x64), as
// 3xTF32: per k8 step lo.hi and hi.lo, then hi.hi.
__device__ __forceinline__ void compute_chunk(const Smem& sm, int s,
                                              Acc& acc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
      const float* a = &sm.a[s][wm + mi * 16 + g][kk + t];
      split_tf32(a[0], ah[mi][0], al[mi][0]);
      split_tf32(a[8 * A_LD], ah[mi][1], al[mi][1]);
      split_tf32(a[4], ah[mi][2], al[mi][2]);
      split_tf32(a[8 * A_LD + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      // B fragment: (k t, n g), (k t + 4, n g).
      const float* b = &sm.b[s][kk + t][wn + ni * 8 + g];
      split_tf32(b[0], bh[ni][0], bl[ni][0]);
      split_tf32(b[4 * B_LD], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// acc = A[m0:m0+64, K chunks [chunk_lo, chunk_hi)] . B[same K, n0:n0+64],
// zero where the tile passes M, N or K.  Every thread of the block calls
// it; no other block is involved.
__device__ __forceinline__ void tile(const Operands& op, int m0, int n0,
                                     int chunk_lo, int chunk_hi, Smem& sm,
                                     Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // Prologue: chunks lo .. lo + STAGES - 2 in flight, one group each
  // (empty past the range, so the group count stays fixed).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (chunk_lo + s < chunk_hi) load_chunk(sm, s, op, m0, n0, chunk_lo + s);
    cp_async_commit();
  }
  for (int chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const int i = chunk - chunk_lo;
    // This chunk's group has landed (at most STAGES - 2 younger ones
    // pending), and every thread is past computing chunk - 1, whose stage
    // the copy below takes.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = chunk + STAGES - 1;
    if (next < chunk_hi) load_chunk(sm, (i + STAGES - 1) % STAGES, op, m0, n0,
                                    next);
    cp_async_commit();
    compute_chunk(sm, i % STAGES, acc);
  }
  cp_async_wait<0>();
}

// Calls store(row, col, v0, v1) for each pair of this thread's
// accumulators, (row, col) and (row, col + 1) of the tile at (m0, n0);
// col is even.  The caller masks M and N.
template <class Store>
__device__ __forceinline__ void for_each_pair(const Acc& acc, int m0, int n0,
                                              Store store) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(m0 + wm + mi * 16 + g + 8 * h, n0 + wn + ni * 8 + 2 * t,
              acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

// dst[row * ld + col .. col + 1] = (v0, v1), masked at N; one 8-byte
// store where both lie inside and the address allows it.
__device__ __forceinline__ void store_pair(float* dst, int ld, int row,
                                           int col, int N, float v0,
                                           float v1) {
  float* p = dst + (size_t)row * ld + col;
  if (col + 1 < N && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < N) p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}

}  // namespace sgemm_tc
}  // namespace
