// The 16-bit GEMM core of the port, on the tensor cores of sm_90a: one 64x64
// output tile of C = A.B over a range of K, A and B bf16 or fp16, the
// products summed in fp32 registers.  Included by gemm/csrc/gemm_16.cu (the
// 1x1-conv GEMM, with split-K) and winograd/csrc/winograd_3pass_16.cu (the
// tuple multiply, one position per blockIdx.z); each owns its grid, its K
// range and its epilogue.  im2col_gemm/csrc/im2col_conv_16.cu and
// winograd/csrc/winograd_fused_16.cu use only its device helpers (the
// element conversions, ldmatrix, mma, the cp.async wrappers), not the tile
// loop.  It is the 16-bit twin of csrc/sgemm_3xtf32.cuh, with the same
// interface.
//
// Math.  mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}.{bf16,f16}.f32;
// 4 warps (128 threads) in a 2x2 layout, each warp a 32x32 quarter of the
// tile: 2 x 4 m16n8 accumulator fragments, 32 floats a thread.  The
// product of two 16-bit values is exact in fp32, so the sum is an fp32 sum
// of exact products; the caller rounds once, at its store.  The operand
// fragments come from shared memory by ldmatrix: A's (16 rows x 16 of K)
// by ldmatrix.x4 from rows of K, B's (16 of K x 16 columns, two n8
// fragments) by ldmatrix.x4.trans from rows of N, so B is kept as it lies
// in device memory (K, N) and never transposed.
//
// Split B.  With PARTS = 2, B is given as two arrays of T, B = hi + lo (lo
// the rounding error of hi: about 16 significant bits for bf16, 22 for
// fp16), and every product is A.Bhi + A.Blo, two m16n8k16 products into the
// same fp32 accumulator: the 3-pass Winograd tuple multiply takes the
// transformed weights so (winograd_3pass_16.cu).
//
// Staging.  A (64 rows x 32 of K) and B (32 of K x 64 columns) tiles go
// into a ring of STAGES stages in shared memory by cp.async, 16 bytes (8
// values) a copy: chunk i + 2 is in flight while chunk i is computed, and
// one barrier per chunk both publishes chunk i and frees the stage chunk
// i + 2 overwrites.  Ragged M, N and K are zero-filled by the copies'
// source size, so no caller pads an operand to a tile; A's rows need K % 8
// == 0 and a 16-byte aligned base (the wrappers check it).  B's rows go as
// 16-byte copies where N % 8 == 0 and the base is 16-byte aligned, else
// value by value through registers (N = 255 heads).
//
// Shared memory.  A is stored [m][32 + 8] and B [k][64 + 8] (80- and
// 144-byte rows): the 8 rows of each ldmatrix phase fall on 8 distinct
// 16-byte bank groups, and every row start stays 16-byte aligned for the
// copies.  3 stages x (5120 + 4608 PARTS) bytes = 29,184 bytes (43,008
// with PARTS = 2), static and under 48 KB; MIN_BLOCKS blocks a SM (at most
// 128 registers a thread) are what the split-K rule counts
// (gemm/ops.py::RESIDENT_BLOCKS_16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage, as every kernel source here: nothing in this header is
// shared between the libraries that include it.
namespace {
namespace hmma16 {

constexpr int BM = 64;          // output rows per tile
constexpr int BN = 64;          // output columns per tile
constexpr int BK = 32;          // K per chunk (two k16 steps)
constexpr int STAGES = 3;       // chunks in the cp.async ring
constexpr int THREADS = 128;    // 4 warps, 2 x 2, 32 x 32 outputs each
constexpr int MIN_BLOCKS = 4;   // __launch_bounds__ minimum blocks a SM
constexpr int A_LD = BK + 8;    // smem row stride of A, values
constexpr int B_LD = BN + 8;    // smem row stride of B, values

// load_chunk moves each operand's tile as 2 groups of 8 values a thread.
static_assert(BM * BK == 16 * THREADS && BK * BN == 16 * THREADS, "tile");

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
// The tile loop.

template <class T, int PARTS = 1>
struct Smem {
  T a[STAGES][BM][A_LD];
  T b[STAGES][PARTS][BK][B_LD];
};
static_assert(sizeof(Smem<__half, 2>) <= 48 * 1024, "static shared memory");

// One warp's 32x32 accumulator: [m16 tile][n8 tile][fragment element].
using Acc = float[2][4][4];

// A row-major (M, K), K % 8 == 0, 16-byte aligned; B row-major (K, N),
// and B's lo part at B + b_lo (null without one); b_vec: 16-byte copies
// of B's rows (N % 8 == 0, base and lo part 16-byte aligned).
template <class T>
struct Operands {
  const T* A;
  const T* B;
  size_t b_lo;
  int M, N, K;
  bool b_vec;
};

template <class T>
__device__ __forceinline__ Operands<T> operands(const T* A, const T* B, int M,
                                                int N, int K,
                                                size_t b_lo = 0) {
  return {A, B, b_lo, M, N, K,
          N % 8 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0 &&
              b_lo % 8 == 0};
}

// Copies chunk `chunk` (K from 32 * chunk) of A's rows [m0, m0 + 64) and of
// B's columns [n0, n0 + 64) into stage `s`: 256 groups of 8 values of each
// operand, two of each a thread.
template <class T, int PARTS>
__device__ __forceinline__ void load_chunk(Smem<T, PARTS>& sm, int s,
                                           const Operands<T>& op, int m0,
                                           int n0, int chunk) {
  const int k0 = chunk * BK;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + THREADS * j;
    {  // A: 64 rows x 4 groups.
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const bool in = gm < op.M && gk < op.K;
      cp_async16(&sm.a[s][r][c], in ? op.A + (size_t)gm * op.K + gk : op.A,
                 in);
    }
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {  // B: 32 rows x 8 groups.
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const T* b = op.B + part * op.b_lo;
      T* dst = &sm.b[s][part][r][c];
      if (op.b_vec) {
        const bool in = gk < op.K && gn < op.N;
        cp_async16(dst, in ? b + (size_t)gk * op.N + gn : op.B, in);
      } else {
        const uint16_t* src =
            reinterpret_cast<const uint16_t*>(b) + (size_t)gk * op.N + gn;
        uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = gk < op.K && gn + e < op.N ? src[e] : uint16_t(0);
      }
    }
  }
}

// acc += this warp's 32x32 part of stage s's A (64x32) . B (32x64), B's
// parts one after the other.
template <class T, int PARTS>
__device__ __forceinline__ void compute_chunk(const Smem<T, PARTS>& sm,
                                              int s, Acc& acc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(a[mi], smem_addr(&sm.a[s][wm + mi * 16 + a_frag_row(lane)]
                                    [kk + a_frag_col(lane)]));
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(b[np],
                      smem_addr(&sm.b[s][part][kk + b_frag_k(lane)]
                                     [wn + np * 16 + b_frag_n(lane)]));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma16<T>(acc[mi][ni], a[mi], b[ni / 2][2 * (ni % 2)],
                   b[ni / 2][2 * (ni % 2) + 1]);
    }
  }
}

// acc = A[m0:m0+64, K chunks [chunk_lo, chunk_hi)] . B[same K, n0:n0+64],
// zero where the tile passes M, N or K.  Every thread of the block calls
// it; no other block is involved.
template <class T, int PARTS>
__device__ __forceinline__ void tile(const Operands<T>& op, int m0, int n0,
                                     int chunk_lo, int chunk_hi,
                                     Smem<T, PARTS>& sm, Acc& acc) {
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
    // the copy below takes (and whose value-by-value stores of B the
    // barrier publishes).
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

// dst[row * ld + col .. col + 1] = (v0, v1) rounded to T, masked at N; one
// 4-byte store where both lie inside and the address allows it.
template <class T>
__device__ __forceinline__ void store_pair16(T* dst, int ld, int row, int col,
                                             int N, float v0, float v1) {
  T* p = dst + (size_t)row * ld + col;
  if (col + 1 < N && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(v0, v1);
  } else {
    if (col < N) p[0] = from_f32<T>(v0);
    if (col + 1 < N) p[1] = from_f32<T>(v1);
  }
}

// The fp32 twin, for split-K partial sums.
__device__ __forceinline__ void store_pair32(float* dst, int ld, int row,
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

// out[i .. i + V) = act(sum over the splits of ws[., i .. i + V) + bias)
// rounded to T, the partials added in split order (V = 4 needs cols % 4 ==
// 0 and 8-byte aligned rows of out), i from the thread's global index.
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
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(out + i) =
        make_uint2(pack2<T>(s[0], s[1]), pack2<T>(s[2], s[3]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[i + e] = from_f32<T>(s[e]);
  }
}

}  // namespace hmma16
}  // namespace
