// int8 GEMM on the int8 tensor cores of sm_90a, with exact int32 sums,
// split-K and a fused fp32 dequant + bias + activation epilogue.
//
// Replaces the int8 bodies of the TPU kernel
// src/repro/kernels/gemm/kernel.py::matmul_pallas
// (_matmul_q8_{,bias_}kernel_{6loop,3loop}, :107-137):
// C = act(float(A_q @ B_q) * scale + bias), A_q (M, K) and B_q (K, N)
// row-major int8, scale and bias (N,) fp32, C (M, N) fp32.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries an int32 VMEM accumulator across the K axis.  Here each block
// computes one BM x BN tile of C over one contiguous range of K chunks of
// 32: 8 warps, each a 16-row x 32-column slab held as 4 m16n8 int32
// accumulators of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (the
// s8 helpers of kernels/csrc/s8_mma.cuh, shared with the int8 conv).  Two
// tiles are compiled: 64 x 64 (4 x 2 warps), and 128 x 32 (8 x 1) for
// N <= 32, so MODEL_20's N = 32 layer spends no half block on masked
// columns; the wrapper picks the tile from N (ops.py::tile_q8).  The sum
// is exact in int32 (the wrapper refuses K * 127^2 >= 2^31), as the plain
// version's, so the output equals it bit for bit.
//
// Staging.  A stage is up to 4 chunks (128 bytes of K): A's rows (A is
// K-contiguous, so each row's stage is one 128-byte line) and B's raw rows
// (128 K rows x BN bytes) go by cp.async into a ring of 3 stages in
// dynamic shared memory, two stages in flight while one is computed.
// Whole lines matter: with one 32-byte chunk a stage, the blocks of a
// call read every row of A in four scattered pieces, and MODEL_20's K =
// 256 calls took 10.7 us, not 7.7 (scripts/gemm_q8_variants.py).  Ragged
// M, N and K are zero-filled by the copies' source size (K % 32 == 16
// leaves the last chunk's upper half zero), so no caller pads an operand.
// B's raw rows go as 16-byte copies where N % 16 == 0 and B is 16-byte
// aligned, else as byte loads (N = 255: the detection heads).  Each stage,
// the block turns B's raw rows into one 128-byte K line per column (the
// __byte_perm turn of the shared header), and ldmatrix reads A's and B's
// lines as the fragments; their 16-byte segments are XOR-swizzled by
// row % 8, so an ldmatrix phase hits 8 distinct banks.  A stage costs two
// barriers: one publishes its copies (and frees the slot the next copy
// overwrites), one its turned B.
//
// Split-K.  At batch 1 the 1x1 convs of YOLOv3-tiny 416 are 169 rows: 6
// to 12 tiles for 132 SMs.  The grid is (M/BM, N/BN, splits): split s
// takes the chunks [s * n / splits, (s + 1) * n / splits) of n =
// ceil(K / 32) (ops.py::call_splits_q8: kernels/_splitk.py::split_k over
// this kernel's MIN_BLOCKS resident blocks a SM).  With splits == 1 the
// kernel applies the epilogue; else each block writes its int32 partial
// tile to the workspace (splits, M, N) and gemm_q8_splitk_reduce_kernel
// adds the partials in split order (exact) and applies it.  The epilogue
// is float(acc) * scale then + bias, each rounded on its own (no FMA
// contraction), then the activation.
//
// Output.  The accumulators go through shared memory as an int32 tile and
// leave by whole rows, consecutive threads on consecutive columns: 16-byte
// stores where N % 4 == 0 (a warp writes 512 contiguous bytes), else
// 4-byte ones, so every sector is written whole and none is filled from
// device memory first (the fragments' own layout, 8 rows x 32 bytes a
// store, wrote N = 255's partials in half sectors: 5 us of 9).
//
// What bounds it.  The int8 products are far below the 1979 TOP/s of the
// tensor cores.  The 169-row calls are latency: a block runs one stage
// (its copies from device memory), writes its partial tile, and the
// reduce launch follows.  The large-M calls (MODEL_20 608: M = 5776 to
// 92416, K = 64 to 256) are bytes, the fp32 output most of them; there
// what counts is blocks in flight: at 78 registers a thread 3 blocks fit
// a SM (at 89-91, 2: MODEL_20's six 0.058 ms, not 0.050), though the
// launch bounds ask for 2, the count the split rule is given.
#include <cuda_runtime.h>
#include <stdint.h>

#include "describe.cuh"
#include "per_device.cuh"
#include "s8_mma.cuh"

namespace {

using s8mma::cp_async16;
using s8mma::cp_async_commit;
using s8mma::dequant;
using s8mma::ldmatrix_x4;
using s8mma::mma_s8;
using s8mma::Quad;
using s8mma::smem_addr;
using s8mma::turn_quad;

constexpr int CK = 32;          // K per chunk: one m16n8k32 step
constexpr int SK = 4;           // chunks per stage
constexpr int KS = CK * SK;     // K bytes per stage: a 128-byte line of A
constexpr int STAGES = 3;       // stages in the cp.async ring
constexpr int THREADS = 256;    // 8 warps, a 16 x 32 slab each
constexpr int MIN_BLOCKS = 2;   // __launch_bounds__ minimum blocks a SM

// The tile of WM warps over M and 8 / WM over N, and its shared memory:
// STAGES stages of A (BM rows x KS) and of raw B (KS rows x BN), then B
// turned (BN rows x KS); the epilogue reuses the front as a BM x LD int32
// tile.
template <int WM>
struct Tile {
  static constexpr int BM = 16 * WM;
  static constexpr int BN = 32 * (8 / WM);
  static constexpr int LD = BN + 4;
  static constexpr int A_BYTES = BM * KS;
  static constexpr int RAW_BYTES = KS * BN;
  static constexpr int SMEM = STAGES * (A_BYTES + RAW_BYTES) + BN * KS;
  static_assert(BM * LD * 4 <= SMEM, "epilogue tile");
};

// Byte offset of byte b of the K line of row `row` (A, or B turned):
// 16-byte segments XOR-swizzled by row % 8, so the 8 rows of an ldmatrix
// phase, which read one segment each, fall on distinct banks.
__device__ __forceinline__ int line_offset(int row, int b) {
  return row * KS + 16 * ((b >> 4) ^ (row & (KS / 16 - 1))) + (b & 15);
}

template <int WM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gemm_q8_bias_act_kernel(const int8_t* __restrict__ A,
                        const int8_t* __restrict__ B,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float* __restrict__ C,
                        int* __restrict__ ws, int M, int N, int K, int act,
                        int splits) {
  using T = Tile<WM>;
  constexpr int BM = T::BM, BN = T::BN;
  extern __shared__ __align__(128) unsigned char smem_g8[];
  unsigned char* const a_s = smem_g8;
  unsigned char* const b_raw = smem_g8 + STAGES * T::A_BYTES;
  unsigned char* const b_t = b_raw + STAGES * T::RAW_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int chunks = (K + CK - 1) / CK;
  const int lo = split * chunks / splits;
  const int hi = (split + 1) * chunks / splits;
  const int n_stages = (hi - lo + SK - 1) / SK;
  const bool b_vec =
      N % 16 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  // Chunks in stage i (the last may hold fewer than SK).
  auto stage_chunks = [&](int i) { return min(SK, hi - lo - SK * i); };

  // Stage i of A and of raw B into ring slot `st`: its chunks only.
  auto stage = [&](int i, int st) {
    const int k0 = (lo + SK * i) * CK;
    const int kb = CK * stage_chunks(i);   // K bytes of the stage
    unsigned char* as = a_s + st * T::A_BYTES;
#pragma unroll 1
    for (int idx = tid; idx < BM * (KS / 16); idx += THREADS) {
      const int r = idx / (KS / 16), b = 16 * (idx % (KS / 16));
      if (b >= kb) continue;
      const int gm = m0 + r, gk = k0 + b;
      const bool in = gm < M && gk < K;   // K % 16 == 0: all in or all out
      cp_async16(as + line_offset(r, b), in ? A + (size_t)gm * K + gk : A,
                 in);
    }
    unsigned char* raw = b_raw + st * T::RAW_BYTES;
    if (b_vec) {
      for (int idx = tid; idx < kb * (BN / 16); idx += THREADS) {
        const int k = idx / (BN / 16), n = 16 * (idx % (BN / 16));
        const bool in = k0 + k < K && n0 + n < N;
        cp_async16(raw + k * BN + n,
                   in ? B + (size_t)(k0 + k) * N + n0 + n : B, in);
      }
    } else {
      for (int idx = tid; idx < kb * (BN / 4); idx += THREADS) {
        const int k = idx / (BN / 4), n = 4 * (idx % (BN / 4));
        uint32_t v = 0;
        if (k0 + k < K) {
          const int8_t* src = B + (size_t)(k0 + k) * N + n0 + n;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + n + j < N)
              v |= (uint32_t)(uint8_t)__ldg(src + j) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(raw + k * BN + n) = v;
      }
    }
  };
  // Raw B of ring slot `st` (kb K rows) turned into b_t: item (group of 4
  // columns ng, group of 4 K rows cg), ng fastest; the 4 rows a quad writes
  // go in an order rotated by ng / 2, so a warp's stores spread over the
  // swizzled segments.
  auto turn = [&](int st, int kb) {
    const unsigned char* raw = b_raw + st * T::RAW_BYTES;
    for (int item = tid; item < (kb / 4) * (BN / 4); item += THREADS) {
      const int ng = item % (BN / 4), cg = item / (BN / 4);
      Quad q;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        q.w[r] = *reinterpret_cast<const uint32_t*>(raw + (4 * cg + r) * BN +
                                                    4 * ng);
      uint32_t v[4];
      turn_quad(q, v);
      const int rot = (ng >> 1) & 3;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = (s + rot) & 3;
        const uint32_t w = j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
        *reinterpret_cast<uint32_t*>(b_t + line_offset(4 * ng + j, 4 * cg)) =
            w;
      }
    }
  };

  // This lane's ldmatrix rows: A's (rows of the warp's 16-row slab) and
  // B's (columns of its 32-column slab, per pair of n8 tiles), and which
  // 16-byte half of a k32 step it reads.
  const int a_row = 16 * wm + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_half = lane >> 4;
  const int b_row = 32 * wn + 8 * (lane >> 4) + (lane & 7);
  const int b_half = (lane >> 3) & 1;

  int acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0;

  // Rolled, as A's copy loop: unrolled, the kernel takes 89-91 registers a
  // thread and 2 blocks fit a SM; rolled, 78 and 3.
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) stage(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    const int st = i % STAGES;
    const int kb = CK * stage_chunks(i);
    s8mma::cp_async_wait<STAGES - 2>();
    // Stage i has landed, and every warp is done with stage i - 1: its
    // ring slot and b_t are free.
    __syncthreads();
    if (i + STAGES - 1 < n_stages)
      stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    turn(st, kb);
    __syncthreads();
    const unsigned char* as = a_s + st * T::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      if (CK * kk >= kb) break;
      uint32_t a[4], bw[2][4];
      ldmatrix_x4(a, smem_addr(as + line_offset(a_row, CK * kk + 16 * a_half)));
#pragma unroll
      for (int pair = 0; pair < 2; ++pair)
        ldmatrix_x4(bw[pair], smem_addr(b_t + line_offset(
                                  b_row + 16 * pair, CK * kk + 16 * b_half)));
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc[ni], a, bw[ni / 2][2 * (ni % 2)],
               bw[ni / 2][2 * (ni % 2) + 1]);
    }
  }

  // The accumulators into a BM x BN int32 tile in shared memory (lane (g,
  // t) holds rows g, g + 8 and columns 2t, 2t + 1 of each n8 tile), then
  // out by whole rows: 16-byte stores where N % 4 == 0, else 4-byte ones,
  // consecutive threads on consecutive columns.  splits == 1: the epilogue
  // into C; else the int32 partial tile into this split's slice of the
  // workspace.
  s8mma::cp_async_wait<0>();
  __syncthreads();
  int* tile = reinterpret_cast<int*>(smem_g8);
  {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<int2*>(
            tile + (16 * wm + g + 8 * hrow) * T::LD + 32 * wn + 8 * ni +
            2 * t) = make_int2(acc[ni][2 * hrow], acc[ni][2 * hrow + 1]);
  }
  __syncthreads();
  const bool has_bias = bias != nullptr;
  if (N % 4 == 0) {
    constexpr int PER_ROW = BN / 4;            // threads a row
    const int c = 4 * (tid % PER_ROW);
    const int n = n0 + c;
    if (n >= N) return;
    float sc[4], bi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] = __ldg(scale + n + e);
      bi[e] = has_bias ? __ldg(bias + n + e) : 0.f;
    }
    for (int r = tid / PER_ROW; r < BM && m0 + r < M;
         r += THREADS / PER_ROW) {
      const int4 v = *reinterpret_cast<const int4*>(tile + r * T::LD + c);
      const size_t at = (size_t)(m0 + r) * N + n;
      if (splits == 1) {
        *reinterpret_cast<float4*>(C + at) = make_float4(
            dequant(v.x, sc[0], bi[0], has_bias, act),
            dequant(v.y, sc[1], bi[1], has_bias, act),
            dequant(v.z, sc[2], bi[2], has_bias, act),
            dequant(v.w, sc[3], bi[3], has_bias, act));
      } else {
        *reinterpret_cast<int4*>(ws + (size_t)split * M * N + at) = v;
      }
    }
  } else {
    const int c = tid % BN;
    const int n = n0 + c;
    if (n >= N) return;
    const float sc = __ldg(scale + n);
    const float bi = has_bias ? __ldg(bias + n) : 0.f;
    for (int r = tid / BN; r < BM && m0 + r < M; r += THREADS / BN) {
      const int v = tile[r * T::LD + c];
      const size_t at = (size_t)(m0 + r) * N + n;
      if (splits == 1)
        C[at] = dequant(v, sc, bi, has_bias, act);
      else
        ws[(size_t)split * M * N + at] = v;
    }
  }
}

// C = act(float(sum over the splits of ws) * scale + bias), V consecutive
// elements per thread (V = 4 when N % 4 == 0): the shared split-K reduce,
// under this kernel's own name.
template <int V>
__global__ void __launch_bounds__(256)
gemm_q8_splitk_reduce_kernel(const int* __restrict__ ws,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             float* __restrict__ C, size_t n, int N,
                             int splits, int act) {
  s8mma::splitk_reduce<V>(ws, scale, bias, C, n, N, splits, act);
}

// The kernel's launch at tile WM for an M x N product cut into `splits`,
// after its shared memory limit is raised on the current device (once).
template <int WM>
cudaError_t plan_q8(int M, int N, int splits, describe::Launch* l) {
  using T = Tile<WM>;
  static bool smem_set[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(gemm_q8_bias_act_kernel<WM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  l->grid = dim3((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN, splits);
  l->threads = THREADS;
  l->smem = T::SMEM;
  l->stages = STAGES;
  l->func = (const void*)&gemm_q8_bias_act_kernel<WM>;
  return l->grid.y > 65535 ? cudaErrorInvalidValue : cudaSuccess;
}

// The reduce's launch over the M x N output.
describe::Launch plan_q8_reduce(int M, int N) {
  return describe::reduce((size_t)M * N, N,
                          (const void*)&gemm_q8_splitk_reduce_kernel<4>,
                          (const void*)&gemm_q8_splitk_reduce_kernel<1>);
}

template <int WM>
cudaError_t launch(const int8_t* A, const int8_t* B, const float* scale,
                   const float* bias, float* C, int* ws, int M, int N, int K,
                   int act, int splits, cudaStream_t stream) {
  describe::Launch l;
  const cudaError_t err = plan_q8<WM>(M, N, splits, &l);
  if (err != cudaSuccess) return err;
  gemm_q8_bias_act_kernel<WM><<<l.grid, l.threads, l.smem, stream>>>(
      A, B, scale, bias, C, ws, M, N, K, act, splits);
  return cudaGetLastError();
}

}  // namespace

// C = act(float(A_q @ B_q) * scale + bias); K % 16 == 0, A 16-byte
// aligned; bias may be null; bn is the tile width, 64 (a 64 x 64 tile) or
// 32 (128 x 32); 1 <= splits <= max(1, ceil(K / 32)), splits <= 65535; ws
// holds splits * M * N int32 when splits > 1 (else it may be null).
// Returns cudaGetLastError().
extern "C" int repro_gemm_q8_bias_act(const int8_t* A, const int8_t* B,
                                      const float* scale, const float* bias,
                                      float* C, int* ws, int M, int N, int K,
                                      int act, int bn, int splits,
                                      cudaStream_t stream) {
  const int chunks = (K + CK - 1) / CK;
  if (M < 1 || N < 1 || K < 0 || K % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(A) & 15) != 0 || (bn != 32 && bn != 64) ||
      splits < 1 || splits > (chunks > 1 ? chunks : 1) || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      bn == 32 ? launch<8>(A, B, scale, bias, C, ws, M, N, K, act, splits,
                           stream)
               : launch<4>(A, B, scale, bias, C, ws, M, N, K, act, splits,
                           stream);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)M * N;
  const describe::Launch red = plan_q8_reduce(M, N);
  if (N % 4 == 0)
    gemm_q8_splitk_reduce_kernel<4><<<red.grid, red.threads, 0, stream>>>(
        ws, scale, bias, C, n, N, splits, act);
  else
    gemm_q8_splitk_reduce_kernel<1><<<red.grid, red.threads, 0, stream>>>(
        ws, scale, bias, C, n, N, splits, act);
  return static_cast<int>(cudaGetLastError());
}

// What repro_gemm_q8_bias_act launches for args = (M, N, K, bn, splits):
// the GEMM kernel (which 0) or the reduce (which 1), as describe.cuh lays
// it out.
extern "C" int repro_gemm_q8_describe(const int* args, int nargs, int which,
                                      long long* out) {
  if (nargs != 5 || which < 0 || which > 1 || args[0] < 1 || args[1] < 1 ||
      (args[3] != 32 && args[3] != 64) || args[4] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  if (which == 1) {
    l = plan_q8_reduce(args[0], args[1]);
  } else {
    const cudaError_t err =
        args[3] == 32 ? plan_q8<8>(args[0], args[1], args[4], &l)
                      : plan_q8<4>(args[0], args[1], args[4], &l);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return describe::write(l, out);
}
