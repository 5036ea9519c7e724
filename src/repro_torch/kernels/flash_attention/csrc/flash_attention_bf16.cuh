// Flash attention (forward), bf16, on the tensor cores of sm_90a: the
// FlashAttention-2 forward shape from mma.sync m16n8k16 (bf16 in, fp32
// sums), ldmatrix and cp.async.  Included by flash_attention.cu, whose C
// entry sends bf16 inputs here and fp32 inputs to flash_attention_fp32.cuh.
// The block layout, the tile ranges, the mask and the softmax are
// flash_common.cuh's, shared with the fp32 kernel.
//
// Replaces the bf16 path of the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas and
// computes what its body _flash_kernel computes, with these rounding
// points: the scores q.k summed in fp32 by the tensor cores; without a
// softcap x = s * (scale * log2 e); with one x = tanh(s * (scale / cap)) *
// (cap * log2 e), each bracket one fp32 constant; the online softmax in
// base 2 (m the running max of x, p = exp2(x - m), alpha = exp2(m_old -
// m)), so exp2 with log2 e folded into the scale replaces expf.  exp2 is
// the SFU's ex2.approx.ftz (about 2^-22 relative), and tanh(y) is
// 1 - 2 / (exp2(2 y log2 e) + 1) (a few 1e-7 absolute, about 1e-5 of a
// score at cap 50): faster than tanhf and exp2f where the softcap runs
// (scripts/flash_bf16_variants.py times both).
// l sums the fp32 p before rounding; p is rounded to bf16 for P.V, as the
// reference casts the probabilities to v's type (ref.py:53); out = acc /
// max(l, 1e-37) rounded to bf16.  scripts/flash_bf16_replay.py replays
// these steps on the CPU.
//
// Blocks and warps.  One block owns BQ query rows of one (batch, head),
// 16 rows per warp: 8 warps and 128 rows at hd <= 64 (at most 128
// registers a thread, so two blocks an SM; each K and V tile is copied
// once for twice the rows, and it times level with 4 warps and 64 rows at
// Llama-3.2-1B's shape, scripts/flash_bf16_variants.py), 4 warps and 64
// rows at hd 80 and 128 (Q, S and O fragments take 211 registers at 128).
// Up to hd 128 each warp loads its Q fragments once with ldmatrix and
// keeps them in registers for the whole kv loop.  At hd 256 the O
// accumulator alone is 128 registers a thread, and Q's 16 k-steps would
// be 64 more: there Q stays in shared memory and each k-step's fragment
// is loaded again with ldmatrix where it is used, and kv tiles are 32
// keys (16 score registers, not 32), so a thread fits in 255 registers
// and two blocks of 101,376 bytes share an SM (Cfg<256>).  Query head h
// reads KV head h / (H / KV) in place: no K/V head is copied.
//
// K and V tiles of BK keys (64; 32 at hd 256) are copied from (B, Sk,
// KV, hd) into shared memory as bf16 by cp.async (16 bytes a thread,
// zero-filled past Sk) in a 2-stage ring: tile j+1 is in flight while
// tile j is computed, and one barrier per tile orders both.  Rows are
// padded by 16 bytes (hd + 8 elements, an odd number of 16-byte groups
// at every hd), so the 8 row addresses of every ldmatrix (Q and K, V
// with .trans as the B operand of P.V) fall in 8 distinct 16-byte bank
// groups.
//
// S = Q.K^T lands in fp32 accumulator fragments; each thread holds two
// rows (g and g + 8 of its warp's 16) and reduces their max over the 4
// threads of its quad with shuffles; m and the O accumulator are fp32 in
// registers, l is summed per thread and reduced once at the end.  P is
// rounded to bf16 in registers and used directly as the A operand of P.V:
// the m16n8 accumulator layout of two adjacent score tiles is the m16n8k16
// A layout, so P never goes through shared memory.
//
// Masks (flash_common.cuh).  A warp skips a kv tile with no valid pair
// for its 16 rows and evaluates the mask only on a tile that crosses the
// causal diagonal, the window edge or Sk; ragged S and Sk are masked,
// never padded.  Causal q-blocks are launched heaviest first: blockIdx.y
// walks the q-blocks from the last, with (batch, head) on blockIdx.x.
//
// What bounds it.  Operations: 4 hd FLOPs per valid pair on the bf16
// tensor cores.  Every warp reads the whole K and V tile from shared
// memory through ldmatrix for its own 16 rows, 256 bytes per m16n8k16
// product, about two cycles of the SM's shared-memory bandwidth per
// product; that, with mma.sync's own rate, holds it well below the
// tensor-core peak.  Next levers: 32 rows per warp (each B fragment feeds
// two products), then wgmma from shared memory with TMA loads and a
// producer warp (warp specialisation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "per_device.cuh"

// Internal linkage, as every kernel source here: a template's function-local
// static (launch's `configured`) would otherwise be one object shared by
// every loaded library that defines the same template.
namespace {
namespace flash_bf16 {

namespace fc = flash_common;

template <int HD>
struct Cfg {
  static constexpr int NW = HD <= 64 ? 8 : 4;  // warps per block
  static constexpr int THREADS = 32 * NW;
  static constexpr int BQ = 16 * NW;           // query rows per block
  static constexpr int BK = HD <= 128 ? 64 : 32;  // keys per kv tile
  // Q fragments held in registers for the kv loop (else reloaded from
  // shared memory at each k-step).
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr int LD = HD + 8;            // smem row stride (bf16)
  static constexpr int CHUNKS = HD / 8;        // 16-byte chunks per row
  // Q, then two stages of a K and a V tile.
  static constexpr int SMEM = (BQ + 4 * BK) * LD * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 2)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S, int Sk, int H,
                            int KV, int causal, int window, float x_scale,
                            float cap_out) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, CH = C::CHUNKS;
  constexpr int NT = BK / 8;    // score n-tiles of a kv tile
  constexpr int KS = HD / 16;   // k-steps of Q.K^T
  constexpr int DT = HD / 8;    // output n-tiles
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;               // [BQ][LD]
  __nv_bfloat16* KVs = Qs + BQ * LD;      // [stage][K, V][BK][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = fc::block_q0(BQ);
  const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  const fc::Tiles tiles = fc::kv_tiles<BQ, BK>(q0, S, Sk, causal, window);
  const int t_begin = tiles.begin, t_end = tiles.end;

  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* Ks = KVs + stage * 2 * BK * LD;
    __nv_bfloat16* Vs = Ks + BK * LD;
    for (int e = tid; e < BK * CH; e += C::THREADS) {
      const int r = e / CH, c = e % CH;
      const int kp = t * BK + r;
      const bool in = kp < Sk;
      const size_t off = in ? (size_t)kp * k_row + c * 8 : 0;
      cp_async16(smem_addr(Ks + r * LD + c * 8), kb + off, in);
      cp_async16(smem_addr(Vs + r * LD + c * 8), vb + off, in);
    }
  };

  for (int e = tid; e < BQ * CH; e += C::THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = q0 + r < S;
    const size_t off = in ? (size_t)(q0 + r) * q_row + c * 8 : 0;
    cp_async16(smem_addr(Qs + r * LD + c * 8), qb + off, in);
  }
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // This warp's Q fragments: a0..a3 of each 16-wide k-step, loaded here
  // once (Q_IN_REGS) or at each use.
  const int w_first = q0 + warp * 16;
  uint32_t qf[C::Q_IN_REGS ? KS : 1][4];
  if constexpr (C::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int r = warp * 16 + lane % 8 + ((lane / 8) % 2) * 8;
      ldsm_x4(qf[kk], smem_addr(Qs + r * LD + kk * 16 + (lane / 16) * 8));
    }
  }

  const int row0 = w_first + g, row1 = row0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    // Tile t has landed (this thread's copies, then everyone's), and every
    // warp is done with tile t - 1, whose stage tile t + 1 now takes.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < t_end) load_tile(t + 1, stage ^ 1);
    cp_async_commit();

    const int k0 = t * BK;
    if (fc::warp_skips<BK>(k0, w_first, S, causal, window))
      continue;   // no valid pair for this warp's rows
    const bool masked = fc::tile_masked<BK>(k0, w_first, Sk, causal, window);
    const __nv_bfloat16* Ks = KVs + stage * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;

    // S = Q.K^T: an ldmatrix.x4 of K gives b0, b1 of two key n-tiles.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int qi = C::Q_IN_REGS ? kk : 0;
      if constexpr (!C::Q_IN_REGS) {
        const int r = warp * 16 + lane % 8 + ((lane / 8) % 2) * 8;
        ldsm_x4(qf[0], smem_addr(Qs + r * LD + kk * 16 + (lane / 16) * 8));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        const int r = j * 8 + lane % 8 + (lane / 16) * 8;
        ldsm_x4(bf, smem_addr(Ks + r * LD + kk * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[j], qf[qi], bf[0], bf[1]);
        mma_bf16(s[j + 1], qf[qi], bf[2], bf[3]);
      }
    }

    // Scale (and softcap) into base-2 units, the mask, the online softmax.
    fc::softmax_tile(s, acc, m0, m1, l0, l1, x_scale, cap_out, masked, k0,
                     row0, Sk, causal, window);

    // O += P.V: P from registers (bf16), V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int r = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_addr(Vs + r * LD + d * 8 + (lane / 16) * 8));
        mma_bf16(acc[d], pa, bf[0], bf[1]);
        mma_bf16(acc[d + 1], pa, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait_all();

  if constexpr (LSE) {
    float* lse_bh = lse + (size_t)blockIdx.x * S;
    fc::store_lse(lse_bh, row0, S, m0, l0);
    fc::store_lse(lse_bh, row1, S, m1, l1);
  }
  const float inv0 = fc::row_inv(l0), inv1 = fc::row_inv(l1);
  __nv_bfloat16* ob = o + ((size_t)b * S * H + h) * HD + 2 * t4;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * q_row + d * 8) =
          __floats2bfloat162_rn(acc[d][0] * inv0, acc[d][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * q_row + d * 8) =
          __floats2bfloat162_rn(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Sk, int H, int KV, int causal, int window,
           float cap, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_attention_bf16_kernel<HD, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_attention_bf16_kernel<HD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  fc::Launch lp;
  if (!fc::make_launch(B, H, S, C::BQ, HD, cap, lp))
    return static_cast<int>(cudaErrorInvalidValue);
  // The instance that writes lse is its own, so the serving instances
  // compile as they did before it existed.
  auto kernel = lse != nullptr ? flash_attention_bf16_kernel<HD, true>
                                : flash_attention_bf16_kernel<HD, false>;
  kernel<<<lp.grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      S, Sk, H, KV, causal, window, lp.x_scale, lp.cap_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_bf16
}  // namespace
