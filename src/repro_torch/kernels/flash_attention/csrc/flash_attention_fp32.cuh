// Flash attention (forward), fp32, on the tensor cores of sm_90a: the
// bf16 kernel's shape (flash_attention_bf16.cuh) with both products as
// 3xTF32 mma.sync.m16n8k8.  Included by flash_attention.cu, whose C entry
// sends fp32 inputs here.  The block layout, the tile ranges, the mask and
// the softmax are flash_common.cuh's, shared with the bf16 kernel.
//
// Replaces the fp32 path of the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas and
// computes what its body _flash_kernel computes, with these rounding
// points: S = Q.K^T and O += P.V each as three TF32 products per fp32
// product (kernels/csrc/sgemm_3xtf32.cuh's split_tf32 and mma_tf32: each
// operand split into hi + lo, per k8 step lo.hi, hi.lo, then hi.hi into an
// fp32 accumulator); the scale, the softcap and the online softmax in base
// 2 as in the bf16 kernel (flash_common.cuh), p kept in fp32; P.V summed
// JC = 2 k8 steps (16 keys) at a time into a zeroed fragment, which is
// then added to O in fp32; out = O / max(l, 1e-37).
// scripts/flash_fp32_replay.py replays these steps on the CPU (at most
// 0.07 of the gates; plain TF32, or a dropped correction term, fails
// them).
//
// Why the partial sums.  mma.sync does not round its fp32 sums to
// nearest: summed straight into O over a long row (3 mma.sync a k8 step,
// 3,072 of them for 8,192 keys) the error grows with the keys, to 7e-5 of
// a row's norm at Gemma2's S 8192 against the 1e-4 gate, where 16-key
// partials keep it at 1e-5 (scripts/flash_fp32_variants.py, "one
// accumulator"), for about 5 % of the time.
//
// Blocks and warps.  One block owns BQ = 128 query rows of one (batch,
// head): 4 warps of 32 rows, two m16 tiles (MT) each, so every K and V
// value a warp loads and splits feeds the products of both.  At hd 256
// two m-tiles' O would be 256 registers a thread: there 8 warps of one
// m16 tile each (128 O registers), one block an SM (Cfg<256>::WIDE).  Query head h
// reads KV head h / (H / KV) in place.  The Q tile is staged in shared
// memory once and each warp reads and splits its Q fragments there at
// each use: held in registers as hi and lo they would take MT hd
// registers beside MT (BK / 2) of S and MT (hd / 2) of O, and spill.
//
// K and V tiles of BK keys (32 at hd <= 64, 16 above) are copied from
// (B, Sk, KV, hd) into shared memory as fp32 by cp.async (16 bytes a
// thread, zero-filled past Sk) in a 2-stage ring, one barrier a tile, as
// in the bf16 kernel.  Rows are hd + 4 floats apart, which is 4 (mod 32)
// at hd 32, 64, 128 and 256 (20 at hd 16 and 80), so the fragment loads
// below fall on 32 distinct banks: Q's and K's (row g, dim t4), V's (key
// 2 t4, dim g).  Shared memory: (BQ + 4 BK) (hd + 4) floats, 69,632 bytes
// at hd 64, 64,512 at hd 80, 101,376 at hd 128 and 199,680 at hd 256;
// two blocks an SM below hd 256 (up to 255 registers a thread: at
// three, 168, ptxas spills).  Each warp splits the values it loads (5
// integer and float instructions a value); a split at staging, once for
// the block into hi and lo planes, doubles the K/V shared memory and
// cannot use cp.async (scripts/flash_fp32_variants.py times it, Q in
// registers, 16 rows a warp and a truncating split).
//
// P stays in registers.  The S accumulator of keys 8j .. 8j + 7 holds, in
// thread (g, t4), keys 2 t4 and 2 t4 + 1 of rows g and g + 8; the m16n8k8
// TF32 A fragment wants columns t4 and t4 + 4.  The sum over a k8 step
// does not depend on the order of its keys, so P.V takes them in the
// order 0, 2, 4, 6, 1, 3, 5, 7: A column c is key 2c (c < 4) or
// 2 (c - 4) + 1, the A fragment is (s0, s2, s1, s3), and V's B fragment
// reads keys 2 t4 and 2 t4 + 1.
//
// What bounds it.  Operations: 4 hd FLOPs per valid pair, three TF32
// products each, 3 x 4 hd over the 495 TFLOP/s TF32 peak.  Per 32 rows
// and 32 keys at hd 64 a warp issues 384 mma.sync and splits 224 values
// (Q, K, V and P), about 900 integer instructions at half the FP32 rate,
// so the splits compete with the tensor cores: a split that truncates
// hi and leaves lo to the tensor core (1 integer instruction a value,
// not 4) times 5-13 % faster, outside split_tf32's rounding.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "per_device.cuh"
#include "sgemm_3xtf32.cuh"

namespace {
namespace flash_fp32 {

namespace fc = flash_common;
namespace tc = sgemm_tc;

template <int HD>
struct Cfg {
  static constexpr bool WIDE = HD > 128;          // O of 2 m-tiles spills
  static constexpr int NW = WIDE ? 8 : 4;         // warps per block
  static constexpr int MT = WIDE ? 1 : 2;         // m16 tiles a warp
  static constexpr int THREADS = 32 * NW;
  static constexpr int BQ = 16 * MT * NW;         // query rows per block
  static constexpr int BK = HD <= 64 ? 32 : 16;   // keys per kv tile
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;  // resident blocks an SM
  static constexpr int JC = 2;                    // k8 steps a P.V partial
  static constexpr int LD = HD + 4;               // smem row stride, floats
  static constexpr int CHUNKS = HD / 4;           // 16-byte chunks per row
  // Q, then two stages of a K and a V tile.
  static constexpr int SMEM = (BQ + 4 * BK) * LD * 4;
};

// The hi and lo TF32 halves of a B fragment: (row 0, row `stride` on).
__device__ __forceinline__ void b_frag(const float* p, int stride,
                                       uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  tc::split_tf32(p[0], bh[0], bl[0]);
  tc::split_tf32(p[stride], bh[1], bl[1]);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::MIN_BLOCKS)
flash_attention_fp32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int S, int Sk, int H,
                            int KV, int causal, int window, float x_scale,
                            float cap_out) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, CH = C::CHUNKS;
  constexpr int MT = C::MT, JC = C::JC;
  constexpr int NT = BK / 8;    // score n-tiles (and k8 steps of P.V)
  constexpr int KS = HD / 8;    // k8 steps of Q.K^T
  constexpr int DT = HD / 8;    // output n-tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][LD]
  float* KVs = Qs + BQ * LD;      // [stage][K, V][BK][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = fc::block_q0(BQ);
  const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  const fc::Tiles tiles = fc::kv_tiles<BQ, BK>(q0, S, Sk, causal, window);

  auto load_tile = [&](int t, int stage) {
    float* Ks = KVs + stage * 2 * BK * LD;
    float* Vs = Ks + BK * LD;
    for (int e = tid; e < BK * CH; e += C::THREADS) {
      const int r = e / CH, c = e % CH;
      const int kp = t * BK + r;
      const bool in = kp < Sk;
      const size_t off = in ? (size_t)kp * k_row + c * 4 : 0;
      tc::cp_async16(Ks + r * LD + c * 4, kb + off, in);
      tc::cp_async16(Vs + r * LD + c * 4, vb + off, in);
    }
  };

  for (int e = tid; e < BQ * CH; e += C::THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = q0 + r < S;
    const size_t off = in ? (size_t)(q0 + r) * q_row + c * 4 : 0;
    tc::cp_async16(Qs + r * LD + c * 4, qb + off, in);
  }
  if (tiles.begin < tiles.end) load_tile(tiles.begin, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // This warp's rows: MT m-tiles of 16 from w_first.  Its Q fragments
  // are read from shared memory at each use, (g, 8kk + t4), (g + 8, ...),
  // (g, 8kk + t4 + 4), (g + 8, ...) of each m-tile, and split there.
  const int w_first = q0 + warp * 16 * MT;
  const float* qw = Qs + (warp * 16 * MT + g) * LD + t4;
  float m[MT][2], l[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.f;
  }

  for (int t = tiles.begin; t < tiles.end; ++t) {
    const int stage = (t - tiles.begin) & 1;
    // Tile t has landed (this thread's copies, then everyone's), and every
    // warp is done with tile t - 1, whose stage tile t + 1 now takes.
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles.end) load_tile(t + 1, stage ^ 1);
    tc::cp_async_commit();

    // An m-tile with no valid pair here is computed with the mask on (all
    // its scores -inf: m, l and acc stay as they are) unless every one is.
    const int k0 = t * BK;
    bool skip[MT], all_skip = true;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      skip[mt] = fc::warp_skips<BK>(k0, w_first + 16 * mt, S, causal, window);
      all_skip = all_skip && skip[mt];
    }
    if (all_skip) continue;   // no valid pair for this warp's rows
    const float* Ks = KVs + stage * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;

    // S = Q.K^T: K's B fragment of n-tile j is (key 8j + g, dims t4 and
    // t4 + 4 of the k8 step), split once for the warp's MT m-tiles.
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tc::split_tf32(qw[(16 * mt + (e & 1) * 8) * LD + kk * 8 + (e >> 1) * 4],
                         ah[mt][e], al[mt][e]);
      const float* kp = Ks + g * LD + kk * 8 + t4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        b_frag(kp + j * 8 * LD, 4, bh, bl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::mma_3xtf32(s[mt][j], ah[mt], al[mt], bh, bl);
      }
    }

    // Scale (and softcap) into base-2 units, the mask, the online softmax.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int first = w_first + 16 * mt;
      const bool masked =
          skip[mt] || fc::tile_masked<BK>(k0, first, Sk, causal, window);
      fc::softmax_tile(s[mt], acc[mt], m[mt][0], m[mt][1], l[mt][0], l[mt][1],
                       x_scale, cap_out, masked, k0, first + g, Sk, causal,
                       window);
    }

    // O += P.V: P from registers, its keys in the order 0, 2, 4, 6, 1, 3,
    // 5, 7 of each k8 step; V's B fragment (keys 2 t4 and 2 t4 + 1, dim
    // 8d + g), split once for the MT m-tiles.  The products of JC k8
    // steps go into a zeroed fragment that is then added to O in fp32.
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += JC) {
      uint32_t ah[JC][MT][4], al[JC][MT][4];
#pragma unroll
      for (int jc = 0; jc < JC; ++jc)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float(&p)[4] = s[mt][j0 + jc];
          tc::split_tf32(p[0], ah[jc][mt][0], al[jc][mt][0]);
          tc::split_tf32(p[2], ah[jc][mt][1], al[jc][mt][1]);
          tc::split_tf32(p[1], ah[jc][mt][2], al[jc][mt][2]);
          tc::split_tf32(p[3], ah[jc][mt][3], al[jc][mt][3]);
        }
      const float* vp = Vs + (j0 * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        float part[MT][4] = {};
#pragma unroll
        for (int jc = 0; jc < JC; ++jc) {
          uint32_t bh[2], bl[2];
          b_frag(vp + jc * 8 * LD + d * 8, LD, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tc::mma_3xtf32(part[mt], ah[jc][mt], al[jc][mt], bh, bl);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][d][e] += part[mt][e];
      }
    }
  }
  tc::cp_async_wait<0>();

  float* ob = o + ((size_t)b * S * H + h) * HD + 2 * t4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = w_first + 16 * mt + g, row1 = row0 + 8;
    if constexpr (LSE) {
      float* lse_bh = lse + (size_t)blockIdx.x * S;
      fc::store_lse(lse_bh, row0, S, m[mt][0], l[mt][0]);
      fc::store_lse(lse_bh, row1, S, m[mt][1], l[mt][1]);
    }
    const float inv0 = fc::row_inv(l[mt][0]), inv1 = fc::row_inv(l[mt][1]);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (row0 < S)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * q_row + d * 8) =
            make_float2(acc[mt][d][0] * inv0, acc[mt][d][1] * inv0);
      if (row1 < S)
        *reinterpret_cast<float2*>(ob + (size_t)row1 * q_row + d * 8) =
            make_float2(acc[mt][d][2] * inv1, acc[mt][d][3] * inv1);
    }
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
    err = cudaFuncSetAttribute(flash_attention_fp32_kernel<HD, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_attention_fp32_kernel<HD, true>,
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
  auto kernel = lse != nullptr ? flash_attention_fp32_kernel<HD, true>
                                : flash_attention_fp32_kernel<HD, false>;
  kernel<<<lp.grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Sk, H, KV,
      causal, window, lp.x_scale, lp.cap_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_fp32
}  // namespace
