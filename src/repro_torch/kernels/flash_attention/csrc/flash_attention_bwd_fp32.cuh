// Flash attention (backward), fp32, on the CUDA cores of sm_90a: the
// backward's fp32 instance.  Included by flash_attention_bwd.cu, whose C
// entry sends fp32 inputs here and bf16 inputs to
// flash_attention_bwd_bf16.cuh; the entry's note says what both compute.
// The tiles' ranges, the mask and the softcap's factor are
// flash_common.cuh's.
//
// Two kernels after the entry's row-dot launch, no atomics:
//   flash_bwd_dkdv_kernel: one block a (batch, KV head, BK keys); it keeps
//     dk and dv of its keys in registers and loops over the G query heads
//     and over the query tiles of BQ rows that hold a valid pair for one
//     of its keys, recomputing p and ds for each;
//   flash_bwd_dq_kernel: one block a (batch, head, BQ query rows),
//     q-blocks from the last (the heaviest under a causal mask first, as
//     the forward); it keeps dq in registers and loops over the key tiles
//     of its rows (flash_common.cuh's kv_tiles), recomputing p and ds.
// Each tile of q, dO, k and v is copied into shared memory (rows hd + 1
// floats apart), and every product runs in fp32 on the CUDA cores: 256
// threads a block as a 16 x 16 grid, thread (ty, tx) holding the rows
// ty + 16 i and the columns (keys or dims) tx + 16 j of its block's
// tiles, so that a warp reads 16 consecutive columns (distinct banks) and
// two rows (broadcast).  p and ds of a tile go through shared memory
// between the products.  dk, dv and dq are written once.
//
// Tiles.  BQ = BK = 64 up to hd 128, 32 at hd 256, where a thread's dk and
// dv of 64 keys would take 128 accumulator registers: with 32 keys they
// take 64 (dq likewise).  Dynamic shared memory (Cfg::SMEM): q, dO, k and
// v tiles, p and ds, lse and D: 100,352 bytes at hd 64 (two blocks an SM),
// 116,736 at hd 80, 165,888 at hd 128 and 140,288 at hd 256 (one), above
// 48 KB, so the entry's launch sets it up per device (per_device.cuh).
//
// What bounds it.  Five products of 2 hd FLOPs per valid (row, key) pair
// and head, seven as run (the dq kernel recomputes s and dp), on the fp32
// CUDA cores; each inner step reads two shared-memory words per two FMAs,
// so shared memory holds it near half of the fp32 CUDA-core peak at best.
// Next: the products as 3xTF32 on mma.sync (sgemm_3xtf32.cuh), as the
// fp32 forward runs them.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "flash_common.cuh"

// Internal linkage, as every kernel source here.
namespace {
namespace flash_bwd_fp32 {

namespace fc = flash_common;

constexpr int THREADS = 256;  // a 16 x 16 grid of threads

template <int HD>
struct Cfg {
  static constexpr int BQ = HD <= 128 ? 64 : 32;  // query rows a tile
  static constexpr int BK = HD <= 128 ? 64 : 32;  // keys a tile
  static constexpr int LD = HD + 1;   // row stride of q, dO, k, v (floats)
  static constexpr int LP = BK + 1;   // row stride of p and ds
  // Resident blocks an SM: two fit in shared memory up to hd 64 (at most
  // 128 registers a thread), one above.
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
  // q and dO tiles, k and v tiles, p and ds, lse and D.
  static constexpr int SMEM =
      ((2 * BQ + 2 * BK) * LD + 2 * BQ * LP + 2 * BQ) * 4;
};

// rows [r0, r0 + ROWS) of head `head` of a (B, n, heads, HD) tensor of
// batch b into dst[ROWS][LD] as fp32, zero past n.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int b,
                                          int n, int heads, int head,
                                          int r0) {
  constexpr int LD = HD + 1;
  const float* base = src + ((size_t)b * n * heads + head) * HD;
  for (int e = threadIdx.x; e < ROWS * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * LD + c] =
        r0 + r < n ? base[(size_t)(r0 + r) * heads * HD + c] : 0.f;
  }
}

// lse and D of rows [q0, q0 + BQ) of one (batch, head), 0 past S (those
// rows are masked).
template <int BQ>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* d_s,
                                               const float* lse,
                                               const float* D, size_t bh,
                                               int q0, int S) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[bh * S + q0 + r] : 0.f;
    d_s[r] = in ? D[bh * S + q0 + r] : 0.f;
  }
}

// p and ds of the (query tile from q0) x (key tile from k0) pair into
// Ps[BQ][LP] and dSs[BQ][LP], from the tiles in shared memory: thread
// (ty, tx) computes rows ty + 16 i and keys tx + 16 j.
template <int HD>
__device__ __forceinline__ void p_and_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* d_s, float* Ps, float* dSs, int q0,
    int k0, int S, int Sk, int causal, int window, const fc::BwdScale& sc) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, LP = C::LP;
  constexpr int RI = C::BQ / 16, CJ = C::BK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RI][CJ], dp[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[RI], oa[RI], kb[CJ], vb[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qa[i] = Qs[(ty + 16 * i) * LD + d];
      oa[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kb[j] = Ks[(tx + 16 * j) * LD + d];
      vb[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j, kp = k0 + c;
      const bool valid = qp < S && kp < Sk && (!causal || kp <= qp) &&
                         (window <= 0 || kp > qp - window);
      float dfac;
      const float x = fc::bwd_x(s[i][j], sc, dfac);
      const float p = valid ? fc::fast_exp2(x - lse_s[r]) : 0.f;
      Ps[r * LP + c] = p;
      dSs[r * LP + c] = p * (dp[i][j] - d_s[r]) * dfac;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::MIN_BLOCKS)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int Sk, int H, int KV,
                      int causal, int window, fc::BwdScale sc) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  constexpr int KI = BK / 16, DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* dOs = Qs + BQ * LD;        // [BQ][LD]
  float* Ks = dOs + BQ * LD;        // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ps = Vs + BK * LD;         // [BQ][LP]
  float* dSs = Ps + BQ * LP;        // [BQ][LP]
  float* lse_s = dSs + BQ * LP;     // [BQ]
  float* d_s = lse_s + BQ;          // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * BK;
  load_rows<HD, BK>(Ks, k, b, Sk, KV, kvh, k0);
  load_rows<HD, BK>(Vs, v, b, Sk, KV, kvh, k0);

  // The query rows that hold a valid pair for one of keys [k0, k0 + BK):
  // at or after k0 (causal), before k0 + BK - 1 + window (window).
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;

  float dk_acc[KI][DJ], dv_acc[KI][DJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const size_t bh = (size_t)b * H + h;
    for (int q0 = q_begin / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();   // every thread is done with the last tile's q, dO, p, ds
      load_rows<HD, BQ>(Qs, q, b, S, H, h, q0);
      load_rows<HD, BQ>(dOs, dO, b, S, H, h, q0);
      load_row_stats<BQ>(lse_s, d_s, lse, D, bh, q0, S);
      __syncthreads();
      p_and_ds<HD>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, q0, k0, S, Sk,
                   causal, window, sc);
      __syncthreads();
      // dv += p^T dO and dk += ds^T q over the tile's rows.
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pk[KI], dsk[KI], od[DJ], qd[DJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pk[i] = Ps[r * LP + ty + 16 * i];
          dsk[i] = dSs[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          od[j] = dOs[r * LD + tx + 16 * j];
          qd[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(pk[i], od[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsk[i], qd[j], dk_acc[i][j]);
          }
      }
    }
  }

  const size_t k_row = (size_t)KV * HD;
  float* dkb = dk + ((size_t)b * Sk * KV + kvh) * HD;
  float* dvb = dv + ((size_t)b * Sk * KV + kvh) * HD;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(size_t)kp * k_row + tx + 16 * j] = dk_acc[i][j];
      dvb[(size_t)kp * k_row + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::MIN_BLOCKS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq, int S,
                    int Sk, int H, int KV, int causal, int window,
                    fc::BwdScale sc) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  constexpr int RI = BQ / 16, DJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* dSs = Ps + BQ * LP;
  float* lse_s = dSs + BQ * LP;
  float* d_s = lse_s + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = fc::block_q0(BQ);
  load_rows<HD, BQ>(Qs, q, b, S, H, h, q0);
  load_rows<HD, BQ>(dOs, dO, b, S, H, h, q0);
  load_row_stats<BQ>(lse_s, d_s, lse, D, (size_t)b * H + h, q0, S);

  float dq_acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;

  const fc::Tiles tiles = fc::kv_tiles<BQ, BK>(q0, S, Sk, causal, window);
  for (int t = tiles.begin; t < tiles.end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // q and dO have landed; the last tile's k and ds are read
    load_rows<HD, BK>(Ks, k, b, Sk, KV, kvh, k0);
    load_rows<HD, BK>(Vs, v, b, Sk, KV, kvh, k0);
    __syncthreads();
    p_and_ds<HD>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, q0, k0, S, Sk, causal,
                 window, sc);
    __syncthreads();
    // dq += ds k over the tile's keys.
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float dsr[RI], kd[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsr[i] = dSs[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kd[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          dq_acc[i][j] = fmaf(dsr[i], kd[j], dq_acc[i][j]);
    }
  }

  const size_t q_row = (size_t)H * HD;
  float* dqb = dq + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(size_t)qp * q_row + tx + 16 * j] = dq_acc[i][j];
  }
}

}  // namespace flash_bwd_fp32
}  // namespace
