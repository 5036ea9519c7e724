// Flash attention (backward), fp32, on the tensor cores of sm_90a: the
// bf16 body's shape (flash_attention_bwd_bf16.cuh) with every product as
// three TF32 products per fp32 product (3xTF32) on mma.sync.m16n8k8, as
// the fp32 forward runs its two (flash_attention_fp32.cuh).  Included by
// flash_attention_bwd.cu, whose C entry sends fp32 inputs here and bf16
// inputs to flash_attention_bwd_bf16.cuh; the entry's note says what both
// compute.  The tiles' ranges, the mask and the softcap's factor are
// flash_common.cuh's.
//
// Arithmetic.  s = q.k, dp = dO.v, dv += p^T dO, dk += ds^T q and dq +=
// ds k each split every operand into hi + lo (sgemm_3xtf32.cuh's
// split_tf32, rounded as cvt.rna) and issue lo.hi, hi.lo, then hi.hi per
// k8 step into an fp32 accumulator.  p and ds are fp32 in the
// accumulators.  mma.sync does not round its fp32 sums to nearest, so no
// sum runs long on the tensor cores: the products of one tile (JQ k8
// steps of query rows in the dk/dv kernel, JK of keys in the dq kernel)
// go into a zeroed fragment that is then added to dv, dk or dq in fp32,
// as the forward sums P.V, and s and dp go over the head dim in partials
// of JD_DKDV (JD_DQ) k8 steps.  Summed straight into dv and dk, Llama's
// 16,384 query rows a key leave rows 1.8e-4 from the plain version
// against the 1e-4 gate; dq's s and dp take one k8 step a partial because
// the causal first row's dq cancels to ~0 there (one key, p = 1), and
// four-step partials put it 1.45e-4 from the plain version at Gemma2's
// S 8192 (scripts/flash_bwd_variants.py's "one accumulator" and "dq s/dp
// 4 k8 steps").  scripts/flash_bwd_replay.py --fp32 replays these steps.
//
// dk/dv kernel (flash_bwd_dkdv_kernel).  One block a (batch, KV head, BK
// keys) and, where the entry splits the G query heads of the KV head into
// groups, a group (blockIdx.z).  4 warps; each owns 16 keys as the m16
// rows (at hd 256, DSPLIT = 2 warps share 16 keys, each holding half of
// the head dim of dk and dv: 16 keys' dk and dv of 256 dims would be 256
// registers a thread).  K and V of the block's keys land once in shared
// memory; the block loops over the (head, query tile) pairs of its group
// (query tiles of BQ_T rows that hold a valid pair for one of its keys),
// with q, dO, lse and D of the next pair in flight (cp.async) while the
// present one is computed.  A warp computes S^T = K Q^T and dP^T = V dO^T,
// so p^T and ds^T come out in the m16n8 accumulator layout, keys on the
// rows: thread (g, t4) holds query rows 2 t4 and 2 t4 + 1 of each n8
// tile, where the m16n8k8 A fragment wants columns t4 and t4 + 4.  A k8
// step's sum does not depend on the order of its rows, so dV += P^T dO and
// dK += dS^T Q take each step's query rows in the order 0, 2, 4, 6, 1, 3,
// 5, 7: the A fragment is (c0, c2, c1, c3) of the accumulator, and dO's
// and q's B fragments read rows 2 t4 and 2 t4 + 1 (the forward's P.V
// trick, queries in place of keys).  p and ds never leave the registers.
// Each group writes its fp32 partial dk and dv to the entry's workspace and
// the entry's reduce launch (flash_bwd_reduce_kernel) sums the groups in
// group order; with one group the block stores dk and dv itself.
//
// dq kernel (flash_bwd_dq_kernel).  One block a (batch, query head, BQ =
// 64 rows), 4 warps of 16 rows as the m16 rows, q-blocks from the last
// (flash_common.cuh's block_q0).  q and dO stay in shared memory and each
// warp splits its A fragments there at each use (held split they would
// take 2 hd registers); K and V tiles of BK_T keys over kv_tiles are
// double-buffered by cp.async, one barrier a tile.  S = Q K^T and dP =
// dO V^T; dS from the accumulator is the A fragment of dQ += dS K by the
// same permutation, K's B fragment reading keys 2 t4 and 2 t4 + 1.  It
// recomputes s and dp, so the pair does seven products for the five the
// bound counts: that buys a dq without atomics, so the result is
// deterministic.
//
// Shared memory, rows hd + 4 floats apart (4 mod 32 at hd 32, 64, 128 and
// 256, 20 at hd 16 and 80), so that every fragment load of a warp, (row
// g, column t4) and (row 2 t4, column g), falls on 32 distinct banks.
// dk/dv: K and V [BK], two stages of q and dO [BQ_T] and of lse and D:
// 105,472 bytes at hd 64, 86,528 at hd 80, 101,632 at hd 128 (two blocks
// an SM) and 200,192 at hd 256 (one).  dq: q and dO [64], two stages of K
// and V [BK_T]: 69,632 bytes at hd 64 (three blocks an SM), 86,016 at hd
// 80 and 101,376 at hd 128 (two), 199,680 at hd 256 (one).  Above 48 KB,
// so the entry's launch sets it up per device (per_device.cuh).
//
// Registers (fp32 values a thread).  dk/dv: dk and dv of 16 keys take DW
// (64 at hd 64, 128 at hd 128 and, with DSPLIT, at hd 256); s and dp of a
// tile BQ_T, their partials and their hi and lo parts as A fragments BQ_T
// more each; the query tile shrinks where dk and dv grow (BQ_T 64 at hd
// <= 64, 32 at hd 80 and 256, 16 at hd 128).  dq: hd / 2 for dq, BK_T for
// s and dp.  ptxas gives dk/dv 255 registers at hd 64 and 256 and 254 at
// hd 128 (8 bytes spilled), dq 161 at hd 64 (three blocks an SM), 175-194
// at hd 80-128 and 255 at hd 256 (4 bytes spilled); chip_smoke.py prints
// them.
//
// What bounds it.  Operations: five products of 2 hd FLOPs per valid pair
// and head, three TF32 products each, over the 495 TFLOP/s TF32 peak.
// Each fragment value a warp loads is split where it is used (5 integer
// and float instructions), and every warp of a block splits the same
// q and dO (dk/dv) or K and V (dq) values: about 6.8 instructions a
// mma.sync in dk/dv at hd 64, so instruction issue at 8 warps an SM, not
// the tensor cores, holds it near a fifth of the bound (PERF.md); the dq
// kernel's two extra products add 40 % to the work.  Next (ROADMAP lever
// B1.5): q and dO (K and V) split once a tile into hi and lo planes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "sgemm_3xtf32.cuh"

// Internal linkage, as every kernel source here.
namespace {
namespace flash_bwd_fp32 {

namespace fc = flash_common;
namespace tc = sgemm_tc;

template <int HD>
struct Cfg {
  static constexpr int NW = 4;                 // warps a block, both kernels
  static constexpr int THREADS = 32 * NW;
  static constexpr int LD = HD + 4;            // smem row stride (floats)
  static constexpr int KS = HD / 8;            // k8 steps over the head dim
  // dk/dv kernel: warps sharing 16 keys, the dk/dv columns of a warp, keys
  // a block, query rows a tile, k8 steps of a dv/dk partial, resident
  // blocks an SM.
  static constexpr int DSPLIT = HD == 256 ? 2 : 1;
  static constexpr int DW = HD / DSPLIT;
  static constexpr int BK = 16 * NW / DSPLIT;
  static constexpr int BQ_T = HD <= 64 ? 64 : HD == 128 ? 16 : 32;
  static constexpr int JQ = BQ_T / 8;
  static constexpr int JD_DKDV = HD % 32 == 0 ? 4 : 2;  // an s/dp partial
  static constexpr int DKDV_BLOCKS = HD == 256 ? 1 : 2;
  // K and V, two stages of q and dO, two of lse and D.
  static constexpr int SMEM_DKDV = ((2 * BK + 4 * BQ_T) * LD + 4 * BQ_T) * 4;
  // dq kernel: rows a block, keys a tile, k8 steps of a dq partial,
  // resident blocks an SM.
  static constexpr int BQ = 16 * NW;
  static constexpr int BK_T = HD <= 80 ? 32 : 16;
  static constexpr int JK = BK_T / 8;
  static constexpr int JD_DQ = 1;   // k8 steps an s/dp partial
  static constexpr int DQ_BLOCKS = HD <= 64 ? 3 : HD <= 128 ? 2 : 1;
  // q and dO, two stages of K and V.
  static constexpr int SMEM_DQ = (2 * BQ + 4 * BK_T) * LD * 4;
  static_assert(BK == 16 * NW / DSPLIT, "a warp owns 16 keys");
  static_assert(2 * BQ_T <= THREADS, "a thread loads one of lse and D");
  static_assert(KS % JD_DKDV == 0 && KS % JD_DQ == 0, "whole partials");
};

// rows [r0, r0 + ROWS) of a (., n, heads, HD) fp32 tensor from src (its
// head's first row, rows row_stride apart) into dst[ROWS][HD + 4] by
// cp.async, 16 bytes a thread, zero-filled past n.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n,
                                          size_t row_stride, int r0) {
  constexpr int CH = HD / 4, LD = HD + 4;
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = r0 + r < n;
    tc::cp_async16(dst + r * LD + c * 4,
                   src + (in ? (size_t)(r0 + r) * row_stride + c * 4 : 0), in);
  }
}

// The A fragment (16 x 8) of a [row][LD] array, split: p is the element
// (row g, column t4) of the fragment; the others are rows + 8, columns + 4.
template <int LD>
__device__ __forceinline__ void a_frag(const float* p, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  tc::split_tf32(p[0], ah[0], al[0]);
  tc::split_tf32(p[8 * LD], ah[1], al[1]);
  tc::split_tf32(p[4], ah[2], al[2]);
  tc::split_tf32(p[8 * LD + 4], ah[3], al[3]);
}

// The B fragment (8 x 8), split: p[0] and p[stride].
__device__ __forceinline__ void b_frag(const float* p, int stride,
                                       uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  tc::split_tf32(p[0], bh[0], bl[0]);
  tc::split_tf32(p[stride], bh[1], bl[1]);
}

// An m16n8 accumulator as the A fragment of a k8 step whose k runs over
// its 8 columns in the order 0, 2, 4, 6, 1, 3, 5, 7: (c0, c2, c1, c3).
__device__ __forceinline__ void acc_frag(const float (&c)[4],
                                         uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  tc::split_tf32(c[0], ah[0], al[0]);
  tc::split_tf32(c[2], ah[1], al[1]);
  tc::split_tf32(c[1], ah[2], al[2]);
  tc::split_tf32(c[3], ah[3], al[3]);
}

// acc += part, fragment by fragment, in fp32.
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// acc[d] += A . B over the NT k8 steps of a tile, A the split accumulators
// ah/al (one k8 step each) and B rows 2 t4 and 2 t4 + 1 of each step from
// bp (columns 8 d on), in partials of J k8 steps, each summed into a zeroed
// fragment that is then added to acc in fp32.
template <int NT, int DT, int J, int LD>
__device__ __forceinline__ void acc_times_b(float (&acc)[DT][4],
                                            const uint32_t (&ah)[NT][4],
                                            const uint32_t (&al)[NT][4],
                                            const float* bp) {
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += J) {
      float part[4] = {};
#pragma unroll
      for (int j = j0; j < j0 + J; ++j) {
        uint32_t bh[2], bl[2];
        b_frag(bp + j * 8 * LD + d * 8, LD, bh, bl);
        tc::mma_3xtf32(part, ah[j], al[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] += part[e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::DKDV_BLOCKS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ ws, int S,
                      int Sk, int H, int KV, int causal, int window,
                      fc::BwdScale sc) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, BQ = C::BQ_T, LD = C::LD, KS = C::KS;
  constexpr int NT = BQ / 8, DT = C::DW / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* QOs = Vs + BK * LD;          // [stage][q, dO][BQ][LD]
  float* stats = QOs + 4 * BQ * LD;   // [stage][lse, D][BQ]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kr = warp / C::DSPLIT * 16;      // the warp's keys in the block
  const int dc = warp % C::DSPLIT * C::DW;   // its dk/dv columns
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int gs = H / KV / (int)gridDim.z;    // query heads of the group
  const int h0 = kvh * (H / KV) + blockIdx.z * gs;
  const int k0 = blockIdx.y * BK, kw = k0 + kr;
  const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
  const size_t kv_off = ((size_t)b * Sk * KV + kvh) * HD;

  copy_rows<HD, BK, C::THREADS>(Ks, k + kv_off, Sk, k_row, k0);
  copy_rows<HD, BK, C::THREADS>(Vs, v + kv_off, Sk, k_row, k0);

  // The query rows that hold a valid pair for one of keys [k0, k0 + BK):
  // at or after k0 (causal), before k0 + BK - 1 + window (window); the
  // pairs (head, query tile) of the group, it = head * nq + tile.
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  const int t_begin = q_begin / BQ;
  const int nq = max(0, (q_end + BQ - 1) / BQ - t_begin);
  const int n_it = gs * nq;

  auto load_tile = [&](int it, int stage) {
    const int h = h0 + it / nq, q0 = (t_begin + it % nq) * BQ;
    const size_t off = ((size_t)b * S * H + h) * HD;
    float* Qs = QOs + stage * 2 * BQ * LD;
    copy_rows<HD, BQ, C::THREADS>(Qs, q + off, S, q_row, q0);
    copy_rows<HD, BQ, C::THREADS>(Qs + BQ * LD, dO + off, S, q_row, q0);
  };
  // lse (tid < BQ) or D (BQ <= tid < 2 BQ) of one row of pair it, 0 past S.
  auto load_stat = [&](int it) -> float {
    const int h = h0 + it / nq, row = (t_begin + it % nq) * BQ + tid % BQ;
    const float* src = tid < BQ ? lse : D;
    return tid < 2 * BQ && row < S ? src[((size_t)b * H + h) * S + row] : 0.f;
  };

  if (n_it > 0) {
    load_tile(0, 0);
    if (tid < 2 * BQ) stats[tid] = load_stat(0);
  }
  tc::cp_async_commit();

  // The warp's K and V rows as A fragments: (key kr + g, dim t4) on.
  const float* kwp = Ks + (kr + g) * LD + t4;
  const float* vwp = Vs + (kr + g) * LD + t4;
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    // Pair it (and, at it = 0, K and V) has landed, and every warp is done
    // with pair it - 1, whose stage pair it + 1 now takes.
    tc::cp_async_wait<0>();
    __syncthreads();
    float stat_next = 0.f;
    if (it + 1 < n_it) {
      load_tile(it + 1, stage ^ 1);
      stat_next = load_stat(it + 1);
    }
    tc::cp_async_commit();

    const int q0 = (t_begin + it % nq) * BQ;
    const float* Qs = QOs + stage * 2 * BQ * LD;
    const float* Os = Qs + BQ * LD;
    const float* lse_s = stats + stage * 2 * BQ;
    const float* d_s = lse_s + BQ;
    // No valid pair for the warp's keys [kw, kw + 16) in this tile?
    const bool skip = kw >= Sk || (causal && q0 + BQ - 1 < kw) ||
                      (window > 0 && q0 >= kw + 15 + window);
    if (!skip) {
      const bool masked = kw + 16 > Sk || q0 + BQ > S ||
                          (causal && q0 < kw + 15) ||
                          (window > 0 && q0 + BQ - 1 >= kw + window);
      // S^T = K Q^T and dP^T = V dO^T: keys are the m16 rows; Q's and dO's
      // B fragments are (query 8 j + g, dims t4 and t4 + 4 of the step).
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 1
      for (int k0s = 0; k0s < KS; k0s += C::JD_DKDV) {
        float ps[NT][4] = {}, pd[NT][4] = {};
#pragma unroll
        for (int kk = k0s; kk < k0s + C::JD_DKDV; ++kk) {
          uint32_t kh[4], kl[4], vh[4], vl[4];
          a_frag<LD>(kwp + kk * 8, kh, kl);
          a_frag<LD>(vwp + kk * 8, vh, vl);
          const float* qp = Qs + g * LD + kk * 8 + t4;
          const float* op = Os + g * LD + kk * 8 + t4;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bh[2], bl[2];
            b_frag(qp + j * 8 * LD, 4, bh, bl);
            tc::mma_3xtf32(ps[j], kh, kl, bh, bl);
            b_frag(op + j * 8 * LD, 4, bh, bl);
            tc::mma_3xtf32(pd[j], vh, vl, bh, bl);
          }
        }
        add_to(st, ps);
        add_to(dpt, pd);
      }
      // p and ds in place: element e of tile j is key kw + g (+ 8 for e >=
      // 2), query row q0 + 8 j + 2 t4 (+ 1 for odd e).
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int qc = j * 8 + 2 * t4;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 dd = *reinterpret_cast<const float2*>(d_s + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dfac;
          const float x = fc::bwd_x(st[j][e], sc, dfac);
          bool valid = true;
          if (masked) {
            const int kp = kw + g + (e >> 1) * 8, qp = q0 + qc + (e & 1);
            valid = kp < Sk && qp < S && (!causal || kp <= qp) &&
                    (window <= 0 || kp > qp - window);
          }
          const float p =
              valid ? fc::fast_exp2(x - (e & 1 ? ls.y : ls.x)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (e & 1 ? dd.y : dd.x)) * dfac;
        }
      }
      // dV += P^T dO, then dK += dS^T Q, over the tile's rows: P^T and dS^T
      // from the registers, dO's and q's B fragments (query rows 8 j + 2
      // t4 and + 1, dim dc + 8 d + g).
      {
        uint32_t ah[NT][4], al[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) acc_frag(st[j], ah[j], al[j]);
        acc_times_b<NT, DT, C::JQ, LD>(dv_acc, ah, al,
                                       Os + 2 * t4 * LD + dc + g);
      }
      {
        uint32_t ah[NT][4], al[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) acc_frag(dpt[j], ah[j], al[j]);
        acc_times_b<NT, DT, C::JQ, LD>(dk_acc, ah, al,
                                       Qs + 2 * t4 * LD + dc + g);
      }
    }
    if (it + 1 < n_it && tid < 2 * BQ)
      stats[(stage ^ 1) * 2 * BQ + tid] = stat_next;
  }
  tc::cp_async_wait<0>();

  // Rows kw + g and kw + g + 8, columns dc + 8 d + 2 t4 and + 1: dk and dv
  // themselves with one group, else the group's partials, dk's at
  // ws[group], dv's at ws[groups + group], each (B, Sk, KV, HD).
  const int kp0 = kw + g, kp1 = kp0 + 8;
  const size_t col = kv_off + dc + 2 * t4;
  const size_t n = (size_t)(gridDim.x / KV) * Sk * k_row;
  float* wk = gridDim.z == 1 ? dk : ws + blockIdx.z * n;
  float* wv = gridDim.z == 1 ? dv : ws + (gridDim.z + blockIdx.z) * n;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const size_t c = col + d * 8;
    if (kp0 < Sk) {
      *reinterpret_cast<float2*>(wk + kp0 * k_row + c) =
          make_float2(dk_acc[d][0], dk_acc[d][1]);
      *reinterpret_cast<float2*>(wv + kp0 * k_row + c) =
          make_float2(dv_acc[d][0], dv_acc[d][1]);
    }
    if (kp1 < Sk) {
      *reinterpret_cast<float2*>(wk + kp1 * k_row + c) =
          make_float2(dk_acc[d][2], dk_acc[d][3]);
      *reinterpret_cast<float2*>(wv + kp1 * k_row + c) =
          make_float2(dv_acc[d][2], dv_acc[d][3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::DQ_BLOCKS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq, int S,
                    int Sk, int H, int KV, int causal, int window,
                    fc::BwdScale sc) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK_T, LD = C::LD, KS = C::KS;
  constexpr int NT = BK / 8, DT = HD / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* Os = Qs + BQ * LD;           // [BQ][LD]
  float* KVs = Os + BQ * LD;          // [stage][K, V][BK][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = fc::block_q0(BQ), w_first = q0 + warp * 16;
  const int row0 = w_first + g, row1 = row0 + 8;
  const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
  const size_t q_off = ((size_t)b * S * H + h) * HD;
  const size_t kv_off = ((size_t)b * Sk * KV + kvh) * HD;
  const fc::Tiles tiles = fc::kv_tiles<BQ, BK>(q0, S, Sk, causal, window);

  auto load_tile = [&](int t, int stage) {
    float* Ks = KVs + stage * 2 * BK * LD;
    copy_rows<HD, BK, C::THREADS>(Ks, k + kv_off, Sk, k_row, t * BK);
    copy_rows<HD, BK, C::THREADS>(Ks + BK * LD, v + kv_off, Sk, k_row,
                                  t * BK);
  };
  copy_rows<HD, BQ, C::THREADS>(Qs, q + q_off, S, q_row, q0);
  copy_rows<HD, BQ, C::THREADS>(Os, dO + q_off, S, q_row, q0);
  if (tiles.begin < tiles.end) load_tile(tiles.begin, 0);
  tc::cp_async_commit();
  const size_t bh = ((size_t)b * H + h) * S;
  const float lse0 = row0 < S ? lse[bh + row0] : 0.f;
  const float lse1 = row1 < S ? lse[bh + row1] : 0.f;
  const float d0 = row0 < S ? D[bh + row0] : 0.f;
  const float d1 = row1 < S ? D[bh + row1] : 0.f;

  // The warp's q and dO rows as A fragments: (row warp 16 + g, dim t4) on.
  const float* qw = Qs + (warp * 16 + g) * LD + t4;
  const float* ow = Os + (warp * 16 + g) * LD + t4;
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int t = tiles.begin; t < tiles.end; ++t) {
    const int stage = (t - tiles.begin) & 1;
    // Tile t (and, at the first, q and dO) has landed, and every warp is
    // done with tile t - 1, whose stage tile t + 1 now takes.
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles.end) load_tile(t + 1, stage ^ 1);
    tc::cp_async_commit();

    const int k0 = t * BK;
    if (fc::warp_skips<BK>(k0, w_first, S, causal, window))
      continue;   // no valid pair for this warp's rows
    const bool masked = fc::tile_masked<BK>(k0, w_first, Sk, causal, window);
    const float* Ks = KVs + stage * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;

    // S = Q K^T and dP = dO V^T: K's and V's B fragments are (key 8 j + g,
    // dims t4 and t4 + 4 of the step).
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int k0s = 0; k0s < KS; k0s += C::JD_DQ) {
      float ps[NT][4] = {}, pd[NT][4] = {};
#pragma unroll
      for (int kk = k0s; kk < k0s + C::JD_DQ; ++kk) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        a_frag<LD>(qw + kk * 8, qh, ql);
        a_frag<LD>(ow + kk * 8, oh, ol);
        const float* kp = Ks + g * LD + kk * 8 + t4;
        const float* vp = Vs + g * LD + kk * 8 + t4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[2], bl[2];
          b_frag(kp + j * 8 * LD, 4, bh, bl);
          tc::mma_3xtf32(ps[j], qh, ql, bh, bl);
          b_frag(vp + j * 8 * LD, 4, bh, bl);
          tc::mma_3xtf32(pd[j], oh, ol, bh, bl);
        }
      }
      add_to(s, ps);
      add_to(dp, pd);
    }
    // ds in place of s: element e of tile j is row row0 (row1 for e >= 2),
    // key k0 + 8 j + 2 t4 (+ 1 for odd e).
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dfac;
        const float x = fc::bwd_x(s[j][e], sc, dfac);
        bool valid = true;
        if (masked) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qp = e < 2 ? row0 : row1;
          valid = kp < Sk && (!causal || kp <= qp) &&
                  (window <= 0 || kp > qp - window);
        }
        const float p =
            valid ? fc::fast_exp2(x - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * dfac;
      }
    }
    // dQ += dS K: dS from the registers, K's B fragment (keys 8 j + 2 t4
    // and + 1, dim 8 d + g).
    uint32_t ah[NT][4], al[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_frag(s[j], ah[j], al[j]);
    acc_times_b<NT, DT, C::JK, LD>(acc, ah, al, Ks + 2 * t4 * LD + g);
  }
  tc::cp_async_wait<0>();

  float* dqb = dq + q_off + 2 * t4;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (row0 < S)
      *reinterpret_cast<float2*>(dqb + row0 * q_row + d * 8) =
          make_float2(acc[d][0], acc[d][1]);
    if (row1 < S)
      *reinterpret_cast<float2*>(dqb + row1 * q_row + d * 8) =
          make_float2(acc[d][2], acc[d][3]);
  }
}

}  // namespace flash_bwd_fp32
}  // namespace
