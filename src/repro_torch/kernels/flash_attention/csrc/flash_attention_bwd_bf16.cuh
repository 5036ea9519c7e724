// Flash attention (backward), bf16, on the tensor cores of sm_90a: the
// FlashAttention-2 backward shape from mma.sync m16n8k16 (bf16 in, fp32
// sums), ldmatrix and cp.async (hmma16.cuh).  Included by
// flash_attention_bwd.cu, whose C entry sends bf16 inputs here and fp32
// inputs to flash_attention_bwd_fp32.cuh; the entry's note says what both
// compute.  The tiles' ranges, the mask and the softcap's factor are
// flash_common.cuh's, shared with the forward.
//
// Rounding.  q, k, v and dO are bf16 as given.  s, dp, p and ds are fp32
// in the accumulator fragments; p and ds are rounded to bf16 where they
// become the A operand of dv += p^T dO, dk += ds^T q and dq += ds k, as
// the forward rounds p for P.V and as SDPA's backward does; every sum is
// fp32, and dq, dk and dv are rounded once to bf16 at the store.
// scripts/flash_bwd_replay.py replays these steps on the CPU.
//
// dk/dv kernel (flash_bwd_dkdv_kernel).  One block a (batch, KV head, BK
// keys) and, where the entry splits the G query heads of the KV head into
// groups, a group (blockIdx.z).  4 warps; each owns 16 keys (at hd 256,
// DSPLIT = 2 warps share 16 keys, each holding half of the head dim of dk
// and dv).  K and V of the block's keys land once in shared memory; the
// block loops over the (head, query tile) pairs of its group, the query
// tiles being those of BQ rows that hold a valid pair for one of its keys
// (flash_common.cuh's mask), with q, dO, lse and D of the next pair in
// flight (cp.async for q and dO, registers for lse and D) while the
// present one is computed.  A warp computes S^T = K Q^T and dP^T = V dO^T
// with its keys as the m16 rows, so P^T and dS^T come out in the m16n8
// accumulator layout, and two adjacent n8 tiles of it are the m16n8k16 A
// fragment of dV += P^T dO and dK += dS^T Q: p and ds never leave the
// registers (the forward's P.V trick).  The B fragments come by ldmatrix
// from the q and dO tiles: as they lie for Q^T and dO^T, transposed for Q
// and dO.  Blocks are launched with blockIdx.y = 0 (the first keys, the
// most query tiles under a causal mask) first.  Each group writes its
// fp32 partial dk and dv to the entry's workspace, and the entry's reduce
// launch sums the groups in group order and rounds once; with one group
// the block rounds and stores dk and dv itself.
//
// dq kernel (flash_bwd_dq_kernel).  One block a (batch, query head, BQ =
// 64 rows), 4 warps of 16 rows, q-blocks from the last (flash_common.cuh's
// block_q0).  q and dO fragments stay in registers up to hd 128 (reloaded
// from shared memory at each k-step at hd 256); K and V tiles of BK keys
// over flash_common.cuh's kv_tiles are double-buffered by cp.async.  S =
// Q K^T and dP = dO V^T on mma.sync; dS, repacked in registers, times K
// (ldmatrix.trans) accumulates dq.  This kernel recomputes s and dp, so
// the pair does seven products for the five the bound counts: that buys a
// dq without atomics, so the result is deterministic.
//
// Registers (fp32 values a thread).  dk/dv: dk and dv of 16 keys take hd
// values, s and dp of a BQ-row tile BQ more, K and V fragments hd / 2
// where they are kept (hd <= 64): 160 at hd 64 with BQ 64, 160 at hd 128
// with BQ 32; at hd 256 dk and dv of 16 keys would be 256 alone, so two
// warps share the keys (DSPLIT), each recomputing s and dp for its half
// of the head dim: 128 + 32.  dq: hd / 2 for dq, hd / 2 for the q and dO
// fragments up to hd 128, BK for s and dp.  With addresses, masks and
// fragments in flight ptxas gives dk/dv 255 registers at hd 64, 235-243
// at hd 80-256, and no spills (two blocks an SM); dq 168 at hd 64 (three
// blocks an SM, 24 bytes spilled), 188-246 above.  chip_smoke.py prints
// ptxas' counts.
//
// Shared memory, rows hd + 8 bf16 apart (an odd number of 16-byte groups,
// so the 8 rows of every ldmatrix fall in distinct bank groups):
// dk/dv, K and V [BK] and two stages of q and dO [BQ], with lse and D;
// dq, q and dO [64] and two stages of K and V [BK].
//
// What bounds it.  Operations, as before: five products of 2 hd FLOPs per
// valid pair and head.  Every warp reads its B fragments from shared
// memory through ldmatrix, 256 bytes per m16n8k16 product, so shared
// memory bandwidth and mma.sync's own issue rate, with the 4-warp blocks'
// barriers, hold it well below the bf16 tensor-core peak; the dq kernel's
// two extra products add 40 % to the work.  Next (ROADMAP lever B1.2):
// wgmma from shared memory with TMA loads and a producer warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "hmma16.cuh"

// Internal linkage, as every kernel source here.
namespace {
namespace flash_bwd_bf16 {

namespace fc = flash_common;
namespace hm = hmma16;
using bf16 = __nv_bfloat16;

template <int HD>
struct Cfg {
  static constexpr int NW = 4;                 // warps a block, both kernels
  static constexpr int THREADS = 32 * NW;
  static constexpr int LD = HD + 8;            // smem row stride (bf16)
  static constexpr int KS = HD / 16;           // k-steps over the head dim
  // dk/dv kernel: warps sharing 16 keys, the dk/dv columns of a warp, keys
  // a block, query rows a tile, K and V fragments kept in registers.
  static constexpr int DSPLIT = HD == 256 ? 2 : 1;
  static constexpr int DW = HD / DSPLIT;
  static constexpr int BK = HD == 256 ? 32 : 64;
  static constexpr int BQ_T = HD <= 80 ? 64 : 32;
  static constexpr bool KV_IN_REGS = HD <= 64;
  // K and V, two stages of q and dO, two of lse and D.
  static constexpr int SMEM_DKDV =
      (2 * BK + 4 * BQ_T) * LD * 2 + 4 * BQ_T * 4;
  // dq kernel: rows a block, keys a tile, q and dO fragments in registers,
  // resident blocks an SM (three up to hd 64: 168 registers and 24 bytes
  // spilled there, 9 % faster at Llama-3.2-1B's shape than two at 222;
  // above, three spill hundreds of bytes and lose:
  // scripts/flash_bwd_variants.py).
  static constexpr int BQ = 16 * NW;
  static constexpr int BK_T = HD <= 64 ? 64 : 32;
  static constexpr bool QO_IN_REGS = HD <= 128;
  static constexpr int DQ_BLOCKS = HD <= 64 ? 3 : 2;
  // q and dO, two stages of K and V.
  static constexpr int SMEM_DQ = (2 * BQ + 4 * BK_T) * LD * 2;
  static_assert(BK == 16 * NW / DSPLIT, "a warp owns 16 keys");
  static_assert(2 * BQ_T <= THREADS, "a thread loads one of lse and D");
};

// rows [r0, r0 + ROWS) of a (., n, heads, HD) bf16 tensor from src (its
// head's first row, rows row_stride apart) into dst[ROWS][HD + 8] by
// cp.async, 16 bytes a thread, zero-filled past n.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int n,
                                          size_t row_stride, int r0) {
  constexpr int CH = HD / 8, LD = HD + 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = r0 + r < n;
    hm::cp_async16(dst + r * LD + c * 8,
                   src + (in ? (size_t)(r0 + r) * row_stride + c * 8 : 0), in);
  }
}

// The A fragment (16 x 16) at rows r0, columns c0 of a [row][LD] array.
template <int LD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* base,
                                       int r0, int c0, int lane) {
  hm::ldsm_x4(a, hm::smem_addr(base + (r0 + hm::a_frag_row(lane)) * LD + c0 +
                               hm::a_frag_col(lane)));
}
// The B fragments of two n8 tiles from n0, k-step from c0, of an [n][k]
// array (rows are B's columns): b0, b1 of tile n0 in r[0], r[1], of tile
// n0 + 8 in r[2], r[3].
template <int LD>
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&r)[4], const bf16* base,
                                          int n0, int c0, int lane) {
  hm::ldsm_x4(r, hm::smem_addr(base + (n0 + lane % 8 + (lane / 16) * 8) * LD +
                               c0 + ((lane / 8) % 2) * 8));
}
// ... and of a [k][n] array (rows are B's k), by ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&r)[4], const bf16* base,
                                          int k0, int n0, int lane) {
  hm::ldsm_x4_trans(r, hm::smem_addr(base + (k0 + hm::b_frag_k(lane)) * LD +
                                     n0 + hm::b_frag_n(lane)));
}

// Two adjacent m16n8 accumulator tiles (k 0-7 and 8-15) rounded to the
// m16n8k16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = hm::pack2<bf16>(lo[0], lo[1]);
  a[1] = hm::pack2<bf16>(lo[2], lo[3]);
  a[2] = hm::pack2<bf16>(hi[0], hi[1]);
  a[3] = hm::pack2<bf16>(hi[2], hi[3]);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 2)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ ws, int S,
                      int Sk, int H, int KV, int causal, int window,
                      fc::BwdScale sc) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, BQ = C::BQ_T, LD = C::LD, KS = C::KS;
  constexpr int NT = BQ / 8, DT = C::DW / 8, KF = C::KV_IN_REGS ? KS : 1;
  extern __shared__ __align__(16) bf16 smem[];
  bf16* Ks = smem;                    // [BK][LD]
  bf16* Vs = Ks + BK * LD;            // [BK][LD]
  bf16* QOs = Vs + BK * LD;           // [stage][q, dO][BQ][LD]
  float* stats = reinterpret_cast<float*>(QOs + 4 * BQ * LD);
                                      // [stage][lse, D][BQ]

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
    bf16* Qs = QOs + stage * 2 * BQ * LD;
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
  hm::cp_async_commit();
  hm::cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[KF][4], vf[KF][4];
  if constexpr (C::KV_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_a<LD>(kf[kk], Ks, kr, kk * 16, lane);
      ldsm_a<LD>(vf[kk], Vs, kr, kk * 16, lane);
    }
  }

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    // Pair it has landed, and every warp is done with pair it - 1, whose
    // stage pair it + 1 now takes.
    hm::cp_async_wait<0>();
    __syncthreads();
    float stat_next = 0.f;
    if (it + 1 < n_it) {
      load_tile(it + 1, stage ^ 1);
      stat_next = load_stat(it + 1);
    }
    hm::cp_async_commit();

    const int q0 = (t_begin + it % nq) * BQ;
    const bf16* Qs = QOs + stage * 2 * BQ * LD;
    const bf16* Os = Qs + BQ * LD;
    const float* lse_s = stats + stage * 2 * BQ;
    const float* d_s = lse_s + BQ;
    // No valid pair for the warp's keys [kw, kw + 16) in this tile?
    const bool skip = kw >= Sk || (causal && q0 + BQ - 1 < kw) ||
                      (window > 0 && q0 >= kw + 15 + window);
    if (!skip) {
      const bool masked = kw + 16 > Sk || q0 + BQ > S ||
                          (causal && q0 < kw + 15) ||
                          (window > 0 && q0 + BQ - 1 >= kw + window);
      // S^T = K Q^T and dP^T = V dO^T: keys are the m16 rows.
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (C::KV_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          ldsm_a<LD>(ka, Ks, kr, kk * 16, lane);
          ldsm_a<LD>(va, Vs, kr, kk * 16, lane);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bq[4], bo[4];
          ldsm_b_nk<LD>(bq, Qs, j * 8, kk * 16, lane);
          ldsm_b_nk<LD>(bo, Os, j * 8, kk * 16, lane);
          hm::mma16<bf16>(st[j], ka, bq[0], bq[1]);
          hm::mma16<bf16>(st[j + 1], ka, bq[2], bq[3]);
          hm::mma16<bf16>(dpt[j], va, bo[0], bo[1]);
          hm::mma16<bf16>(dpt[j + 1], va, bo[2], bo[3]);
        }
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
      // dV += P^T dO and dK += dS^T Q over the tile's rows, P^T and dS^T
      // from the registers.
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
        acc_to_a(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t bo[4], bq[4];
          ldsm_b_kn<LD>(bo, Os, kq * 16, dc + d * 8, lane);
          hm::mma16<bf16>(dv_acc[d], pa, bo[0], bo[1]);
          hm::mma16<bf16>(dv_acc[d + 1], pa, bo[2], bo[3]);
          ldsm_b_kn<LD>(bq, Qs, kq * 16, dc + d * 8, lane);
          hm::mma16<bf16>(dk_acc[d], sa, bq[0], bq[1]);
          hm::mma16<bf16>(dk_acc[d + 1], sa, bq[2], bq[3]);
        }
      }
    }
    if (it + 1 < n_it && tid < 2 * BQ)
      stats[(stage ^ 1) * 2 * BQ + tid] = stat_next;
  }
  hm::cp_async_wait<0>();

  // Rows kw + g and kw + g + 8, columns dc + 8 d + 2 t4 and + 1.
  const int kp0 = kw + g, kp1 = kp0 + 8;
  const size_t col = kv_off + dc + 2 * t4;
  if (gridDim.z == 1) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const size_t c = col + d * 8;
      if (kp0 < Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + kp0 * k_row + c) =
            __floats2bfloat162_rn(dk_acc[d][0], dk_acc[d][1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + kp0 * k_row + c) =
            __floats2bfloat162_rn(dv_acc[d][0], dv_acc[d][1]);
      }
      if (kp1 < Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + kp1 * k_row + c) =
            __floats2bfloat162_rn(dk_acc[d][2], dk_acc[d][3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + kp1 * k_row + c) =
            __floats2bfloat162_rn(dv_acc[d][2], dv_acc[d][3]);
      }
    }
  } else {
    // The group's fp32 partials: dk's at ws[group], dv's at ws[groups +
    // group], each (B, Sk, KV, HD).
    const size_t n = (size_t)(gridDim.x / KV) * Sk * k_row;
    float* wk = ws + blockIdx.z * n;
    float* wv = ws + (gridDim.z + blockIdx.z) * n;
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
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::DQ_BLOCKS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, bf16* __restrict__ dq, int S,
                    int Sk, int H, int KV, int causal, int window,
                    fc::BwdScale sc) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK_T, LD = C::LD, KS = C::KS;
  constexpr int NT = BK / 8, DT = HD / 8, QF = C::QO_IN_REGS ? KS : 1;
  extern __shared__ __align__(16) bf16 smem[];
  bf16* Qs = smem;                    // [BQ][LD]
  bf16* Os = Qs + BQ * LD;            // [BQ][LD]
  bf16* KVs = Os + BQ * LD;           // [stage][K, V][BK][LD]

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
    bf16* Ks = KVs + stage * 2 * BK * LD;
    copy_rows<HD, BK, C::THREADS>(Ks, k + kv_off, Sk, k_row, t * BK);
    copy_rows<HD, BK, C::THREADS>(Ks + BK * LD, v + kv_off, Sk, k_row,
                                  t * BK);
  };
  copy_rows<HD, BQ, C::THREADS>(Qs, q + q_off, S, q_row, q0);
  copy_rows<HD, BQ, C::THREADS>(Os, dO + q_off, S, q_row, q0);
  if (tiles.begin < tiles.end) load_tile(tiles.begin, 0);
  hm::cp_async_commit();
  const size_t bh = ((size_t)b * H + h) * S;
  const float lse0 = row0 < S ? lse[bh + row0] : 0.f;
  const float lse1 = row1 < S ? lse[bh + row1] : 0.f;
  const float d0 = row0 < S ? D[bh + row0] : 0.f;
  const float d1 = row1 < S ? D[bh + row1] : 0.f;
  hm::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[QF][4], of[QF][4];
  if constexpr (C::QO_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_a<LD>(qf[kk], Qs, warp * 16, kk * 16, lane);
      ldsm_a<LD>(of[kk], Os, warp * 16, kk * 16, lane);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int t = tiles.begin; t < tiles.end; ++t) {
    const int stage = (t - tiles.begin) & 1;
    // Tile t has landed, and every warp is done with tile t - 1, whose
    // stage tile t + 1 now takes.
    hm::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles.end) load_tile(t + 1, stage ^ 1);
    hm::cp_async_commit();

    const int k0 = t * BK;
    if (fc::warp_skips<BK>(k0, w_first, S, causal, window))
      continue;   // no valid pair for this warp's rows
    const bool masked = fc::tile_masked<BK>(k0, w_first, Sk, causal, window);
    const bf16* Ks = KVs + stage * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;

    // S = Q K^T and dP = dO V^T.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      if constexpr (C::QO_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kk][e];
          oa[e] = of[kk][e];
        }
      } else {
        ldsm_a<LD>(qa, Qs, warp * 16, kk * 16, lane);
        ldsm_a<LD>(oa, Os, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4], bv[4];
        ldsm_b_nk<LD>(bk, Ks, j * 8, kk * 16, lane);
        ldsm_b_nk<LD>(bv, Vs, j * 8, kk * 16, lane);
        hm::mma16<bf16>(s[j], qa, bk[0], bk[1]);
        hm::mma16<bf16>(s[j + 1], qa, bk[2], bk[3]);
        hm::mma16<bf16>(dp[j], oa, bv[0], bv[1]);
        hm::mma16<bf16>(dp[j + 1], oa, bv[2], bv[3]);
      }
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
    // dQ += dS K: dS from the registers, K through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bk[4];
        ldsm_b_kn<LD>(bk, Ks, kk * 16, d * 8, lane);
        hm::mma16<bf16>(acc[d], a, bk[0], bk[1]);
        hm::mma16<bf16>(acc[d + 1], a, bk[2], bk[3]);
      }
    }
  }
  hm::cp_async_wait<0>();

  bf16* dqb = dq + q_off + 2 * t4;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * q_row + d * 8) =
          __floats2bfloat162_rn(acc[d][0], acc[d][1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * q_row + d * 8) =
          __floats2bfloat162_rn(acc[d][2], acc[d][3]);
  }
}

}  // namespace flash_bwd_bf16
}  // namespace
