// Flash attention (backward) for sm_90a: dq, dk and dv of the forward in
// flash_attention.cu from q, k, v, the forward's output o, the output's
// gradient dO and the row statistic lse the forward wrote (flash_common.cuh's
// store_lse), without writing the (S, Sk) probabilities to device memory.
//
// It replaces no TPU kernel.  The JAX package trains through plain XLA
// attention (repro/models/attention.py: attention_naive, attention_chunked)
// differentiated by jax.value_and_grad; its Pallas flash kernel has no
// custom_vjp and is on no training path.  The port sends every prefill
// attention through its flash kernel, so the counterpart of that autodiff
// is a backward of the kernel: kernels/flash_attention/ops.py's
// autograd.Function launches this entry, and ref.py::attention_bwd_ref is
// its plain version, step for step.
//
// What it computes, per (batch, query head h, query row i, key j), with
// h on KV head h / (H / KV) as in the forward:
//   s = q_i . k_j;  y = s * scale (scale = 1/sqrt(hd));  s~ = y, or
//   cap * tanh(y / cap) with a softcap; x = s~ * log2 e (the forward's
//   units);  p = exp2(x - lse_i) on a valid pair, else 0 (the mask of
//   flash_common.cuh);
//   D_i = sum_d dO_id o_id                     (pass 1, the dot kernel)
//   dv_j += p dO_i;  dp = dO_i . v_j;  ds~ = p (dp - D_i)
//   ds = ds~ * scale * (1 - tanh^2(y / cap))   (the factor 1 without a cap)
//   dk_j += ds q_i;  dq_i += ds k_j.
// dk and dv sum over the G = H / KV query heads of their KV head.  The
// tanh is flash_common.cuh's, 1 - u with u = 2 / (exp2(2 y' log2 e) + 1),
// and 1 - tanh^2 = u (2 - u), which stays accurate where the cap
// saturates (u -> 0 or 2, the factor -> 0, never 1 - 1 rounded up).
//
// Three launches, no atomics, so the result is deterministic:
//   1. flash_bwd_dot_kernel: D, one warp a (batch, row, head), fp32;
//   2. flash_bwd_dkdv_kernel: one block a (batch, KV head, BK keys); it
//      keeps dk and dv of its keys in registers and loops over the G
//      query heads and over the query tiles of BQ rows that hold a valid
//      pair for one of its keys, recomputing p and ds for each;
//   3. flash_bwd_dq_kernel: one block a (batch, head, BQ query rows),
//      q-blocks from the last (the heaviest under a causal mask first, as
//      the forward); it keeps dq in registers and loops over the key tiles
//      of its rows (flash_common.cuh's kv_tiles), recomputing p and ds.
// Each tile of q, dO, k and v is converted to fp32 as it is copied into
// shared memory (rows hd + 1 floats apart), and every product runs in
// fp32 on the CUDA cores: 256 threads a block as a 16 x 16 grid, thread
// (ty, tx) holding the rows ty + 16 i and the columns (keys or dims)
// tx + 16 j of its block's tiles, so that a warp reads 16 consecutive
// columns (distinct banks) and two rows (broadcast).  p and ds of a tile
// go through shared memory between the products.  dk, dv and dq are
// written once, in the inputs' type.
//
// Tiles.  BQ = BK = 64 up to hd 128, 32 at hd 256, where a thread's dk and
// dv of 64 keys would take 128 accumulator registers: with 32 keys they
// take 64 (dq likewise).  Dynamic shared memory (Cfg::SMEM): q, dO, k and
// v tiles, p and ds, lse and D: 100,352 bytes at hd 64 (two blocks an SM),
// 116,736 at hd 80, 165,888 at hd 128 and 140,288 at hd 256 (one), above
// 48 KB, so each launch function sets it up per device (per_device.cuh).
//
// What bounds it.  The work is five products of 2 hd FLOPs per valid
// (row, key) pair and head (s, dp, dv, dk, dq): operations, far above the
// card's bytes-per-FLOP line.  This first kernel runs seven (the dq kernel
// recomputes s and dp) on the fp32 CUDA cores, and each inner step reads
// two shared-memory words per two FMAs, so shared memory holds it near
// half of the fp32 CUDA-core peak at best, far below the bf16 tensor-core
// bound that chip_smoke.py states beside it.  Next: mma.sync (bf16 in,
// fp32 sums) for the five products, then wgmma with TMA loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "flash_common.cuh"
#include "per_device.cuh"

namespace {
namespace flash_bwd {

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + ROWS) of head `head` of a (B, n, heads, HD) tensor of
// batch b into dst[ROWS][LD] as fp32, zero past n.
template <int HD, int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b,
                                          int n, int heads, int head,
                                          int r0) {
  constexpr int LD = HD + 1;
  const T* base = src + ((size_t)b * n * heads + head) * HD;
  for (int e = threadIdx.x; e < ROWS * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * LD + c] =
        r0 + r < n ? to_f(base[(size_t)(r0 + r) * heads * HD + c]) : 0.f;
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

struct Scale {
  float x_scale, cap_out, ds_scale;
};

// p and ds of the (query tile from q0) x (key tile from k0) pair into
// Ps[BQ][LP] and dSs[BQ][LP], from the tiles in shared memory: thread
// (ty, tx) computes rows ty + 16 i and keys tx + 16 j.
template <int HD>
__device__ __forceinline__ void p_and_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* d_s, float* Ps, float* dSs, int q0,
    int k0, int S, int Sk, int causal, int window, Scale sc) {
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
      float x = s[i][j] * sc.x_scale, dcap = 1.f;
      if (sc.cap_out > 0.f) {
        const float u = 2.f / (fc::fast_exp2(2.f * fc::LOG2E * x) + 1.f);
        dcap = u * (2.f - u);
        x = (1.f - u) * sc.cap_out;
      }
      const float p = valid ? fc::fast_exp2(x - lse_s[r]) : 0.f;
      Ps[r * LP + c] = p;
      dSs[r * LP + c] = p * (dp[i][j] - d_s[r]) * (sc.ds_scale * dcap);
    }
  }
}

// D = rowsum(dO o o) in fp32, one warp a row of (B, S, H) rows, written
// as (B, H, S).
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                     float* __restrict__ D, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + (size_t)row * hd;
  const T* gp = dO + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(op[d]), to_f(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H;   // row = (b S + s) H + h
    const int b = bs / S, s = bs % S;
    D[((size_t)b * H + h) * S + s] = acc;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::MIN_BLOCKS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int Sk, int H, int KV,
                      int causal, int window, Scale sc) {
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
  T* dkb = dk + ((size_t)b * Sk * KV + kvh) * HD;
  T* dvb = dv + ((size_t)b * Sk * KV + kvh) * HD;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(size_t)kp * k_row + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dvb[(size_t)kp * k_row + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::MIN_BLOCKS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int S,
                    int Sk, int H, int KV, int causal, int window, Scale sc) {
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
  T* dqb = dq + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(size_t)qp * q_row + tx + 16 * j] = from_f<T>(dq_acc[i][j]);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int S, int Sk, int H, int KV, int causal,
           int window, float cap, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const int q_blocks = (S + C::BQ - 1) / C::BQ;
  const int k_blocks = (Sk + C::BK - 1) / C::BK;
  if (q_blocks > 65535 || k_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt((double)HD));
  // The forward's units (flash_common.cuh's make_launch).
  const Scale sc = {cap > 0.f ? scale / cap : scale * fc::LOG2E,
                    cap > 0.f ? cap * fc::LOG2E : 0.f, scale};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dO);
  const int rows = B * S * H;
  flash_bwd_dot_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                            THREADS, 0, stream>>>(
      static_cast<const T*>(o), gt, D, rows, S, H, HD);
  flash_bwd_dkdv_kernel<HD, T><<<dim3(B * KV, k_blocks), THREADS, C::SMEM,
                                 stream>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S,
      Sk, H, KV, causal, window, sc);
  flash_bwd_dq_kernel<HD, T><<<dim3(B * H, q_blocks), THREADS, C::SMEM,
                               stream>>>(qt, kt, vt, gt, lse, D,
                                         static_cast<T*>(dq), S, Sk, H, KV,
                                         causal, window, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_bwd
}  // namespace

// dq (B, S, H, hd), dk and dv (B, Sk, KV, hd), in the inputs' type, of the
// forward attention(q, k, v) with its output o (B, S, H, hd) and that
// output's gradient dO (like o), from the forward's lse (B, H, S) fp32.
// D is a (B, H, S) fp32 workspace.  dtype 0: float, 1: bfloat16; hd in
// {16, 32, 64, 80, 128, 256}; H % KV == 0; window <= 0: no window; cap <=
// 0: no softcap.  Every tensor contiguous.  Returns cudaGetLastError().
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* D, void* dq, void* dk, void* dv,
    int B, int S, int Sk, int H, int KV, int hd, int dtype, int causal,
    int window, float cap, cudaStream_t stream) {
  if (B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV != 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_BWD_CASE(HD)                                              \
  case HD:                                                                    \
    return dtype == 0                                                         \
               ? flash_bwd::launch<HD, float>(q, k, v, o, dO, lse, D, dq, dk, \
                                              dv, B, S, Sk, H, KV, causal,    \
                                              window, cap, stream)            \
               : flash_bwd::launch<HD, __nv_bfloat16>(                        \
                     q, k, v, o, dO, lse, D, dq, dk, dv, B, S, Sk, H, KV,     \
                     causal, window, cap, stream);
  switch (hd) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(80)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD_CASE
}
