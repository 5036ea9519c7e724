// Flash attention (forward) for sm_90a: online-softmax attention that never
// writes the (S, Sk) score matrix to device memory.  One C entry,
// repro_flash_attention, dispatches by type: fp32 inputs run the CUDA-core
// kernel below, bf16 inputs the tensor-core kernel of
// flash_attention_bf16.cuh.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas and
// computes what its body _flash_kernel computes, row by row:
//   s = (q . k) * (1/sqrt(hd)); s = tanh(s / cap) * cap when cap > 0;
//   masked pairs get the finite NEG_INF; an online softmax with fp32 running
//   max m, sum l and accumulator acc; out = acc / max(l, 1e-37).
//
// Layout.  q (B, S, H, hd) and k, v (B, Sk, KV, hd) are read in place:
// query head h reads KV head h / (H / KV), the grouping of
// q.reshape(b, s, kv, g, hd) in repro/models/attention.py, so no K/V head is
// copied or broadcast.  The output is (B, S, H, hd), like q.
//
// The fp32 kernel.  The TPU kernel walks a (BH, S/bq, Sk/bk) grid in order
// and carries m, l and acc in VMEM scratch across the kv axis.  Here one
// block of 256 threads owns 64 query rows of one (batch, head) and loops
// over the kv tiles itself, with m, l and acc in registers: thread (ty, tx)
// of a 16 x 16 grid owns rows 4ty..4ty+3, score columns tx + 16j of each
// 64-key tile and output columns tx + 16j of hd.  The Q tile and each K and
// V tile are staged in shared memory (K and Q rows padded by one float
// against bank conflicts); a row's max and sum are reduced over the 16
// threads of its half-warp with shuffles; P goes through shared memory to
// the P.V loop.  fp32 FMA on CUDA cores: fp32 has no tensor-core path that
// keeps fp32 accuracy.
//
// Masks.  Positions are q_pos = row, k_pos = key, both from 0.  A pair is
// valid when k_pos < Sk, and k_pos <= q_pos (causal), and
// k_pos > q_pos - window (window > 0).  Ragged S and Sk are masked here, so
// nothing is padded (the reference wrapper's non-causal padding fault cannot
// arise).  The block visits only the kv tiles that hold a valid pair for one
// of its rows: the causal mask ends the loop at its last row and the window
// starts it at its first row's first key.  An invalid pair adds p = 0: the
// TPU kernel adds exp(NEG_INF - NEG_INF) = 1 to a row that has seen no valid
// key yet and clears it when one arrives (alpha = 0), so the results agree.
// The wrapper refuses inputs in which some row has no valid key at all.
//
// What bounds it.  At Llama-3.2-1B's prefill (hd 64, S 4096, causal) the
// work is 4 hd FLOPs per valid pair against q, k, v and o read or written
// once: far above the card's bytes-per-FLOP line, so operations bound it.
// The fp32 kernel runs them as FMAs fed from shared memory (one scalar
// load per FMA on average over the two products), so shared-memory loads,
// not the fp32 peak, limit it.
#include <cuda_runtime.h>

#include <cmath>

#include "flash_attention_bf16.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int RT = 4;          // rows per thread
constexpr int CT = BK / 16;    // score columns per thread
constexpr float NEG_INF = -2.3819763e38f;

// Max and sum over the 16 threads of a half-warp (the threads of one row
// group): xor offsets below 16 stay inside the half.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD +
         (size_t)BQ * (BK + 1);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int S,
                       int Sk, int H, int KV, int causal, int window,
                       float cap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);            // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);            // [BK][HD]
  float* Ps = Vs + BK * HD;                  // [BQ][BK + 1]

  constexpr int OC = HD / 16;                // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);

  const size_t q_row = (size_t)H * HD;       // stride between positions
  const size_t k_row = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int qp = q0 + r;
    Qs[r * (HD + 1) + d] = qp < S ? qb[(size_t)qp * q_row + d] : 0.f;
  }

  float m[RT], l[RT], acc[RT][OC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
  }

  // The kv tiles that hold a valid pair for some row of this block.
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are no longer read
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      const int kp = k0 + r;
      const bool in = kp < Sk;
      Ks[r * (HD + 1) + d] = in ? kb[(size_t)kp * k_row + d] : 0.f;
      Vs[r * HD + d] = in ? vb[(size_t)kp * k_row + d] : 0.f;
    }
    __syncthreads();

    // s = q . k for rows 4ty + i, keys tx + 16j.
    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RT], kv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = Qs[(ty * RT + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < CT; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Scale, cap, mask; the online softmax; p into Ps.
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
      const int qp = q0 + r;
      bool valid[CT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        valid[j] = kp < Sk && (!causal || kp <= qp) &&
                   (window <= 0 || kp > qp - window);
        s[i][j] = valid[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[r * (BK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P . V for rows 4ty + i, output columns tx + 16j.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RT], vv[OC];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = Ps[(ty * RT + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qp = q0 + ty * RT + i;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < OC; ++j)
      ob[(size_t)qp * q_row + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Sk, int H, int KV, int causal, int window, float cap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = static_cast<float>(1.0 / sqrt((double)HD));
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Sk, H, KV,
      causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o (B, S, H, hd) = attention(q (B, S, H, hd), k, v (B, Sk, KV, hd)).
// dtype 0: float (the CUDA-core kernel), 1: bfloat16 (the tensor-core
// kernel).  hd in {16, 32, 64, 128}; H % KV == 0; window <= 0: no window;
// cap <= 0: no softcap.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int Sk, int H, int KV, int hd, int dtype,
                                     int causal, int window, float cap,
                                     cudaStream_t stream) {
  if (B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV != 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(HD)                                                  \
  case HD:                                                                    \
    return dtype == 0 ? launch<HD>(q, k, v, o, B, S, Sk, H, KV, causal,       \
                                   window, cap, stream)                       \
                      : flash_bf16::launch<HD>(q, k, v, o, B, S, Sk, H, KV,   \
                                               causal, window, cap, stream);
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}
