// What the two flash-attention kernels share (flash_attention_bf16.cuh and
// flash_attention_fp32.cuh): the block layout, the kv tiles a block and a
// warp visit, the mask, and the online softmax in base 2 on the m16n8
// accumulator fragments of mma.sync (the same layout at k16 and at k8).
// The backward's bodies (flash_attention_bwd_bf16.cuh and _fp32.cuh) take
// the tiles, the mask, fast_exp2 and the softcap's factor (bwd_x) from
// here too.
//
// Blocks.  One block owns BQ query rows of one (batch, head), 16 rows a
// warp; blockIdx.x is the (batch, head) and blockIdx.y walks the q-blocks
// from the last, so the heaviest causal blocks start first.
//
// Masks.  Positions start at 0: a pair is valid when k_pos < Sk, and
// k_pos <= q_pos (causal), and k_pos > q_pos - window (window > 0).  A
// block visits only the kv tiles that hold a valid pair for one of its
// rows; inside that range a warp skips a tile that holds none for its 16
// rows and evaluates the mask only on a tile that crosses the causal
// diagonal, the window edge or Sk.  A masked score is -inf, so it adds
// p = 0; a row that has seen no valid key yet takes 0 as its max, so
// exp2(-inf - 0) = 0 and no NaN arises.  Ragged S and Sk are masked here,
// never padded.
//
// Softmax.  Without a softcap x = s * (scale * log2 e); with one x =
// tanh(s * (scale / cap)) * (cap * log2 e), each bracket one fp32 constant
// (softmax_scale); m is the running max of x, p = exp2(x - m) and alpha =
// exp2(m_old - m).  exp2 is the SFU's ex2.approx.ftz (about 2^-22
// relative), and tanh(y) is 1 - 2 / (exp2(2 y log2 e) + 1) (a few 1e-7
// absolute).  l sums each thread's p; the quad's sums are added once, at
// the end.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

// Internal linkage, as every kernel source here.
namespace {
namespace flash_common {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, fast_exp2(2.f * LOG2E * x) + 1.f);
}

// Max and sum over the 4 threads of a quad (the threads of one row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The first query row of this block: the q-blocks run from the last.
__device__ __forceinline__ int block_q0(int bq) {
  return (gridDim.y - 1 - blockIdx.y) * bq;
}

// The kv tiles [begin, end) of BK keys that hold a valid pair for some row
// of the block's rows [q0, q0 + BQ).
struct Tiles {
  int begin, end;
};
template <int BQ, int BK>
__device__ __forceinline__ Tiles kv_tiles(int q0, int S, int Sk, int causal,
                                          int window) {
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  return {k_begin / BK, (k_end + BK - 1) / BK};
}

// The tile of BK keys from k0 holds no valid pair for the warp's rows
// [w_first, w_first + 16).
template <int BK>
__device__ __forceinline__ bool warp_skips(int k0, int w_first, int S,
                                           int causal, int window) {
  return w_first >= S || (causal && k0 > w_first + 15) ||
         (window > 0 && k0 + BK - 1 <= w_first - window);
}

// Some pair of that tile and those rows is masked.
template <int BK>
__device__ __forceinline__ bool tile_masked(int k0, int w_first, int Sk,
                                            int causal, int window) {
  return k0 + BK > Sk || (causal && k0 + BK - 1 > w_first) ||
         (window > 0 && k0 <= w_first + 15 - window);
}

// One kv tile of the online softmax on a warp's scores.  s[j] is the m16n8
// accumulator of keys k0 + 8j .. k0 + 8j + 7: this thread holds rows row0
// (elements 0, 1) and row0 + 8 (2, 3), keys 2 t4 and 2 t4 + 1.  On return
// s holds p, m0/m1 the running maxima, l0/l1 this thread's sums, and acc
// (the m16n8 output fragments) is scaled by alpha.
template <int NT, int DT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NT][4], float (&acc)[DT][4], float& m0, float& m1, float& l0,
    float& l1, float x_scale, float cap_out, bool masked, int k0, int row0,
    int Sk, int causal, int window) {
  const int t4 = threadIdx.x % 4;
  const int row1 = row0 + 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * x_scale;
      if (cap_out > 0.f) x = fast_tanh(x) * cap_out;
      if (masked) {
        const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
        const int qp = e < 2 ? row0 : row1;
        const bool valid = kp < Sk && (!causal || kp <= qp) &&
                           (window <= 0 || kp > qp - window);
        x = valid ? x : -INFINITY;
      }
      s[j][e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  const float alpha0 = fast_exp2(m0 - mu0), alpha1 = fast_exp2(m1 - mu1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = fast_exp2(s[j][0] - mu0);
    s[j][1] = fast_exp2(s[j][1] - mu0);
    s[j][2] = fast_exp2(s[j][2] - mu1);
    s[j][3] = fast_exp2(s[j][3] - mu1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc[d][0] *= alpha0;
    acc[d][1] *= alpha0;
    acc[d][2] *= alpha1;
    acc[d][3] *= alpha1;
  }
}

// 1 / l of a row from one thread's sum.
__device__ __forceinline__ float row_inv(float l) {
  return 1.f / fmaxf(quad_sum(l), 1e-37f);
}

// The backward's saved row statistic, written when the caller asks for
// it (lse_bh, the (batch, head) row of the (B, H, S) fp32 LSE, is not
// null; a uniform branch, so every lane of the quad takes part in the
// sum): lse = m + log2(l), the log-sum-exp in base 2 of the x units above,
// so the backward recomputes p = exp2(x - lse) = exp2(x - m) / l.  Rows at
// or beyond S are not written.
__device__ __forceinline__ void store_lse(float* lse_bh, int row, int S,
                                          float m, float l) {
  const float sum = quad_sum(l);
  if (threadIdx.x % 4 == 0 && row < S) lse_bh[row] = m + log2f(sum);
}

// The backward's constants (flash_attention_bwd.cu): x_scale and cap_out
// as make_launch's below, and ds_scale = 1/sqrt(hd).
struct BwdScale {
  float x_scale, cap_out, ds_scale;
};
inline BwdScale bwd_scale(int hd, float cap) {
  const float scale = static_cast<float>(1.0 / sqrt((double)hd));
  return {cap > 0.f ? scale / cap : scale * LOG2E,
          cap > 0.f ? cap * LOG2E : 0.f, scale};
}

// The backward's x of a score s (the forward's units, so p = exp2(x -
// lse)), and in dfac the factor that turns p (dp - D) into ds: ds_scale,
// times 1 - tanh^2 of the cap's argument y with a softcap.  tanh(y) is
// fast_tanh's 1 - u with u = 2 / (exp2(2 y log2 e) + 1), and 1 - tanh^2 =
// u (2 - u), which stays accurate where the cap saturates (u -> 0 or 2,
// the factor -> 0, never 1 - 1 rounded up).
__device__ __forceinline__ float bwd_x(float s, const BwdScale& sc,
                                       float& dfac) {
  float x = s * sc.x_scale, dcap = 1.f;
  if (sc.cap_out > 0.f) {
    const float u = 2.f / (fast_exp2(2.f * LOG2E * x) + 1.f);
    dcap = u * (2.f - u);
    x = (1.f - u) * sc.cap_out;
  }
  dfac = sc.ds_scale * dcap;
  return x;
}

// The launch: the two softmax constants of a head dim and a cap, and the
// grid of (batch x head, q-blocks); false when S needs more q-blocks than
// a grid's y can hold.
struct Launch {
  dim3 grid;
  float x_scale, cap_out;
};
inline bool make_launch(int B, int H, int S, int bq, int hd, float cap,
                        Launch& out) {
  const int q_blocks = (S + bq - 1) / bq;
  if (q_blocks > 65535) return false;
  const float scale = static_cast<float>(1.0 / sqrt((double)hd));
  out.grid = dim3(B * H, q_blocks);
  // Without a cap: x = s * (scale * log2 e).  With one:
  // x = tanh(s * (scale / cap)) * (cap * log2 e).
  out.x_scale = cap > 0.f ? scale / cap : scale * LOG2E;
  out.cap_out = cap > 0.f ? cap * LOG2E : 0.f;
  return true;
}

}  // namespace flash_common
}  // namespace
