// Device helpers shared by the Winograd F(6x6, 3x3) kernels
// (winograd_fused.cu, winograd_3pass.cu): the activation codes of every
// kernel entry and the two 8-point transforms, B^T on the input side and
// A^T on the output side, applied one row or column at a time.
#pragma once

#include <cuda_runtime.h>

namespace winograd {

// act: 0 linear, 1 relu, 2 leaky (slope 0.1, as Darknet).
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

// out[a] = sum_i BT[a][i] * in[i]  (one 8-point input transform)
__device__ __forceinline__ void bt_apply(const float in[8], float out[8]) {
  const float BT[8][8] = {
      {1.f, 0.f, -5.25f, 0.f, 5.25f, 0.f, -1.f, 0.f},
      {0.f, 1.f, 1.f, -4.25f, -4.25f, 1.f, 1.f, 0.f},
      {0.f, -1.f, 1.f, 4.25f, -4.25f, -1.f, 1.f, 0.f},
      {0.f, 0.5f, 0.25f, -2.5f, -1.25f, 2.f, 1.f, 0.f},
      {0.f, -0.5f, 0.25f, 2.5f, -1.25f, -2.f, 1.f, 0.f},
      {0.f, 2.f, 4.f, -2.5f, -5.f, 0.5f, 1.f, 0.f},
      {0.f, -2.f, 4.f, 2.5f, -5.f, -0.5f, 1.f, 0.f},
      {0.f, -1.f, 0.f, 5.25f, 0.f, -5.25f, 0.f, 1.f}};
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(BT[a][i], in[i], s);
    out[a] = s;
  }
}

// out[x] = sum_a AT[x][a] * in[a]  (one 8-point output transform)
__device__ __forceinline__ void at_apply(const float in[8], float out[6]) {
  const float AT[6][8] = {
      {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 0.f},
      {0.f, 1.f, -1.f, 2.f, -2.f, 0.5f, -0.5f, 0.f},
      {0.f, 1.f, 1.f, 4.f, 4.f, 0.25f, 0.25f, 0.f},
      {0.f, 1.f, -1.f, 8.f, -8.f, 0.125f, -0.125f, 0.f},
      {0.f, 1.f, 1.f, 16.f, 16.f, 0.0625f, 0.0625f, 0.f},
      {0.f, 1.f, -1.f, 32.f, -32.f, 0.03125f, -0.03125f, 1.f}};
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) s = fmaf(AT[x][a], in[a], s);
    out[x] = s;
  }
}

// Y = act(A^T M A + bias) for one (tile, out channel) pair: m[p] holds M at
// position p = 8 * row + col; dst[(x * 6 + y) * stride] receives Y[x][y].
// Columns first, then rows.
__device__ __forceinline__ void output_tile(const float m[64], float bias,
                                            int act, float* dst,
                                            size_t stride) {
  float tmp[6][8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    float col[8], r[6];
#pragma unroll
    for (int a = 0; a < 8; ++a) col[a] = m[a * 8 + b];
    at_apply(col, r);
#pragma unroll
    for (int x = 0; x < 6; ++x) tmp[x][b] = r[x];
  }
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    float r[6];
    at_apply(tmp[x], r);
#pragma unroll
    for (int y = 0; y < 6; ++y) dst[(x * 6 + y) * stride] = activate(r[y] + bias, act);
  }
}

}  // namespace winograd
