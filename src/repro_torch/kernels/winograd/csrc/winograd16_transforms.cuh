// The two 8-point F(6x6, 3x3) transforms of the 16-bit Winograd kernels
// (winograd_fused_16.cu, winograd_3pass_16.cu), in fp32: B^T on the input
// side, A^T on the output side, one row or column at a time, with the
// zeros of the matrices and their symmetric row pairs taken out (the fp32
// fused kernel's arithmetic, winograd_fused.cu).
#pragma once

#include <cuda_runtime.h>

namespace {
namespace winograd16 {

// out[a] = sum_i BT[a][i] in[i], with BT's zeros and the symmetric row
// pairs (1, 2), (3, 4), (5, 6) taken out (winograd_fused.cu's).
__device__ __forceinline__ void bt8(const float d[8], float r[8]) {
  r[0] = fmaf(5.25f, d[4] - d[2], d[0] - d[6]);
  r[7] = fmaf(5.25f, d[3] - d[5], d[7] - d[1]);
  const float a1 = fmaf(-4.25f, d[4], d[2] + d[6]);
  const float b1 = fmaf(-4.25f, d[3], d[1] + d[5]);
  r[1] = a1 + b1;
  r[2] = a1 - b1;
  const float a3 = fmaf(0.25f, d[2], fmaf(-1.25f, d[4], d[6]));
  const float b3 = fmaf(0.5f, d[1], fmaf(-2.5f, d[3], 2.f * d[5]));
  r[3] = a3 + b3;
  r[4] = a3 - b3;
  const float a5 = fmaf(4.f, d[2], fmaf(-5.f, d[4], d[6]));
  const float b5 = fmaf(2.f, d[1], fmaf(-2.5f, d[3], 0.5f * d[5]));
  r[5] = a5 + b5;
  r[6] = a5 - b5;
}

// out[x] = sum_a AT[x][a] in[a] (6 of 8), with the pairs (1, 2), (3, 4),
// (5, 6) as sums and differences (winograd_fused.cu's).
__device__ __forceinline__ void at8(const float m[8], float r[6]) {
  const float s12 = m[1] + m[2], d12 = m[1] - m[2];
  const float s34 = m[3] + m[4], d34 = m[3] - m[4];
  const float s56 = m[5] + m[6], d56 = m[5] - m[6];
  r[0] = m[0] + s12 + s34 + s56;
  r[1] = fmaf(2.f, d34, fmaf(0.5f, d56, d12));
  r[2] = fmaf(4.f, s34, fmaf(0.25f, s56, s12));
  r[3] = fmaf(8.f, d34, fmaf(0.125f, d56, d12));
  r[4] = fmaf(16.f, s34, fmaf(0.0625f, s56, s12));
  r[5] = fmaf(32.f, d34, fmaf(0.03125f, d56, d12)) + m[7];
}

}  // namespace winograd16
}  // namespace
