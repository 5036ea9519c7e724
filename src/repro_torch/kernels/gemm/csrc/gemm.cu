// Blocked fp32 GEMM with a fused bias + activation epilogue, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py::matmul_pallas
// (fp32 bodies): C = act(A @ B + bias), A (M, K) and B (K, N) row-major.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries the fp32 accumulator in VMEM scratch across the K axis.  Here
// blocks run in parallel in no order, so the K axis becomes a loop inside
// the block and the accumulator lives in registers: each of the 256
// threads owns a 4x4 micro-tile of the block's 64x64 output tile.  A and B
// tiles of depth 16 are staged in shared memory (A transposed, so a
// thread reads its 4 rows as one float4).  The ragged M, N and K edges are
// masked in the loads and the store, so the caller pads nothing.
//
// What bounds it.  On the main path (1x1 convs of YOLOv3-tiny, M = 169 or
// 676 at batch 1) the products are small: 12 to 44 blocks of 64x64 on 132
// SMs, so the card is mostly idle and launch latency dominates; at larger
// M the loop is bound by shared-memory loads (2 LDS.128 per 16 FMA).  fp32
// FMA on CUDA cores only: TF32 would miss the reference's 1e-4 tolerance.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;   // (BM / TM) * (BN / TN)

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

__global__ void __launch_bounds__(THREADS)
gemm_bias_act_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ bias, float* __restrict__ C,
                     int M, int N, int K, int act) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);          // column group
  const int ty = tid / (BN / TN);          // row group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Load mappings: each thread moves 4 elements of A and 4 of B per step.
  const int a_row = tid / (BK / 4);
  const int a_k = (tid % (BK / 4)) * 4;
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int gm = m0 + a_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_k + i;
      As[a_k + i][a_row] =
          (gm < M && gk < K) ? __ldg(A + (size_t)gm * K + gk) : 0.f;
    }
    const int gkb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + b_n + j;
      Bs[b_k][b_n + j] =
          (gkb < K && gn < N) ? __ldg(B + (size_t)gkb * N + gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const float v = acc[i][j] + (bias != nullptr ? __ldg(bias + gn) : 0.f);
      C[(size_t)gm * N + gn] = activate(v, act);
    }
  }
}

}  // namespace

// C = act(A @ B + bias); bias may be null.  Returns cudaGetLastError().
extern "C" int repro_gemm_bias_act(const float* A, const float* B,
                                   const float* bias, float* C, int M, int N,
                                   int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_act_kernel<<<grid, THREADS, 0, stream>>>(A, B, bias, C, M, N, K,
                                                     act);
  return static_cast<int>(cudaGetLastError());
}
