// Blocked int8 GEMM with int32 accumulation and a fused fp32 dequant +
// bias + activation epilogue, for sm_90a.
//
// Replaces the int8 bodies of the TPU kernel
// src/repro/kernels/gemm/kernel.py::matmul_pallas
// (_matmul_q8_{,bias_}kernel_{6loop,3loop}, :107-137):
// C = act(float(A_q @ B_q) * scale + bias), A_q (M, K) and B_q (K, N)
// row-major int8, scale and bias (N,) fp32, C (M, N) fp32.
//
// Design.  The fp32 kernel's tiling (gemm.cu): the TPU kernel's sequential
// K grid axis, which carries an int32 VMEM accumulator, becomes a loop
// inside the block, with the 64x64 int32 accumulator in registers (a 4x4
// micro-tile per thread, 256 threads).  Each step stages a 64x32 tile of A
// and a 32x64 tile of B in shared memory as 32-bit words of 4 int8 values
// consecutive in K, A by 16-byte loads (K % 16 == 0), B by byte loads
// packed in registers (B's rows are N bytes apart and N is any width,
// 255 for the detection heads).  The inner product is __dp4a: 4
// multiply-adds of signed bytes into an int32 per instruction, exact.  The
// ragged M, N and K edges are masked with zeros.  The epilogue converts
// the sum once, multiplies by scale and adds bias with the rounding of
// each operation kept (no FMA contraction), as the reference's
// _dequant_epilogue does, then applies the activation.
//
// What bounds it.  On the main path (YOLOv3-tiny's 1x1 convs at batch 1,
// M = 169) the products are small: 8 to 16 blocks on 132 SMs, so the card
// is mostly idle and latency bounds it.  At larger M the loop is bound by
// shared-memory loads (2 LDS.128 per 16 dp4a) and by dp4a's issue rate on
// the CUDA cores; the int8 tensor cores (mma / wgmma) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;          // int8 values of K per step
constexpr int BK4 = BK / 4;     // packed words of K per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;    // (BM / TM) * (BN / TN)

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)(uint8_t)a | ((int)(uint8_t)b << 8) | ((int)(uint8_t)c << 16) |
         ((int)(uint8_t)d << 24);
}

__global__ void __launch_bounds__(THREADS)
gemm_q8_bias_act_kernel(const int8_t* __restrict__ A,
                        const int8_t* __restrict__ B,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float* __restrict__ C,
                        int M, int N, int K, int act) {
  __shared__ __align__(16) int As[BK4][BM];   // As[k4][m]: A[m][4k4..4k4+3]
  __shared__ __align__(16) int Bs[BK4][BN];   // Bs[k4][n]: B[4k4..4k4+3][n]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A: threads 0..127 each move 16 bytes (row a_row, words a_k4..a_k4+3).
  const int a_row = (tid % 128) / 2;
  const int a_k4 = (tid % 2) * 4;
  // B: each thread packs 2 words: K rows 4*b_k4..+3 of columns b_n, b_n+1.
  const int b_k4 = tid / 32;
  const int b_n = (tid % 32) * 2;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < 128) {
      const int gm = m0 + a_row;
      const int gk = k0 + a_k4 * 4;
      int4 v = make_int4(0, 0, 0, 0);
      if (gm < M && gk < K)   // K % 16 == 0: the 16 bytes are all in or out
        v = __ldg(reinterpret_cast<const int4*>(A + (size_t)gm * K + gk));
      As[a_k4 + 0][a_row] = v.x;
      As[a_k4 + 1][a_row] = v.y;
      As[a_k4 + 2][a_row] = v.z;
      As[a_k4 + 3][a_row] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gn = n0 + b_n + j;
      int8_t q[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gk = k0 + 4 * b_k4 + r;
        q[r] = (gk < K && gn < N) ? __ldg(B + (size_t)gk * N + gn) : 0;
      }
      Bs[b_k4][b_n + j] = pack4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK4; ++kk) {
      const int4 a = *reinterpret_cast<const int4*>(&As[kk][ty * TM]);
      const int4 b = *reinterpret_cast<const int4*>(&Bs[kk][tx * TN]);
      const int av[TM] = {a.x, a.y, a.z, a.w};
      const int bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
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
      float v = __fmul_rn(__int2float_rn(acc[i][j]), __ldg(scale + gn));
      if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + gn));
      C[(size_t)gm * N + gn] = activate(v, act);
    }
  }
}

}  // namespace

// C = act(float(A_q @ B_q) * scale + bias); K % 16 == 0, A 16-byte aligned;
// bias may be null.  Returns cudaGetLastError().
extern "C" int repro_gemm_q8_bias_act(const int8_t* A, const int8_t* B,
                                      const float* scale, const float* bias,
                                      float* C, int M, int N, int K, int act,
                                      cudaStream_t stream) {
  if (K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_q8_bias_act_kernel<<<grid, THREADS, 0, stream>>>(A, B, scale, bias, C,
                                                        M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}
