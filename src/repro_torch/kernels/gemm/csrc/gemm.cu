// fp32 GEMM with a fused bias + activation epilogue, on the tensor cores of
// sm_90a (3xTF32), with split-K.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py::matmul_pallas
// (fp32 bodies): C = act(A @ B + bias), A (M, K) and B (K, N) row-major.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries the fp32 accumulator in VMEM scratch across the K axis.  Here
// each block computes one 64x64 tile of C over one contiguous range of K
// with the shared core, csrc/sgemm_3xtf32.cuh: 128 threads, mma.sync
// m16n8k8 TF32 with each operand split into hi and lo parts (three
// products per fp32 product, fp32 accuracy), A and B chunks of depth 16
// staged by cp.async in a 3-stage ring with one barrier per chunk.  The
// ragged M, N and K edges are zero-filled by the copies, so the caller
// pads nothing; rows that are not a multiple of 4 floats (N = 255, K = 37)
// go as 4-byte copies.
//
// Split-K.  At batch 1 the 1x1 convs of YOLOv3-tiny 416 are 169 or 676
// rows: 6 to 44 tiles of 64x64 for 132 SMs.  The grid is (M/64, N/64,
// splits): split s takes the 16-deep K chunks [s * n / splits, (s + 1) *
// n / splits) of the n = ceil(K / 16); the wrapper picks `splits` from the
// shape (kernels/_splitk.py::split_k over this kernel's 4 resident blocks
// a SM).  With splits == 1 the kernel applies bias and activation itself;
// with splits > 1 each block writes its partial tile to the workspace
// (splits, M, N) and gemm_splitk_reduce_kernel sums the partials in split
// order (no atomics: bit-identical from run to run), then adds the bias
// and applies the activation.
//
// What bounds it.  The work is 3 TF32 products per fp32 product, at most
// 495 / 3 = 165 TFLOP/s of fp32-accurate products; the 1x1 convs of the
// paper's networks have K = 64 to 1024, few FLOPs per byte, so the bound
// is mostly bytes (A read once, C written once).  Leaving out the two
// correction products (plain TF32, which fails the gate) saves only 1-14 %
// of a call's time (scripts/sgemm_tc_variants.py on the H100): the calls
// wait on their operands' copies, a block running 1 to 8 chunks with two
// in flight, and a split call also on the reduce launch.
#include <cuda_runtime.h>

#include "describe.cuh"
#include "sgemm_3xtf32.cuh"

namespace {

namespace tc = sgemm_tc;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

__global__ void __launch_bounds__(tc::THREADS, tc::MIN_BLOCKS)
gemm_bias_act_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ bias, float* __restrict__ C,
                     float* __restrict__ ws, int M, int N, int K, int act,
                     int splits) {
  __shared__ __align__(16) tc::Smem sm;
  const int m0 = blockIdx.x * tc::BM;
  const int n0 = blockIdx.y * tc::BN;
  const int split = blockIdx.z;
  const int chunks = (K + tc::BK - 1) / tc::BK;
  tc::Acc acc;
  tc::tile(tc::operands(A, B, M, N, K), m0, n0, split * chunks / splits,
           (split + 1) * chunks / splits, sm, acc);

  // splits == 1: act(acc + bias) into C; else the partial sums into this
  // split's slice of the workspace.
  float* dst = splits == 1 ? C : ws + (size_t)split * M * N;
  tc::for_each_pair(acc, m0, n0, [&](int row, int col, float v0, float v1) {
    if (row >= M || col >= N) return;
    if (splits == 1) {
      v0 = activate(v0 + (bias != nullptr ? __ldg(bias + col) : 0.f), act);
      if (col + 1 < N)
        v1 = activate(v1 + (bias != nullptr ? __ldg(bias + col + 1) : 0.f),
                      act);
    }
    tc::store_pair(dst, N, row, col, N, v0, v1);
  });
}

// C = act(sum over the splits of ws + bias), V consecutive elements per
// thread (V = 4 when N % 4 == 0), the splits summed in order.
template <int V>
__global__ void __launch_bounds__(256)
gemm_splitk_reduce_kernel(const float* __restrict__ ws,
                          const float* __restrict__ bias,
                          float* __restrict__ C, size_t n, int N, int splits,
                          int act) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float* src = ws + p * n + i;
    if (V == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src));
      s[0] += t.x; s[1] += t.y; s[2] += t.z; s[3] += t.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += __ldg(src + e);
    }
  }
  const int col = static_cast<int>(i % N);
#pragma unroll
  for (int e = 0; e < V; ++e)
    C[i + e] =
        activate(s[e] + (bias != nullptr ? __ldg(bias + col + e) : 0.f), act);
}

// The GEMM kernel's launch for an M x N product cut into `splits`.
describe::Launch plan_gemm(int M, int N, int splits) {
  describe::Launch l;
  l.grid = dim3((M + tc::BM - 1) / tc::BM, (N + tc::BN - 1) / tc::BN, splits);
  l.threads = tc::THREADS;
  l.stages = tc::STAGES;
  l.func = (const void*)&gemm_bias_act_kernel;
  return l;
}

// The reduce's launch over the M x N output.
describe::Launch plan_reduce(int M, int N) {
  return describe::reduce((size_t)M * N, N,
                          (const void*)&gemm_splitk_reduce_kernel<4>,
                          (const void*)&gemm_splitk_reduce_kernel<1>);
}

}  // namespace

// C = act(A @ B + bias); bias may be null.  1 <= splits <= max(1,
// ceil(K / 16)); ws holds splits * M * N floats when splits > 1 (else it
// may be null).  Returns cudaGetLastError().
extern "C" int repro_gemm_bias_act(const float* A, const float* B,
                                   const float* bias, float* C, float* ws,
                                   int M, int N, int K, int act, int splits,
                                   cudaStream_t stream) {
  const int chunks = (K + tc::BK - 1) / tc::BK;
  if (M < 1 || N < 1 || K < 0 || splits < 1 ||
      splits > (chunks > 1 ? chunks : 1) || (splits > 1 && ws == nullptr) ||
      (N + tc::BN - 1) / tc::BN > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const describe::Launch kern = plan_gemm(M, N, splits);
  gemm_bias_act_kernel<<<kern.grid, kern.threads, 0, stream>>>(
      A, B, bias, C, ws, M, N, K, act, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)M * N;
  const describe::Launch red = plan_reduce(M, N);
  if (N % 4 == 0)
    gemm_splitk_reduce_kernel<4><<<red.grid, red.threads, 0, stream>>>(
        ws, bias, C, n, N, splits, act);
  else
    gemm_splitk_reduce_kernel<1><<<red.grid, red.threads, 0, stream>>>(
        ws, bias, C, n, N, splits, act);
  return static_cast<int>(cudaGetLastError());
}

// What repro_gemm_bias_act launches for args = (M, N, K, splits): the GEMM
// kernel (which 0) or the reduce (which 1), as describe.cuh lays it out.
extern "C" int repro_gemm_describe(const int* args, int nargs, int which,
                                   long long* out) {
  if (nargs != 4 || which < 0 || which > 1 || args[0] < 1 || args[1] < 1 ||
      args[3] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return describe::write(which == 0 ? plan_gemm(args[0], args[1], args[3])
                                    : plan_reduce(args[0], args[1]),
                         out);
}
