// bf16 and fp16 GEMM with a fused bias + activation epilogue, on the tensor
// cores of sm_90a (mma.sync m16n8k16, fp32 sums), with split-K.
//
// Replaces the 16-bit bodies of the TPU kernel
// src/repro/kernels/gemm/kernel.py::matmul_pallas: C = act(A @ B + bias),
// A (M, K) and B (K, N) row-major of one 16-bit type T, bias fp32, C of
// type T (the TPU kernel writes a.dtype).  The products of the 16-bit
// operands are summed in fp32, bias and activation act on the fp32 sum,
// which is rounded to T once, at the store.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries the fp32 accumulator in VMEM scratch across the K axis.  Here
// each block computes one 64x64 tile of C over one contiguous range of K
// with the shared 16-bit core, csrc/hmma16.cuh: 128 threads, A and B
// chunks of depth 32 staged by cp.async in a 3-stage ring, fragments by
// ldmatrix (B's transposed on the way), one barrier per chunk.  The ragged
// M, N and K edges are zero-filled by the copies; K must be a multiple of
// 8 (A's rows go as 16-byte copies), which the network plan's channel
// layout gives every 1x1 conv (kernels/conv_ops.py::in_channel_multiple).
//
// Split-K.  As the fp32 GEMM (gemm.cu): the grid is (M/64, N/64, splits),
// split s takes the 32-deep K chunks [s * n / splits, (s + 1) * n /
// splits) of the n = ceil(K / 32), `splits` from kernels/_splitk.py over
// this kernel's MIN_BLOCKS resident blocks.  With splits == 1 the kernel
// applies bias and activation and rounds; with splits > 1 each block
// writes its fp32 partial tile to the workspace (splits, M, N) and
// hgemm16_splitk_reduce_kernel sums the partials in split order (no
// atomics: bit-identical from run to run), then adds the bias, applies the
// activation and rounds to T.
//
// What bounds it.  2 bytes an operand value and 989 TFLOP/s of dense
// 16-bit products: the 1x1 convs of the paper's networks (K = 64 to 1024)
// have few FLOPs per byte, so the bound is mostly bytes (A read once, C
// written once); a call of a few chunks a block waits on its copies.
#include <cuda_runtime.h>

#include "hmma16.cuh"

namespace {

namespace hm = hmma16;

template <class T>
__global__ void __launch_bounds__(hm::THREADS, hm::MIN_BLOCKS)
hgemm16_bias_act_kernel(const T* __restrict__ A, const T* __restrict__ B,
                        const float* __restrict__ bias, T* __restrict__ C,
                        float* __restrict__ ws, int M, int N, int K, int act,
                        int splits) {
  __shared__ __align__(16) hm::Smem<T> sm;
  const int m0 = blockIdx.x * hm::BM;
  const int n0 = blockIdx.y * hm::BN;
  const int split = blockIdx.z;
  const int chunks = (K + hm::BK - 1) / hm::BK;
  hm::Acc acc;
  hm::tile(hm::operands(A, B, M, N, K), m0, n0, split * chunks / splits,
           (split + 1) * chunks / splits, sm, acc);

  // splits == 1: act(acc + bias) rounded into C; else the fp32 partial
  // sums into this split's slice of the workspace.
  float* part = ws + (size_t)split * M * N;
  hm::for_each_pair(acc, m0, n0, [&](int row, int col, float v0, float v1) {
    if (row >= M || col >= N) return;
    if (splits > 1) {
      hm::store_pair32(part, N, row, col, N, v0, v1);
      return;
    }
    v0 = hm::activate(v0 + (bias != nullptr ? __ldg(bias + col) : 0.f), act);
    if (col + 1 < N)
      v1 = hm::activate(v1 + (bias != nullptr ? __ldg(bias + col + 1) : 0.f),
                        act);
    hm::store_pair16(C, N, row, col, N, v0, v1);
  });
}

// C = act(sum over the splits of ws + bias) rounded to T, V consecutive
// elements per thread (V = 4 when N % 4 == 0), the splits summed in order.
template <class T, int V>
__global__ void __launch_bounds__(256)
hgemm16_splitk_reduce_kernel(const float* __restrict__ ws,
                             const float* __restrict__ bias,
                             T* __restrict__ C, size_t n, int N, int splits,
                             int act) {
  hm::splitk_reduce<T, V>(ws, bias, C, n, N, splits, act);
}

template <class T>
int launch(const T* A, const T* B, const float* bias, T* C, float* ws, int M,
           int N, int K, int act, int splits, cudaStream_t stream) {
  const dim3 grid((M + hm::BM - 1) / hm::BM, (N + hm::BN - 1) / hm::BN,
                  splits);
  hgemm16_bias_act_kernel<T><<<grid, hm::THREADS, 0, stream>>>(
      A, B, bias, C, ws, M, N, K, act, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)M * N;
  if (N % 4 == 0) {
    const unsigned blocks = static_cast<unsigned>((n / 4 + 255) / 256);
    hgemm16_splitk_reduce_kernel<T, 4><<<blocks, 256, 0, stream>>>(
        ws, bias, C, n, N, splits, act);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    hgemm16_splitk_reduce_kernel<T, 1><<<blocks, 256, 0, stream>>>(
        ws, bias, C, n, N, splits, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = act(A @ B + bias), A, B and C bf16 (dtype 0) or fp16 (dtype 1), bias
// fp32 or null.  K % 8 == 0 and A, C 16-byte aligned; 1 <= splits <=
// max(1, ceil(K / 32)); ws holds splits * M * N floats when splits > 1
// (else it may be null).  Returns cudaGetLastError().
extern "C" int repro_gemm16_bias_act(const void* A, const void* B,
                                     const float* bias, void* C, float* ws,
                                     int M, int N, int K, int act, int splits,
                                     int dtype, cudaStream_t stream) {
  const int chunks = (K + hm::BK - 1) / hm::BK;
  if (M < 1 || N < 1 || K < 0 || K % 8 != 0 || splits < 1 ||
      splits > (chunks > 1 ? chunks : 1) || (splits > 1 && ws == nullptr) ||
      (N + hm::BN - 1) / hm::BN > 65535 || splits > 65535 ||
      (reinterpret_cast<uintptr_t>(A) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(C) & 15) != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch(static_cast<const __nv_bfloat16*>(A),
                  static_cast<const __nv_bfloat16*>(B), bias,
                  static_cast<__nv_bfloat16*>(C), ws, M, N, K, act, splits,
                  stream);
  return launch(static_cast<const __half*>(A), static_cast<const __half*>(B),
                bias, static_cast<__half*>(C), ws, M, N, K, act, splits,
                stream);
}
