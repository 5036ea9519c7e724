// The 3-pass Winograd F(6x6, 3x3) fp32 pipeline for sm_90a: three kernels
// whose V and M intermediates go through device memory (paper §IV.B: input
// transform, the 64 per-position products as a batched GEMM, output
// transform).  The fused kernel (winograd_fused.cu) exists to avoid those
// round trips; this realization is what measure mode times it against.
//
// Layouts, as the TPU kernels' (position-major intermediates, channels
// minormost): tiles (T, 8, 8, C) -> V (64, T, C); V x U (64, C, O) ->
// M (64, T, O); M -> Y (T, 6, 6, O).  Every offset is computed in 64 bits.
//
// 1. winograd_input_transform_kernel replaces
//    src/repro/kernels/winograd/kernel.py::input_transform_pallas.
//    One thread per (tile, channel) pair, neighbouring threads on
//    neighbouring channels: it reads the pair's 8x8 patch (64 loads, each
//    coalesced across the warp), applies B^T d B separably in registers,
//    and writes the 64 values of V, each store coalesced too.  Bound by
//    bytes: 2048 FLOPs against 512 bytes moved per pair, well under the
//    card's fp32 ratio of 20 FLOP per byte.
//
// 2. winograd_tuple_multiply_kernel replaces
//    src/repro/kernels/winograd/kernel.py::tuple_multiply_pallas.
//    A batched SGEMM, blockIdx.z = position: the TPU kernel carries its
//    (bt, bo) accumulator in VMEM across a sequential C grid axis; here the
//    C axis is a loop inside the block and each of 256 threads keeps a 4x4
//    micro-tile of the block's 64x64 (tiles x out channels) tile in
//    registers, with depth-16 slices of V (transposed) and U staged in
//    shared memory, as gemm.cu does.  Ragged T, C and O are masked in the
//    loads and the store, so nothing is padded to a block multiple.  At
//    VGG-16's 56x56 layers (T = 100, O = 256) that is 2 x 4 x 64 = 512
//    blocks for 132 SMs, where one GEMM of the 64 products folded into
//    one could not fill the card.  Bound by operations at VGG's widths;
//    the loop is limited by shared-memory loads (2 LDS.128 per 16 FMA).
//    fp32 FMA on CUDA cores only.
//
// 3. winograd_output_transform_kernel replaces
//    src/repro/kernels/winograd/kernel.py::output_transform_pallas (both
//    bodies).  One thread per (tile, out channel) pair, neighbouring
//    threads on neighbouring out channels: it reads the pair's 64 values of
//    M (each load coalesced), applies A^T M A in registers, adds the bias
//    and the activation, and writes the 6x6 outputs (each store
//    coalesced).  Bound by bytes: 1344 FLOPs against 400 bytes per pair.
#include <cuda_runtime.h>

#include "winograd_transforms.cuh"

namespace {

constexpr int THREADS = 256;

// Tuple multiply tile: 64 tiles x 64 out channels per block, C steps of 16.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;

__global__ void __launch_bounds__(THREADS)
winograd_input_transform_kernel(const float* __restrict__ tiles,
                                float* __restrict__ V, int T, int C) {
  const size_t tc = (size_t)T * C;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;  // t*C + c
  if (idx >= tc) return;
  const size_t t = idx / C;
  const size_t c = idx - t * C;
  const float* d = tiles + t * 64 * C + c;

  // Rows: r[i][b] = sum_j BT[b][j] d[i][j].
  float r[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float row[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = __ldg(d + (size_t)(i * 8 + j) * C);
    winograd::bt_apply(row, r[i]);
  }
  // Columns: V[a][b] = sum_i BT[a][i] r[i][b], stored at V[8a + b][t][c].
  float* v = V + idx;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    float col[8], out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) col[i] = r[i][b];
    winograd::bt_apply(col, out);
#pragma unroll
    for (int a = 0; a < 8; ++a) v[(size_t)(a * 8 + b) * tc] = out[a];
  }
}

__global__ void __launch_bounds__(THREADS)
winograd_tuple_multiply_kernel(const float* __restrict__ V,
                               const float* __restrict__ U,
                               float* __restrict__ M, int T, int C, int O) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const size_t p = blockIdx.z;
  const float* A = V + p * T * C;         // (T, C) of position p
  const float* B = U + p * C * O;         // (C, O)
  float* Mp = M + p * T * O;              // (T, O)

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);         // out-channel group
  const int ty = tid / (BN / TN);         // tile group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Load mappings: each thread moves 4 elements of V and 4 of U per step.
  const int a_row = tid / (BK / 4);
  const int a_k = (tid % (BK / 4)) * 4;
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    const int gm = m0 + a_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_k + i;
      As[a_k + i][a_row] =
          (gm < T && gk < C) ? __ldg(A + (size_t)gm * C + gk) : 0.f;
    }
    const int gkb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + b_n + j;
      Bs[b_k][b_n + j] =
          (gkb < C && gn < O) ? __ldg(B + (size_t)gkb * O + gn) : 0.f;
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
    if (gm >= T) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < O) Mp[(size_t)gm * O + gn] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
winograd_output_transform_kernel(const float* __restrict__ M,
                                 const float* __restrict__ bias,
                                 float* __restrict__ Y, int T, int O,
                                 int act) {
  const size_t to = (size_t)T * O;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;  // t*O + o
  if (idx >= to) return;
  const size_t t = idx / O;
  const size_t o = idx - t * O;
  float m[64];
#pragma unroll
  for (int p = 0; p < 64; ++p) m[p] = __ldg(M + (size_t)p * to + idx);
  winograd::output_tile(m, bias != nullptr ? __ldg(bias + o) : 0.f, act,
                        Y + t * 36 * O + o, O);
}

unsigned int blocks_for(size_t n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

// V (8, 8, T, C) = B^T d B for tiles (T, 8, 8, C).  Returns
// cudaGetLastError().
extern "C" int repro_winograd_input_transform(const float* tiles, float* V,
                                              int T, int C,
                                              cudaStream_t stream) {
  if (T < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  winograd_input_transform_kernel<<<blocks_for((size_t)T * C), THREADS, 0,
                                    stream>>>(tiles, V, T, C);
  return static_cast<int>(cudaGetLastError());
}

// M[p] = V[p] @ U[p] for V (64, T, C), U (64, C, O) -> M (64, T, O).
// Returns cudaGetLastError().
extern "C" int repro_winograd_tuple_multiply(const float* V, const float* U,
                                             float* M, int T, int C, int O,
                                             cudaStream_t stream) {
  if (T < 1 || C < 1 || O < 1 || (T + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM, 64);
  winograd_tuple_multiply_kernel<<<grid, THREADS, 0, stream>>>(V, U, M, T, C,
                                                               O);
  return static_cast<int>(cudaGetLastError());
}

// Y (T, 6, 6, O) = act(A^T M A + bias) for M (8, 8, T, O); bias may be
// null.  Returns cudaGetLastError().
extern "C" int repro_winograd_output_transform(const float* M,
                                               const float* bias, float* Y,
                                               int T, int O, int act,
                                               cudaStream_t stream) {
  if (T < 1 || O < 1) return static_cast<int>(cudaErrorInvalidValue);
  winograd_output_transform_kernel<<<blocks_for((size_t)T * O), THREADS, 0,
                                     stream>>>(M, bias, Y, T, O, act);
  return static_cast<int>(cudaGetLastError());
}
