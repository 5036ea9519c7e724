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
//    A batched fp32 GEMM, blockIdx.z = position: the TPU kernel carries
//    its (bt, bo) accumulator in VMEM across a sequential C grid axis;
//    here each block computes one 64x64 (tiles x out channels) tile of
//    one position over all of C with the shared tensor-core core,
//    csrc/sgemm_3xtf32.cuh (3xTF32 mma.sync m16n8k8, fp32 accuracy;
//    depth-16 slices of V and U staged by cp.async in a 3-stage ring, one
//    barrier per slice).  Ragged T, C and O are zero-filled by the copies
//    and masked in the store, so nothing is padded to a block multiple
//    (VGG-16's first layer has C = 8: one k8 step, half of each 16-deep
//    slice zero-filled).  At VGG-16's widths the grid is 512 to 1472
//    blocks of 128 threads for 132 SMs, so no K split is needed.  Bound by
//    the bytes of V, U and M (each read or written once) at every VGG-16
//    layer once the products run at 165 TFLOP/s of fp32-accurate work
//    (three TF32 products each); the two correction products take 5 % of
//    the time at C = 8 and 64 and 37 % at C = 256 (a variant without them
//    in scripts/sgemm_tc_variants.py), where mma.sync's rate is what
//    holds the deep layers back.
//
// 3. winograd_output_transform_kernel replaces
//    src/repro/kernels/winograd/kernel.py::output_transform_pallas (both
//    bodies).  One thread per (tile, out channel) pair, neighbouring
//    threads on neighbouring out channels: it reads the pair's 64 values of
//    M (each load coalesced), applies A^T M A in registers, adds the bias
//    and the activation, and writes the 6x6 outputs (each store
//    coalesced).  Bound by bytes: 1344 FLOPs against 400 bytes per pair.
#include <cuda_runtime.h>

#include "describe.cuh"
#include "sgemm_3xtf32.cuh"
#include "winograd_transforms.cuh"

namespace {

constexpr int THREADS = 256;   // the two transforms

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

// Tuple multiply: 64 tiles x 64 out channels of one position per block.
__global__ void __launch_bounds__(sgemm_tc::THREADS, sgemm_tc::MIN_BLOCKS)
winograd_tuple_multiply_kernel(const float* __restrict__ V,
                               const float* __restrict__ U,
                               float* __restrict__ M, int T, int C, int O) {
  using namespace sgemm_tc;
  __shared__ __align__(16) Smem sm;
  const size_t p = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  Acc acc;
  // V[p] (T, C) . U[p] (C, O) over all of C.
  tile(operands(V + p * T * C, U + p * C * O, T, O, C), m0, n0, 0,
       (C + BK - 1) / BK, sm, acc);
  float* Mp = M + p * T * O;
  for_each_pair(acc, m0, n0, [&](int row, int col, float v0, float v1) {
    if (row < T) store_pair(Mp, O, row, col, O, v0, v1);
  });
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

// The three kernels' launches: a thread a (tile, channel) pair for the
// input transform, a 64 x 64 tile of one position's product a block for
// the tuple multiply, a thread a (tile, out channel) pair for the output
// transform.
describe::Launch plan_input(int T, int C) {
  describe::Launch l;
  l.grid = dim3(blocks_for((size_t)T * C), 1, 1);
  l.threads = THREADS;
  l.func = (const void*)&winograd_input_transform_kernel;
  return l;
}

describe::Launch plan_tuple(int T, int O) {
  describe::Launch l;
  l.grid = dim3((T + sgemm_tc::BM - 1) / sgemm_tc::BM,
                (O + sgemm_tc::BN - 1) / sgemm_tc::BN, 64);
  l.threads = sgemm_tc::THREADS;
  l.stages = sgemm_tc::STAGES;
  l.func = (const void*)&winograd_tuple_multiply_kernel;
  return l;
}

describe::Launch plan_output(int T, int O) {
  describe::Launch l;
  l.grid = dim3(blocks_for((size_t)T * O), 1, 1);
  l.threads = THREADS;
  l.func = (const void*)&winograd_output_transform_kernel;
  return l;
}

}  // namespace

// V (8, 8, T, C) = B^T d B for tiles (T, 8, 8, C).  Returns
// cudaGetLastError().
extern "C" int repro_winograd_input_transform(const float* tiles, float* V,
                                              int T, int C,
                                              cudaStream_t stream) {
  if (T < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const describe::Launch l = plan_input(T, C);
  winograd_input_transform_kernel<<<l.grid, l.threads, 0, stream>>>(tiles, V,
                                                                    T, C);
  return static_cast<int>(cudaGetLastError());
}

// M[p] = V[p] @ U[p] for V (64, T, C), U (64, C, O) -> M (64, T, O).
// Returns cudaGetLastError().
extern "C" int repro_winograd_tuple_multiply(const float* V, const float* U,
                                             float* M, int T, int C, int O,
                                             cudaStream_t stream) {
  using sgemm_tc::BN;
  if (T < 1 || C < 1 || O < 1 || (O + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const describe::Launch l = plan_tuple(T, O);
  winograd_tuple_multiply_kernel<<<l.grid, l.threads, 0, stream>>>(
      V, U, M, T, C, O);
  return static_cast<int>(cudaGetLastError());
}

// Y (T, 6, 6, O) = act(A^T M A + bias) for M (8, 8, T, O); bias may be
// null.  Returns cudaGetLastError().
extern "C" int repro_winograd_output_transform(const float* M,
                                               const float* bias, float* Y,
                                               int T, int O, int act,
                                               cudaStream_t stream) {
  if (T < 1 || O < 1) return static_cast<int>(cudaErrorInvalidValue);
  const describe::Launch l = plan_output(T, O);
  winograd_output_transform_kernel<<<l.grid, l.threads, 0, stream>>>(
      M, bias, Y, T, O, act);
  return static_cast<int>(cudaGetLastError());
}

// What the three entries launch, as describe.cuh lays it out: the input
// transform (which 0, args = (T, C)), the tuple multiply (which 1, args =
// (T, C, O)) or the output transform (which 2, args = (T, O)).
extern "C" int repro_winograd_3pass_describe(const int* args, int nargs,
                                             int which, long long* out) {
  const int want = which == 1 ? 3 : 2;
  if (which < 0 || which > 2 || nargs != want || args[0] < 1 ||
      args[nargs - 1] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const describe::Launch l = which == 0   ? plan_input(args[0], args[1])
                             : which == 1 ? plan_tuple(args[0], args[2])
                                          : plan_output(args[0], args[1]);
  return describe::write(l, out);
}
