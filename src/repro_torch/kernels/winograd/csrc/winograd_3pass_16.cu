// The 3-pass Winograd F(6x6, 3x3) pipeline in bf16 and fp16 for sm_90a:
// three kernels whose V and M intermediates go through device memory in
// the 16-bit type, as the TPU kernels store them (out_shape in tiles.dtype
// and v.dtype).  The fp32 pipeline is winograd_3pass.cu; this file keeps
// its layouts, with 16-bit loads and stores around the fp32 transform
// arithmetic of the fused kernels (winograd16_transforms.cuh).
//
// Layouts: tiles (T, 8, 8, C) -> V (64, T, C); V x U (64, C, O) -> M (64,
// T, O); M -> Y (T, 6, 6, O), all of one 16-bit type; bias fp32.
//
// 1. winograd16_input_transform_kernel replaces the 16-bit body of
//    src/repro/kernels/winograd/kernel.py::input_transform_pallas.
//    One thread per (tile, channel) pair, neighbouring threads on
//    neighbouring channels: it reads the pair's 8x8 patch, applies B^T d B
//    in fp32 registers, and writes the 64 values of V rounded to T.  Bound
//    by bytes (256 read and written a pair).
//
// 2. winograd16_tuple_multiply_kernel replaces the 16-bit body of
//    src/repro/kernels/winograd/kernel.py::tuple_multiply_pallas.
//    A batched GEMM, blockIdx.z = position, each block one 64x64 (tiles x
//    out channels) tile of one position over all of C on the 16-bit GEMM
//    core, csrc/hmma16.cuh (mma.sync m16n8k16, fp32 sums), M rounded to T
//    at the store.  U comes split (core/winograd.py::split_transformed):
//    hi and lo parts of U[p] * 2^k[p], so the core takes B in two parts
//    (PARTS = 2: V.Uhi + V.Ulo, about 16 significant bits of U in bf16, 22
//    in fp16, where U rounded to T costs F(6,3) several percent of the
//    output), and the sum is scaled back by 2^-k[p] (exact) before the
//    rounding.  The TPU kernel multiplies V in T by U in fp32.  Ragged T,
//    C and O are zero-filled by the copies and masked in the store (C % 8
//    == 0: V's rows go as 16-byte copies).  Bound by the bytes of V, U
//    and M at VGG-16's widths.
//
// 3. winograd16_output_transform_kernel replaces the 16-bit body of
//    src/repro/kernels/winograd/kernel.py::output_transform_pallas.  One
//    thread per (tile, out channel) pair: it reads the pair's 64 values of
//    M, applies A^T M A in fp32, adds the bias and the activation, and
//    writes the 6x6 outputs rounded to T.  Bound by bytes.
#include <cuda_runtime.h>

#include "hmma16.cuh"
#include "winograd16_transforms.cuh"

namespace {

namespace hm = hmma16;

constexpr int THREADS = 256;   // the two transforms

template <class T>
__global__ void __launch_bounds__(THREADS)
winograd16_input_transform_kernel(const T* __restrict__ tiles,
                                  T* __restrict__ V, int T_, int C) {
  const size_t tc = (size_t)T_ * C;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;  // t*C + c
  if (idx >= tc) return;
  const size_t t = idx / C;
  const size_t c = idx - t * C;
  const T* d = tiles + t * 64 * C + c;

  // Rows: r[i][b] = sum_j BT[b][j] d[i][j].
  float r[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float row[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = hm::to_f32(d[(size_t)(i * 8 + j) * C]);
    winograd16::bt8(row, r[i]);
  }
  // Columns: V[a][b] = sum_i BT[a][i] r[i][b], stored at V[8a + b][t][c].
  T* v = V + idx;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    float col[8], out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) col[i] = r[i][b];
    winograd16::bt8(col, out);
#pragma unroll
    for (int a = 0; a < 8; ++a)
      v[(size_t)(a * 8 + b) * tc] = hm::from_f32<T>(out[a]);
  }
}

// Tuple multiply: 64 tiles x 64 out channels of one position per block;
// U is (2, 64, C, O), hi then lo, and inv_scale (64,) the powers of two
// that undo its scaling.
template <class T>
__global__ void __launch_bounds__(hm::THREADS, hm::MIN_BLOCKS)
winograd16_tuple_multiply_kernel(const T* __restrict__ V,
                                 const T* __restrict__ U,
                                 const float* __restrict__ inv_scale,
                                 T* __restrict__ M, int T_, int C, int O) {
  __shared__ __align__(16) hm::Smem<T, 2> sm;
  const size_t p = blockIdx.z;
  const int m0 = blockIdx.x * hm::BM;
  const int n0 = blockIdx.y * hm::BN;
  hm::Acc acc;
  // V[p] (T, C) . (U hi[p] + U lo[p]) (C, O) over all of C.
  hm::tile(hm::operands(V + p * T_ * C, U + p * C * O, T_, O, C,
                        (size_t)64 * C * O),
           m0, n0, 0, (C + hm::BK - 1) / hm::BK, sm, acc);
  const float s = __ldg(inv_scale + p);
  T* Mp = M + p * T_ * O;
  hm::for_each_pair(acc, m0, n0, [&](int row, int col, float v0, float v1) {
    if (row < T_) hm::store_pair16(Mp, O, row, col, O, v0 * s, v1 * s);
  });
}

template <class T>
__global__ void __launch_bounds__(THREADS)
winograd16_output_transform_kernel(const T* __restrict__ M,
                                   const float* __restrict__ bias,
                                   T* __restrict__ Y, int T_, int O,
                                   int act) {
  const size_t to = (size_t)T_ * O;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;  // t*O + o
  if (idx >= to) return;
  const size_t t = idx / O;
  const size_t o = idx - t * O;
  // Columns first, then rows, M read a column at a time.
  float tmp[6][8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    float col[8], r[6];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      col[a] = hm::to_f32(M[(size_t)(a * 8 + b) * to + idx]);
    winograd16::at8(col, r);
#pragma unroll
    for (int x = 0; x < 6; ++x) tmp[x][b] = r[x];
  }
  const float bv = bias != nullptr ? __ldg(bias + o) : 0.f;
  T* dst = Y + t * 36 * O + o;
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    float r[6];
    winograd16::at8(tmp[x], r);
#pragma unroll
    for (int y = 0; y < 6; ++y)
      dst[(size_t)(x * 6 + y) * O] =
          hm::from_f32<T>(hm::activate(r[y] + bv, act));
  }
}

unsigned int blocks_for(size_t n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

bool bad_dtype(int dtype) { return dtype != 0 && dtype != 1; }

}  // namespace

// V (8, 8, T, C) = B^T d B for tiles (T, 8, 8, C), bf16 (dtype 0) or fp16
// (dtype 1), in fp32, V rounded.  Returns cudaGetLastError().
extern "C" int repro_winograd16_input_transform(const void* tiles, void* V,
                                                int T, int C, int dtype,
                                                cudaStream_t stream) {
  if (T < 1 || C < 1 || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = blocks_for((size_t)T * C);
  if (dtype == 0)
    winograd16_input_transform_kernel<__nv_bfloat16><<<grid, THREADS, 0,
                                                       stream>>>(
        static_cast<const __nv_bfloat16*>(tiles),
        static_cast<__nv_bfloat16*>(V), T, C);
  else
    winograd16_input_transform_kernel<__half><<<grid, THREADS, 0, stream>>>(
        static_cast<const __half*>(tiles), static_cast<__half*>(V), T, C);
  return static_cast<int>(cudaGetLastError());
}

// M[p] = V[p] @ (U hi[p] + U lo[p]) * inv_scale[p] for V (64, T, C), U
// (2, 64, C, O) -> M (64, T, O), of one 16-bit type, M rounded; inv_scale
// (64,) fp32.  C % 8 == 0 and V 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int repro_winograd16_tuple_multiply(const void* V, const void* U,
                                               const float* inv_scale,
                                               void* M, int T, int C, int O,
                                               int dtype,
                                               cudaStream_t stream) {
  if (T < 1 || C < 8 || C % 8 != 0 || O < 1 ||
      (O + hm::BN - 1) / hm::BN > 65535 ||
      (reinterpret_cast<uintptr_t>(V) & 15) != 0 || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + hm::BM - 1) / hm::BM, (O + hm::BN - 1) / hm::BN, 64);
  if (dtype == 0)
    winograd16_tuple_multiply_kernel<__nv_bfloat16><<<grid, hm::THREADS, 0,
                                                      stream>>>(
        static_cast<const __nv_bfloat16*>(V),
        static_cast<const __nv_bfloat16*>(U), inv_scale,
        static_cast<__nv_bfloat16*>(M), T, C, O);
  else
    winograd16_tuple_multiply_kernel<__half><<<grid, hm::THREADS, 0,
                                               stream>>>(
        static_cast<const __half*>(V), static_cast<const __half*>(U),
        inv_scale, static_cast<__half*>(M), T, C, O);
  return static_cast<int>(cudaGetLastError());
}

// Y (T, 6, 6, O) = act(A^T M A + bias) for M (8, 8, T, O), of one 16-bit
// type, in fp32, Y rounded; bias fp32 or null.  Returns cudaGetLastError().
extern "C" int repro_winograd16_output_transform(const void* M,
                                                 const float* bias, void* Y,
                                                 int T, int O, int act,
                                                 int dtype,
                                                 cudaStream_t stream) {
  if (T < 1 || O < 1 || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = blocks_for((size_t)T * O);
  if (dtype == 0)
    winograd16_output_transform_kernel<__nv_bfloat16><<<grid, THREADS, 0,
                                                        stream>>>(
        static_cast<const __nv_bfloat16*>(M), bias,
        static_cast<__nv_bfloat16*>(Y), T, O, act);
  else
    winograd16_output_transform_kernel<__half><<<grid, THREADS, 0, stream>>>(
        static_cast<const __half*>(M), bias, static_cast<__half*>(Y), T, O,
        act);
  return static_cast<int>(cudaGetLastError());
}
