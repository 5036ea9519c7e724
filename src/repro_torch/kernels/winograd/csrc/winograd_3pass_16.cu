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
//    src/repro/kernels/winograd/kernel.py::tuple_multiply_pallas:
//    M[p] = V[p] (T, C) . U[p] (C, O), 64 small GEMMs.  U comes split
//    (core/winograd.py::split_transformed): hi and lo parts of U[p] *
//    2^k[p], both multiplied into one fp32 sum (V.Uhi + V.Ulo: about 16
//    significant bits of U in bf16, 22 in fp16, where U rounded to T costs
//    F(6,3) several percent of the output), scaled back by 2^-k[p]
//    (exact) and rounded to T once.  The TPU kernel multiplies V in T by
//    U in fp32.
//
//    Design.  Persistent blocks (3, 2 and 1 a SM at N = 64, 128, 256) walk
//    the work items (position p, a slab of 64 tiles, an N-wide block of out
//    channels, N = 64, 128 or 256 by O: all of O up to 256, so V is read
//    once), items of one position next to each other so its U is read
//    from L2 by the blocks after the first.  In a block one producer warp
//    keeps TMA copies in flight through a ring of stages (each 64 channels:
//    the V slab, 64 x 64, and U's hi and lo rows, 64 x N each, 128-byte
//    rows with the 128-byte swizzle; a "full" and an "empty" mbarrier a
//    stage), across item boundaries, so one item's epilogue overlaps the
//    next item's copies (and its stores, from one of two staging buffers
//    but at N = 128, the next item's products).  One consumer warpgroup
//    runs wgmma m64nNk16 (A =
//    the V slab, K-major; B = U, MN-major as it lies in device memory;
//    csrc wgmma16.cuh), both parts into the same accumulator, 8 products a
//    stage; the epilogue scales by 2^-k[p], rounds, stages M in shared
//    memory (swizzled 128-byte rows) and writes it by TMA stores (the
//    edges past T and O clipped by the copy engine).  Ragged T, C and O
//    are zero-filled by the copies; C % 8 == 0 and O % 8 == 0 (TMA's
//    16-byte strides; the wrapper pads O).  Bound by the bytes of V, U
//    and M at VGG-16's widths.
//
// 3. winograd16_output_transform_kernel replaces the 16-bit body of
//    src/repro/kernels/winograd/kernel.py::output_transform_pallas.  One
//    thread per (tile, out channel) pair: it reads the pair's 64 values of
//    M, applies A^T M A in fp32, adds the bias and the activation, and
//    writes the 6x6 outputs rounded to T.  Bound by bytes.
#include <cuda_runtime.h>

#include "describe.cuh"
#include "hmma16.cuh"
#include "hopper_async.cuh"
#include "per_device.cuh"
#include "wgmma16.cuh"
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

// Tuple multiply: the compiled tile of one work item, 64 tiles x TM_BK
// channels a stage, N out channels (a template parameter).
constexpr int TM_BM = 64;             // tiles per item (wgmma's M)
constexpr int TM_BK = 64;             // channels per stage (128-byte rows)
constexpr int TM_CONSUMERS = 128;     // one warpgroup
constexpr int TM_THREADS = TM_CONSUMERS + 32;   // + the producer warp
constexpr int TM_ALIGN = 1024;        // the 128-byte swizzle's period

template <int N>
struct TmTile {
  static constexpr int A_BYTES = TM_BM * TM_BK * 2;   // the V slab
  static constexpr int B_BLOCK = TM_BK * 128;         // 64 k x 64 n
  static constexpr int B_PART = (N / 64) * B_BLOCK;   // U hi or lo, 64 x N
  static constexpr int STAGE = A_BYTES + 2 * B_PART;
  static constexpr int STAGES = 2;
  static constexpr int EPI = TM_BM * N * 2;           // M staged
  // Staging buffers: two, but one at N = 128, where two would leave room
  // for one block a SM instead of two.
  static constexpr int EPIS = N == 128 ? 1 : 2;
  static constexpr int BAR_OFF = STAGES * STAGE + EPIS * EPI;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + TM_ALIGN;
  // Blocks a SM: as many as its 228 KB hold (1 KB each kept by the card).
  static constexpr int RESIDENT = 233472 / (SMEM + 1024);
};
static_assert(TmTile<64>::RESIDENT == 3 && TmTile<128>::RESIDENT == 2 &&
                  TmTile<256>::RESIDENT == 1,
              "tuple multiply blocks a SM");

// M[p] = (V[p] . (U hi[p] + U lo[p])) * inv_scale[p] over the items
// blockIdx.x, blockIdx.x + gridDim.x, ... of 64 * slabs * nblocks; V (64,
// T, C), U (2, 64, C, O), M (64, T, O) through their tensor maps.
template <class T, int N>
__global__ void __launch_bounds__(TM_THREADS, TmTile<N>::RESIDENT)
winograd16_tuple_multiply_kernel(const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap u_map,
                                 const __grid_constant__ CUtensorMap m_map,
                                 const float* __restrict__ inv_scale, int T_,
                                 int C, int O) {
  using Tile = TmTile<N>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((TM_ALIGN - (hopper::smem_u32(smem_raw) & (TM_ALIGN - 1))) &
                  (TM_ALIGN - 1));
  // EPIS staging buffers of M, each [N / 64][64 rows][128 bytes].
  unsigned char* epis = smem + STAGES * Tile::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int slabs = (T_ + TM_BM - 1) / TM_BM;
  const int nblocks = (O + N - 1) / N;
  const int items = 64 * slabs * nblocks;
  const int chunks = (C + TM_BK - 1) / TM_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], TM_CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == TM_CONSUMERS / 32) {
    // The producer: one lane issues every copy of this block's items.
    if (lane != 0) return;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int p = item / (slabs * nblocks);
      const int rem = item % (slabs * nblocks);
      const int t0 = (rem / nblocks) * TM_BM, o0 = (rem % nblocks) * N;
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * Tile::STAGE;
        hopper::mbar_expect_tx(&full[s], Tile::STAGE);
        hopper::tma_load_3d(st, &v_map, &full[s], kc * TM_BK, t0, p);
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int j = 0; j < N / 64; ++j)
            hopper::tma_load_4d(
                st + Tile::A_BYTES + part * Tile::B_PART + j * Tile::B_BLOCK,
                &u_map, &full[s], o0 + 64 * j, kc * TM_BK, p, part);
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int g = lane / 4, t4 = lane % 4;
  float acc[N / 2];
  int it = 0, n_item = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n_item) {
    const int p = item / (slabs * nblocks);
    const int rem = item % (slabs * nblocks);
    const int t0 = (rem / nblocks) * TM_BM, o0 = (rem % nblocks) * N;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
    for (int kc = 0; kc < chunks; ++kc, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a = hopper::smem_u32(smem + s * Tile::STAGE);
      const uint32_t b = a + Tile::A_BYTES;
      wgmma16::fence();
#pragma unroll
      for (int k = 0; k < TM_BK / 16; ++k) {
        const uint64_t da = wgmma16::desc(a + 32 * k, 16, 1024);
#pragma unroll
        for (int part = 0; part < 2; ++part)
          wgmma16::wgmma(T{}, acc, da,
                         wgmma16::desc(b + part * Tile::B_PART + 2048 * k,
                                       Tile::B_BLOCK, 1024));
      }
      wgmma16::commit();
      wgmma16::wait<0>();
      // This warp is done with stage s.
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    // Epilogue, into a staging buffer whose stores have read it (with two
    // buffers, the previous item's stores may still run).
    unsigned char* epi = epis + (n_item % Tile::EPIS) * Tile::EPI;
    if (tid == 0) {
      if (Tile::EPIS == 2)
        hopper::tma_store_wait_read<1>();
      else
        hopper::tma_store_wait_read<0>();
    }
    hopper::bar_sync(1, TM_CONSUMERS);
    const float sc = __ldg(inv_scale + p);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        // Block j / 8 of 64 columns, 16-byte chunk j % 8 of the row,
        // swizzled by the row mod 8.
        *reinterpret_cast<uint32_t*>(
            epi + (j / 8) * (TM_BM * 128) + row * 128 +
            16 * ((j % 8) ^ (row % 8)) + 4 * t4) =
            hm::pack2<T>(acc[4 * j + 2 * h] * sc, acc[4 * j + 2 * h + 1] * sc);
      }
    hopper::fence_proxy_async();
    hopper::bar_sync(1, TM_CONSUMERS);
    if (tid == 0) {
      for (int j = 0; j < N / 64 && o0 + 64 * j < O; ++j)
        hopper::tma_store_3d(&m_map, epi + j * (TM_BM * 128), o0 + 64 * j,
                             t0, p);
      hopper::tma_store_commit();
    }
  }
  if (tid == 0) hopper::tma_store_wait<0>();
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

// The tuple multiply's N for O out channels: all of O up to 256.
int tm_width(int O) { return O <= 64 ? 64 : O <= 128 ? 128 : 256; }

// The tuple multiply's launch at item width N, after its shared memory
// limit is raised on the current device (once): persistent blocks, as many
// as the SMs hold (Tile::RESIDENT a SM), or one an item.
template <class T, int N>
cudaError_t plan_tm(int T_, int O, describe::Launch* l) {
  using Tile = TmTile<N>;
  // The SM count of each device, 0 until its first launch there has
  // raised the kernel's shared memory limit on it.
  static int sms[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(winograd16_tuple_multiply_kernel<T, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile::SMEM);
    int count = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  const long items =
      64L * ((T_ + TM_BM - 1) / TM_BM) * ((O + N - 1) / N);
#ifndef TM16_PERSISTENT
#define TM16_PERSISTENT 1
#endif
  const long slots =
      TM16_PERSISTENT ? (long)sms[dev] * Tile::RESIDENT : items;
  l->grid = dim3(static_cast<unsigned>(items < slots ? items : slots), 1, 1);
  l->threads = TM_THREADS;
  l->smem = Tile::SMEM;
  l->stages = Tile::STAGES;
  l->resident = TM16_PERSISTENT ? Tile::RESIDENT : 0;
  l->func = (const void*)&winograd16_tuple_multiply_kernel<T, N>;
  return cudaSuccess;
}

template <class T, int N>
int tm_launch(const CUtensorMap& v_map, const CUtensorMap& u_map,
              const CUtensorMap& m_map, const float* inv_scale, int T_, int C,
              int O, cudaStream_t stream) {
  describe::Launch l;
  const cudaError_t err = plan_tm<T, N>(T_, O, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  winograd16_tuple_multiply_kernel<T, N><<<l.grid, l.threads, l.smem,
                                           stream>>>(v_map, u_map, m_map,
                                                     inv_scale, T_, C, O);
  return static_cast<int>(cudaGetLastError());
}

// plan_tm at the width tm_width(O) takes.
template <class T>
cudaError_t plan_tm_for(int T_, int O, describe::Launch* l) {
  switch (tm_width(O)) {
    case 64:
      return plan_tm<T, 64>(T_, O, l);
    case 128:
      return plan_tm<T, 128>(T_, O, l);
    default:
      return plan_tm<T, 256>(T_, O, l);
  }
}

// The transforms' launches: a thread a (tile, channel) pair, a thread a
// (tile, out channel) pair.
template <class T>
describe::Launch plan_input16(int T_, int C) {
  describe::Launch l;
  l.grid = dim3(blocks_for((size_t)T_ * C), 1, 1);
  l.threads = THREADS;
  l.func = (const void*)&winograd16_input_transform_kernel<T>;
  return l;
}

template <class T>
describe::Launch plan_output16(int T_, int O) {
  describe::Launch l;
  l.grid = dim3(blocks_for((size_t)T_ * O), 1, 1);
  l.threads = THREADS;
  l.func = (const void*)&winograd16_output_transform_kernel<T>;
  return l;
}

template <class T>
int tm_dispatch(const CUtensorMap& v_map, const CUtensorMap& u_map,
                const CUtensorMap& m_map, const float* inv_scale, int T_,
                int C, int O, cudaStream_t stream) {
  switch (tm_width(O)) {
    case 64:
      return tm_launch<T, 64>(v_map, u_map, m_map, inv_scale, T_, C, O,
                              stream);
    case 128:
      return tm_launch<T, 128>(v_map, u_map, m_map, inv_scale, T_, C, O,
                               stream);
    default:
      return tm_launch<T, 256>(v_map, u_map, m_map, inv_scale, T_, C, O,
                               stream);
  }
}

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
// (64,) fp32.  C % 8 == 0, O % 8 == 0, V, U and M 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int repro_winograd16_tuple_multiply(const void* V, const void* U,
                                               const float* inv_scale,
                                               void* M, int T, int C, int O,
                                               int dtype,
                                               cudaStream_t stream) {
  if (T < 1 || C < 8 || C % 8 != 0 || O < 8 || O % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(V) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(U) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(M) & 15) != 0 || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t t = T, c = C, o = O;
  const uint64_t v_dims[3] = {c, t, 64}, v_strides[2] = {c * 2, t * c * 2};
  const uint64_t u_dims[4] = {o, c, 64, 2};
  const uint64_t u_strides[3] = {o * 2, c * o * 2, 64 * c * o * 2};
  const uint64_t m_dims[3] = {o, t, 64}, m_strides[2] = {o * 2, t * o * 2};
  const uint32_t v_box[3] = {TM_BK, TM_BM, 1}, u_box[4] = {64, TM_BK, 1, 1};
  const uint32_t m_box[3] = {64, TM_BM, 1};
  CUtensorMap v_map, u_map, m_map;
  if (!hopper::make_map(&v_map, V, 3, v_dims, v_strides, v_box,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&u_map, U, 4, u_dims, u_strides, u_box,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&m_map, M, 3, m_dims, m_strides, m_box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return tm_dispatch<__nv_bfloat16>(v_map, u_map, m_map, inv_scale, T, C,
                                      O, stream);
  return tm_dispatch<__half>(v_map, u_map, m_map, inv_scale, T, C, O, stream);
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

// What the three entries launch, as describe.cuh lays it out: the input
// transform (which 0, args = (T, C, dtype)), the tuple multiply (which 1,
// args = (T, C, O, dtype)) or the output transform (which 2, args = (T, O,
// dtype)).
extern "C" int repro_winograd_3pass_16_describe(const int* args, int nargs,
                                                int which, long long* out) {
  const int want = which == 1 ? 4 : 3;
  if (which < 0 || which > 2 || nargs != want || args[0] < 1 ||
      args[nargs - 2] < 1 || bad_dtype(args[nargs - 1]))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = args[nargs - 1] == 0;
  describe::Launch l;
  if (which == 0) {
    l = bf16 ? plan_input16<__nv_bfloat16>(args[0], args[1])
             : plan_input16<__half>(args[0], args[1]);
  } else if (which == 2) {
    l = bf16 ? plan_output16<__nv_bfloat16>(args[0], args[1])
             : plan_output16<__half>(args[0], args[1]);
  } else {
    const cudaError_t err =
        bf16 ? plan_tm_for<__nv_bfloat16>(args[0], args[2], &l)
             : plan_tm_for<__half>(args[0], args[2], &l);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return describe::write(l, out);
}
