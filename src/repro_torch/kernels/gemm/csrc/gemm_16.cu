// bf16 and fp16 GEMM with a fused bias + activation epilogue for Hopper
// (sm_90a): wgmma m64n64k16 with fp32 sums, operands by TMA through an
// mbarrier ring, and split-K added inside the launch across a thread block
// cluster.
//
// Replaces the 16-bit bodies of the TPU kernel
// src/repro/kernels/gemm/kernel.py::matmul_pallas: C = act(A @ B + bias),
// A (M, K) and B (K, N) row-major (B's rows `ldb` values apart) of one
// 16-bit type T, bias fp32, C of type T (the TPU kernel writes a.dtype).  The products of the 16-bit
// operands are summed in fp32, bias and activation act on the fp32 sum,
// which is rounded to T once, at the store.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries the fp32 accumulator in VMEM scratch across the K axis.  Here a
// block computes 64 x 64 tiles of C, each over a contiguous range of K
// chunks of 64: one tile where K is split, else as many as the grid of
// persistent blocks (the SMs' resident blocks) gives it, the producer
// running on into the next tile while the consumers store the last.  One
// producer warp keeps the chunks in flight through a ring of up to
// MAX_STAGES stages (a "full" and an "empty" mbarrier each): A's
// 64 x 64 box K-major and B's 64 x 64 box as it lies (MN-major), both by
// TMA with the 128-byte swizzle, ragged M, N and K zero-filled by the copy
// engine.  One consumer warpgroup runs 4 wgmma m64n64k16 a chunk
// (csrc/wgmma16.cuh, both operands from shared memory), then frees the
// stage.  TMA wants B's rows 16-byte multiples apart: a B with N % 8 != 0
// (YOLOv3's heads, N = 255) comes as the first N columns of rows padded
// to a multiple of 8 (ops.py::tma_rows16, where the weights are
// prepared), and the copy engine zero-fills the columns past N.
//
// Split-K.  Where the grid of tiles leaves the card's block slots empty,
// `splits` blocks share a tile, each over its own contiguous range of the
// ceil(K / 64) chunks (split s takes [s n / splits, (s + 1) n / splits)),
// and they form one cluster of `splits` blocks (at most MAX_SPLITS, the
// portable cluster size; ops.py::call_splits_16 picks the count).  Each
// block stages its fp32 partial tile in its own shared memory (over the
// ring it no longer needs); after a cluster barrier, rank r reads the
// partials of every block of the cluster through distributed shared
// memory, adds them in split order (the same result on every run), applies
// bias and activation to rows [64 r / splits, 64 (r + 1) / splits), rounds
// and stores them.  A second barrier keeps each block's partial alive
// until all have read it.  No workspace, and one launch a call.
//
// What bounds it.  2 bytes an operand value and 989 TFLOP/s of dense
// 16-bit products: the 1x1 convs of the paper's networks (K = 64 to 1024)
// have few FLOPs per byte, so the bound is mostly bytes (A read once, C
// written once); small-M calls (YOLOv3-tiny's M = 169) are a few chunks'
// latency, which the split spreads over more SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "describe.cuh"
#include "hmma16.cuh"
#include "hopper_async.cuh"
#include "per_device.cuh"
#include "wgmma16.cuh"

namespace {

constexpr int BM = 64;               // rows of C a block (wgmma's M)
constexpr int BN = 64;               // columns of C a block (wgmma's N)
constexpr int BK = 64;               // K a chunk: 128-byte rows
constexpr int MAX_STAGES = 3;       // chunks in the ring, at most
constexpr int MAX_SPLITS = 8;        // blocks a cluster, at most
constexpr int CONSUMERS = 128;       // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int MIN_BLOCKS = 3;        // __launch_bounds__ minimum blocks a SM
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int RED_BYTES = BM * wgmma16::RED_LD * 4;   // the fp32 partial
constexpr int ALIGN = 1024;          // the 128-byte swizzle's period

// The ring's stages: one a chunk of a split (of a tile's K where blocks
// are persistent), up to MAX_STAGES: a short K keeps its blocks small, so
// more of them fit an SM.
__host__ __device__ inline int stages_for(int K, int splits) {
  const int chunks = (K + BK - 1) / BK;
  const int per_split = (chunks + splits - 1) / splits;
  return per_split < 1 ? 1 : per_split < MAX_STAGES ? per_split : MAX_STAGES;
}
// The ring and the fp32 partial tile: its own buffer after the ring when a
// block walks several tiles (splits == 1), else staged over the ring.
__host__ __device__ inline int body_bytes(int stages, int splits) {
  return splits == 1 ? stages * STAGE + RED_BYTES
         : stages * STAGE > RED_BYTES ? stages * STAGE : RED_BYTES;
}
// Dynamic shared memory of a launch: the ring and the partial, 2 mbarriers
// a stage, and room to align the ring to ALIGN.
__host__ __device__ inline int smem_bytes(int stages, int splits) {
  return body_bytes(stages, splits) + 2 * MAX_STAGES * 8 + ALIGN;
}

// act(A @ B + bias) for the tiles blockIdx.x / splits, + gridDim.x /
// splits, ... and K split blockIdx.x % splits (the block's rank in its
// cluster); A and B through their tensor maps.  With splits > 1 the grid
// holds one
// block a tile and split; with splits == 1 the blocks are persistent, and
// the producer runs on into the next tile while the consumers store.
template <class T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
hgemm16_bias_act_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const float* __restrict__ bias, T* __restrict__ C,
                        int M, int N, int K, int act, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((ALIGN - (hopper::smem_u32(smem_raw) & (ALIGN - 1))) &
                  (ALIGN - 1));
  const int stages = stages_for(K, splits);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + body_bytes(stages, splits));
  uint64_t* empty = full + MAX_STAGES;
  float* red = reinterpret_cast<float*>(smem + (splits == 1 ? stages * STAGE
                                                            : 0));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % splits;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int step = gridDim.x / splits;
  const int chunks = (K + BK - 1) / BK;
  const int lo = split * chunks / splits, hi = (split + 1) * chunks / splits;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // The producer warp: lane 0 issues the copies.
    if (lane != 0) return;
    hopper::prefetch_map(&a_map);
    hopper::prefetch_map(&b_map);
    int it = 0;
    for (int tile = blockIdx.x / splits; tile < tiles; tile += step) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      for (int c = lo; c < hi; ++c, ++it) {
        const int s = it % stages;
        if (it >= stages)
          hopper::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE;
        hopper::mbar_expect_tx(&full[s], STAGE);
        hopper::tma_load_2d(st, &a_map, &full[s], c * BK, m0);
        hopper::tma_load_2d(st + A_BYTES, &b_map, &full[s], n0, c * BK);
      }
    }
    return;
  }

  // The consumer warpgroup.
  int it = 0;
  for (int tile = blockIdx.x / splits; tile < tiles; tile += step) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int c = lo; c < hi; ++c, ++it) {
      const int s = it % stages;
      hopper::mbar_wait(&full[s], (it / stages) & 1);
      const uint32_t a = hopper::smem_u32(smem + s * STAGE);
      const uint32_t b = a + A_BYTES;
      wgmma16::fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma16::wgmma(T{}, acc, wgmma16::desc(a + 32 * k, 16, 1024),
                       wgmma16::desc(b + 2048 * k, B_BYTES, 1024));
      wgmma16::commit();
      wgmma16::wait<0>();
      // This warp is done with stage s.
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: the partial tile (over the ring, once every consumer warp
    // is past its last product; or in its own buffer, once the previous
    // tile's stores have read it), then the cluster's sum of this block's
    // rows.
    hopper::bar_sync(1, CONSUMERS);
    wgmma16::stage_partial(red, 0, acc);
    if (splits > 1)
      hopper::cluster_sync();
    else
      hopper::bar_sync(1, CONSUMERS);
    wgmma16::reduce_tile(
        red, BM, splits, CONSUMERS,
        [&](int row, int col, float(&v)[8]) {
          const int m = m0 + row, n = n0 + col;
          if (m < M && n < N)
            wgmma16::store8(C + (size_t)m * N + n, bias, n, N, act, v);
        });
    if (splits > 1) hopper::cluster_sync();
  }
}

// The kernel's launch for an M x N x K product cut into `splits`, after
// its shared memory limit is raised on the current device (once): the
// ring's stages and shared memory, and the grid, a block a tile and split,
// or, unsplit, persistent blocks, as many as the SMs hold at once.
template <class T>
cudaError_t plan16(int M, int N, int K, int splits, describe::Launch* l) {
  // The SM count of each device, 0 until its first launch there has
  // raised the kernel's shared memory limit on it.
  static int sms[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(hgemm16_bias_act_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(MAX_STAGES, 1));
    int count = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  const int smem = smem_bytes(stages_for(K, splits), splits);
  const long tiles = (long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  long blocks = tiles * splits;
  int resident = 0;
  if (splits == 1) {
    // Persistent: as many blocks as the SMs hold at once.
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hgemm16_bias_act_kernel<T>, THREADS, smem);
    if (err != cudaSuccess) return err;
    resident = per_sm > 0 ? per_sm : 1;
    const long slots = (long)sms[dev] * resident;
    blocks = tiles < slots ? tiles : slots;
  }
  l->grid = dim3(static_cast<unsigned>(blocks), 1, 1);
  l->cluster = dim3(static_cast<unsigned>(splits), 1, 1);
  l->threads = THREADS;
  l->smem = static_cast<size_t>(smem);
  l->stages = stages_for(K, splits);
  l->resident = resident;
  l->func = (const void*)&hgemm16_bias_act_kernel<T>;
  return cudaSuccess;
}

template <class T>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map,
           const float* bias, T* C, int M, int N, int K, int act, int splits,
           cudaStream_t stream) {
  describe::Launch l;
  const cudaError_t err = plan16<T>(M, N, K, splits, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hopper::launch_clustered(
      hgemm16_bias_act_kernel<T>, l.grid, THREADS, l.smem, stream,
      static_cast<unsigned>(splits), a_map, b_map, bias, C, M, N, K, act,
      splits));
}

}  // namespace

// C = act(A @ B + bias), A, B and C bf16 (dtype 0) or fp16 (dtype 1), B's
// rows ldb >= N values apart, bias fp32 or null.  K % 8 == 0 and ldb % 8
// == 0 (TMA's 16-byte strides), A, B and C 16-byte aligned; 1 <= splits
// <= min(MAX_SPLITS, ceil(K / 64)).  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take, or when the
// driver refuses a tensor map).
extern "C" int repro_gemm16_bias_act(const void* A, const void* B,
                                     const float* bias, void* C, int M, int N,
                                     int K, int ldb, int act, int splits,
                                     int dtype, cudaStream_t stream) {
  const int chunks = (K + BK - 1) / BK;
  if (M < 1 || N < 1 || K < 8 || K % 8 != 0 || ldb < N || ldb % 8 != 0 ||
      splits < 1 ||
      splits > MAX_SPLITS || splits > chunks ||
      (long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * splits > 0x7fffffffL ||
      (reinterpret_cast<uintptr_t>(A) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(B) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(C) & 15) != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t m = M, n = N, k = K;
  const uint64_t a_dims[2] = {k, m}, a_strides[1] = {k * 2};
  const uint64_t b_dims[2] = {n, k};
  const uint64_t b_strides[1] = {static_cast<uint64_t>(ldb) * 2};
  const uint32_t box[2] = {64, 64};
  CUtensorMap a_map, b_map;
  if (!hopper::make_map(&a_map, A, 2, a_dims, a_strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&b_map, B, 2, b_dims, b_strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch(a_map, b_map, bias, static_cast<__nv_bfloat16*>(C), M, N,
                  K, act, splits, stream);
  return launch(a_map, b_map, bias, static_cast<__half*>(C), M, N, K, act,
                splits, stream);
}

// What repro_gemm16_bias_act launches for args = (M, N, K, ldb, splits,
// dtype), as describe.cuh lays it out (which 0: its one kernel).
extern "C" int repro_gemm_16_describe(const int* args, int nargs, int which,
                                      long long* out) {
  if (nargs != 6 || which != 0 || args[0] < 1 || args[1] < 1 || args[2] < 8 ||
      args[4] < 1 || args[4] > MAX_SPLITS || (args[5] != 0 && args[5] != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  const cudaError_t err =
      args[5] == 0
          ? plan16<__nv_bfloat16>(args[0], args[1], args[2], args[4], &l)
          : plan16<__half>(args[0], args[1], args[2], args[4], &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return describe::write(l, out);
}
