// Implicit-GEMM (fused im2col + GEMM) bf16 and fp16 convolution, NHWC /
// HWIO, for Hopper (sm_90a): wgmma m64n64k16 with fp32 sums, A from
// registers, weights and input windows by TMA through an mbarrier ring,
// split-K added inside the launch across a thread block cluster, and a
// fused bias + activation epilogue.
//
// Replaces the 16-bit bodies of the TPU kernel
// src/repro/kernels/im2col_gemm/kernel.py::conv2d_im2col_gemm_pallas
// (_accumulate_taps, _conv_kernel, _conv_bias_kernel): out = act(conv(x, w)
// + bias), x (B, H, W, C) and w (kh, kw, C, O) of one 16-bit type T (w's
// channel rows `ldw` values apart), bias fp32, out of type T (the TPU kernel writes x.dtype).  The products are
// summed in fp32; bias and activation act on the fp32 sum, rounded to T
// once, at the store.
//
// Design.  The TPU kernel keeps a whole padded image slab per program and
// walks the in-channel blocks as a sequential grid axis into an fp32 VMEM
// accumulator.  Here a work item is a 128 x 64 fp32 tile of the GEMM whose
// rows are output pixels of one image and whose columns are out channels,
// and whose K runs over (chunk of CK = 32 channels, tap, 16 channels).
//  - Pixels.  An item is 128 consecutive output pixels in raster order
//    (OW <= 128), so no row is idle on a 13-, 14-, 26- or 28-wide map; on
//    a wider map, two runs of 64 pixels of a row (one a warpgroup), so a
//    152- or 304-wide row wastes at most one part-run.
//  - Staging.  Per chunk one producer warp fills a stage of the ring by
//    TMA: the weights (taps, 32 channels, 64 out channels) as one 3-D box
//    of the HWIO tensor, rows of 64 out channels with the 128-byte
//    swizzle (MN-major B for wgmma), zero past C and O (TMA wants the rows
//    16-byte multiples apart: weights with O % 8 != 0 come as the first O
//    columns of rows padded to a multiple of 8, gemm/ops.py::tma_rows16,
//    where they are prepared); and the input window the item's taps read,
//    halo included, one box (32 channels x up to 256 columns) for each
//    window row, 64-byte rows with the 64-byte swizzle, zero-filled by
//    the copy engine outside the image (the conv's padding: the caller
//    pads nothing spatially) and past C (C = 8 leaves a chunk three
//    quarters zero).  A raster item's window is the whole
//    width of every input row its pixels' taps touch; a run's, the rows
//    and columns of its own taps.  The ring holds at most MAX_STAGES
//    stages, and no more than a block's chunks: a short K keeps the block
//    small, so that two fit an SM.
//  - Products.  Two consumer warpgroups, 64 pixels each.  For each tap a
//    warp reads its 16 pixels' A fragment (16 pixels x 16 channels) from
//    the window by ldmatrix.x4, each lane at its pixel's window position
//    shifted by the tap (any row address will do), and the warpgroup
//    issues wgmma m64n64k16 with A from registers and the tap's weights
//    from shared memory (csrc/wgmma16.cuh).  Two register sets alternate
//    across taps, so a tap's ldmatrix overlaps the previous tap's product.
//  - Blocks.  Unsplit, the blocks are persistent (as many as the SMs hold
//    at once, each over items blockIdx.x, + gridDim.x, ...): the producer
//    runs on into the next item while the consumers store the last one,
//    from a partial-tile buffer of their own.
//
// Split-K.  Where the items leave the card's SMs idle, `splits` blocks
// share an item, each over its own contiguous range of the ceil(C / 32)
// chunks, as one cluster of `splits` blocks (at most MAX_SPLITS;
// ops.py::call_splits_16 picks the count).  Each block stages its fp32
// partial over the ring; after a cluster barrier, rank r adds the
// partials of all the cluster's blocks over distributed shared memory in
// split order (the same result on every run), applies bias and
// activation, rounds and stores rows [128 r / splits, 128 (r + 1) /
// splits); a second barrier keeps every partial alive until all have read
// it.  No workspace, and one launch a call.
//
// What bounds it.  At batch 1 the layers are small (0.1 to 3.7 GFLOP): the
// dense 16-bit tensor-core rate (989 TFLOP/s) against the weights read
// once from device memory.  On an NVIDIA H100 80GB HBM3 at 700 W a call
// costs some 7 us besides about 1.5 us a chunk of a block, and neither the
// copies' bytes nor the products alone set it (scripts/conv16_variants.py
// and its diagnostics, PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "describe.cuh"
#include "hmma16.cuh"
#include "hopper_async.cuh"
#include "per_device.cuh"
#include "wgmma16.cuh"

namespace {

namespace hm = hmma16;

constexpr int BM = 128;              // output pixels a block
constexpr int RUN = 64;              // pixels a run (a warpgroup's rows)
constexpr int BN = 64;               // out channels a block (wgmma's N)
constexpr int CK = 32;               // channels a chunk: 64-byte window rows
constexpr int MAX_STAGES = 2;       // chunks in the ring, at most
constexpr int MAX_SPLITS = 8;        // blocks a cluster, at most
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int MIN_BLOCKS = 1;        // __launch_bounds__ minimum blocks a SM
constexpr int MAX_BOX = 256;         // TMA's largest box side
constexpr int RED_BYTES = BM * wgmma16::RED_LD * 4;   // the fp32 partial
constexpr int ALIGN = 1024;          // the 128-byte swizzle's period
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block

// One launch's shapes and the layout of its ring (geom_for).
struct Geom {
  int B, H, W, C, O, ldw, OH, OW, kh, kw, sh, sw, ph, pw, act, splits;
  int raster;      // 1: tiles of BM consecutive pixels of the map (OW <=
                   // BM), else two runs of RUN pixels of a row a tile
  int rpr;         // runs a row (raster == 0)
  int tiles_img;   // pixel tiles an image
  int o_blocks;    // 64-wide out-channel blocks
  int tiles;       // work items: images x out-channel blocks x pixel tiles
  int segs;        // window segments: 1 (raster), or 2 (a run each)
  int seg_h;       // input rows a segment
  int box_w;       // window columns a TMA box (a multiple of 8)
  int ncb;         // boxes a segment row
  int win_w;       // window row stride in pixels: ncb * box_w
  int w_bytes;     // the weights' part of a stage (the window follows)
  int stage_bytes; // a stage, a multiple of ALIGN
  int stages;      // stages in the ring
  int tx_bytes;    // bytes the copies of a stage write
  int red_off;     // the fp32 partial tile: after the ring (splits == 1,
                   // persistent blocks) or over it (0)
  int bar_off;     // the mbarriers
  int smem;        // dynamic shared memory of the launch
};

int round_up(int v, int q) { return (v + q - 1) / q * q; }

// The launch's geometry; false when a stage does not fit in shared memory.
bool geom_for(Geom& g) {
  const int taps = g.kh * g.kw;
  const int chunks = (g.C + CK - 1) / CK;
  g.raster = g.OW <= BM;
  g.rpr = (g.OW + RUN - 1) / RUN;
  g.tiles_img = g.raster ? (g.OH * g.OW + BM - 1) / BM
                         : (g.OH * g.rpr + 1) / 2;
  g.o_blocks = (g.O + BN - 1) / BN;
  g.tiles = g.B * g.o_blocks * g.tiles_img;
  int cols;
  if (g.raster) {
    // The most output rows BM consecutive pixels can touch.
    const int span = (g.OW - 1 + BM - 1) / g.OW + 1;
    g.segs = 1;
    g.seg_h = (span - 1) * g.sh + g.kh;
    cols = (g.OW - 1) * g.sw + g.kw;
  } else {
    g.segs = 2;
    g.seg_h = g.kh;
    cols = (RUN - 1) * g.sw + g.kw;
  }
  g.ncb = (cols + MAX_BOX - 1) / MAX_BOX;
  g.box_w = round_up((cols + g.ncb - 1) / g.ncb, 8);
  g.win_w = g.ncb * g.box_w;
  g.w_bytes = taps * CK * BN * 2;
  const int win_bytes = g.segs * g.seg_h * g.win_w * CK * 2;
  g.stage_bytes = round_up(g.w_bytes + win_bytes, ALIGN);
  g.tx_bytes = g.w_bytes + win_bytes;
  const int room = MAX_SMEM - ALIGN - 2 * MAX_STAGES * 8 -
                   (g.splits == 1 ? RED_BYTES : 0);
  // No more stages than a split's chunks (a work item's, where blocks are
  // persistent): a small ring keeps more blocks on an SM.
  const int per_split = (chunks + g.splits - 1) / g.splits;
  g.stages = room / g.stage_bytes;
  if (g.stages > MAX_STAGES) g.stages = MAX_STAGES;
  if (g.stages > per_split) g.stages = per_split;
  if (g.stages < 1) return false;
  const int ring = g.stages * g.stage_bytes;
  g.red_off = g.splits == 1 ? ring : 0;
  g.bar_off = g.splits == 1 ? ring + RED_BYTES
                            : ring > RED_BYTES ? ring : RED_BYTES;
  g.smem = g.bar_off + 2 * MAX_STAGES * 8 + ALIGN;
  return true;
}

// One work item: its image, out channels, and its pixels (a raster tile
// from pixel p0, or the runs of rows oh[j] from columns ow0[j], n[j]
// pixels each; a run past the map has none).
struct Tile {
  int b, o0, p0, oh_lo, oh[2], ow0[2], n[2];
};

__device__ __forceinline__ Tile tile_of(const Geom& g, int t) {
  Tile x;
  const int pt = t % g.tiles_img;
  t /= g.tiles_img;
  x.o0 = (t % g.o_blocks) * BN;
  x.b = t / g.o_blocks;
  x.p0 = pt * BM;
  x.oh_lo = x.p0 / g.OW;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 2 * pt + j;
    x.oh[j] = r / g.rpr;
    x.ow0[j] = (r % g.rpr) * RUN;
    const int left = g.OW - x.ow0[j];
    x.n[j] = x.oh[j] < g.OH ? (left < RUN ? left : RUN) : 0;
  }
  return x;
}

template <class T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
im2col16_conv_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const float* __restrict__ bias, T* __restrict__ out,
                     const Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((ALIGN - (hopper::smem_u32(smem_raw) & (ALIGN - 1))) &
                  (ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + MAX_STAGES;
  float* red = reinterpret_cast<float*>(smem + g.red_off);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % g.splits;
  const int step = gridDim.x / g.splits;
  const int chunks = (g.C + CK - 1) / CK;
  const int lo = split * chunks / g.splits;
  const int hi = (split + 1) * chunks / g.splits;
  const int taps = g.kh * g.kw;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // The producer: one lane issues every copy of this block's chunks,
    // running on into its next work item while the consumers store.
    if (lane != 0) return;
    hopper::prefetch_map(&x_map);
    hopper::prefetch_map(&w_map);
    int it = 0;
    for (int t = blockIdx.x / g.splits; t < g.tiles; t += step) {
      const Tile x = tile_of(g, t);
      for (int c = lo; c < hi; ++c, ++it) {
        const int s = it % g.stages;
        if (it >= g.stages)
          hopper::mbar_wait(&empty[s], ((it / g.stages) & 1) ^ 1);
        unsigned char* st = smem + s * g.stage_bytes;
        hopper::mbar_expect_tx(&full[s], g.tx_bytes);
        hopper::tma_load_3d(st, &w_map, &full[s], x.o0, c * CK, 0);
        for (int j = 0; j < g.segs; ++j) {
          // The window's top-left input pixel of segment j.
          const int ih0 = (g.raster ? x.oh_lo : x.oh[j]) * g.sh - g.ph;
          const int iw0 = (g.raster ? 0 : x.ow0[j] * g.sw) - g.pw;
          for (int r = 0; r < g.seg_h; ++r)
            for (int k = 0; k < g.ncb; ++k)
              hopper::tma_load_4d(
                  st + g.w_bytes +
                      ((j * g.seg_h + r) * g.win_w + k * g.box_w) * CK * 2,
                  &x_map, &full[s], c * CK, iw0 + k * g.box_w, ih0 + r, x.b);
        }
      }
    }
    return;
  }

  // The consumer warpgroups: warpgroup wg holds tile rows 64 wg .. 64 wg +
  // 63 (a run each where the tile is two runs).  This lane's ldmatrix row
  // is tile row m, its 8-channel half of a k16 step khalf.
  const int wg = warp / 4;
  const int m = 64 * wg + 16 * (warp % 4) + hm::a_frag_row(lane);
  const int khalf = hm::a_frag_col(lane) / 8;
  // A of tap `tap`, both k16 steps of the chunk, for the tile row at
  // window pixel px0 at tap (0, 0): window pixel px's 64-byte row holds
  // 16-byte chunk q at chunk q ^ ((px / 2) % 4) (TMA's 64-byte swizzle on
  // a window that starts on a 512-byte boundary).
  auto load_a = [&](uint32_t(&a)[2][4], uint32_t win, int px0, int tap) {
    const int px = px0 + (tap / g.kw) * g.win_w + tap % g.kw;
    const uint32_t row = win + px * CK * 2;
    const int swz = (px >> 1) & 3;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      hm::ldsm_x4(a[ks], row + 16 * ((2 * ks + khalf) ^ swz));
  };
  int it = 0;
  for (int t = blockIdx.x / g.splits; t < g.tiles; t += step) {
    const Tile x = tile_of(g, t);
    // This lane's window pixel at tap (0, 0); pixel 0 for rows past the
    // map (computed, never stored).
    int px0 = 0;
    if (g.raster) {
      const int p = x.p0 + m;
      if (p < g.OH * g.OW)
        px0 = (p / g.OW - x.oh_lo) * g.sh * g.win_w + (p % g.OW) * g.sw;
    } else if (m % 64 < (wg == 0 ? x.n[0] : x.n[1])) {
      px0 = wg * g.seg_h * g.win_w + (m % 64) * g.sw;
    }
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    // acc += A (this warpgroup's 64 pixels x 32 channels) . the tap's
    // weights (32 channels x 64 out channels, rows of 128 bytes).
    auto product = [&](const uint32_t(&a)[2][4], uint32_t wgt, int tap) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma16::wgmma_rs(T{}, acc, a[ks],
                          wgmma16::desc(wgt + (tap * CK + 16 * ks) * 128,
                                        CK * BN * 2, 1024));
    };
    for (int c = lo; c < hi; ++c, ++it) {
      const int s = it % g.stages;
      hopper::mbar_wait(&full[s], (it / g.stages) & 1);
      const uint32_t wgt = hopper::smem_u32(smem + s * g.stage_bytes);
      const uint32_t win = wgt + g.w_bytes;
      uint32_t a0[2][4], a1[2][4];
      load_a(a0, win, px0, 0);
      for (int tap = 0; tap < taps; tap += 2) {
        wgmma16::fence();
        product(a0, wgt, tap);
        wgmma16::commit();
        if (tap + 1 < taps) {
          wgmma16::wait<1>();   // the product that read a1 is done
          load_a(a1, win, px0, tap + 1);
          wgmma16::fence();
          product(a1, wgt, tap + 1);
          wgmma16::commit();
        }
        if (tap + 2 < taps) {
          wgmma16::wait<1>();   // the product that read a0 is done
          load_a(a0, win, px0, tap + 2);
        }
      }
      wgmma16::wait<0>();
      // This warp is done with stage s.
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: the partial tile (over the ring, once both warpgroups are
    // past their last product; or in its own buffer, once the previous
    // item's stores have read it), then the cluster's sum of this block's
    // rows.
    hopper::bar_sync(1, CONSUMERS);
    wgmma16::stage_partial(red, wg, acc);
    if (g.splits > 1)
      hopper::cluster_sync();
    else
      hopper::bar_sync(1, CONSUMERS);
    wgmma16::reduce_tile(
        red, BM, g.splits, CONSUMERS,
        [&](int row, int col, float(&v)[8]) {
          size_t pix;
          if (g.raster) {
            const int p = x.p0 + row;
            if (p >= g.OH * g.OW) return;
            pix = (size_t)x.b * g.OH * g.OW + p;
          } else {
            const bool j = row >= 64;
            const int k = row % 64;
            if (k >= (j ? x.n[1] : x.n[0])) return;
            pix = ((size_t)x.b * g.OH + (j ? x.oh[1] : x.oh[0])) * g.OW +
                  (j ? x.ow0[1] : x.ow0[0]) + k;
          }
          const int o = x.o0 + col;
          if (o < g.O)
            wgmma16::store8(out + pix * g.O + o, bias, o, g.O, g.act, v);
        });
    if (g.splits > 1) hopper::cluster_sync();
  }
}

// The kernel's launch for geometry g, after its shared memory limit is
// raised on the current device (once): a block a work item and split, or,
// unsplit, persistent blocks, as many as the SMs hold at once.
template <class T>
cudaError_t plan16c(const Geom& g, describe::Launch* l) {
  // The SM count of each device, 0 until its first launch there has
  // raised the kernel's shared memory limit on it.
  static int sms[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(im2col16_conv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    int count = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  long blocks = (long)g.tiles * g.splits;
  int resident = 0;
  if (g.splits == 1) {
    // Persistent: as many blocks as the SMs hold at once.
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, im2col16_conv_kernel<T>, THREADS, g.smem);
    if (err != cudaSuccess) return err;
    resident = per_sm > 0 ? per_sm : 1;
    const long slots = (long)sms[dev] * resident;
    blocks = g.tiles < slots ? g.tiles : slots;
  }
  l->grid = dim3(static_cast<unsigned>(blocks), 1, 1);
  l->cluster = dim3(static_cast<unsigned>(g.splits), 1, 1);
  l->threads = THREADS;
  l->smem = static_cast<size_t>(g.smem);
  l->stages = g.stages;
  l->resident = resident;
  l->func = (const void*)&im2col16_conv_kernel<T>;
  return cudaSuccess;
}

template <class T>
int launch(const CUtensorMap& x_map, const CUtensorMap& w_map,
           const float* bias, T* out, const Geom& g, cudaStream_t stream) {
  describe::Launch l;
  const cudaError_t err = plan16c<T>(g, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hopper::launch_clustered(
      im2col16_conv_kernel<T>, l.grid, THREADS, l.smem, stream,
      static_cast<unsigned>(g.splits), x_map, w_map, bias, out, g));
}

}  // namespace

// out (B, OH, OW, O) = act(conv(x, w) + bias), x (B, H, W, C) and w (kh,
// kw, C, O) bf16 (dtype 0) or fp16 (dtype 1), w's channel rows ldw >= O
// values apart (and its taps C ldw apart), bias fp32 or null, out of the
// same type.  C % 8 == 0 and ldw % 8 == 0 (TMA's 16-byte strides), x, w
// and out 16-byte aligned, 1 <= splits <= min(MAX_SPLITS, ceil(C / 32)).  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take, a window that does not fit, or a tensor map the driver refuses).
extern "C" int repro_im2col_conv16(const void* x, const void* w,
                                   const float* bias, void* out, int B, int H,
                                   int W, int C, int O, int ldw, int OH, int OW,
                                   int kh, int kw, int sh, int sw, int ph,
                                   int pw, int act, int splits, int dtype,
                                   cudaStream_t stream) {
  const int chunks = (C + CK - 1) / CK;
  Geom g{B, H, W, C, O, ldw, OH, OW, kh, kw, sh, sw, ph, pw, act, splits};
  if (B < 1 || C < 8 || C % 8 != 0 || O < 1 || ldw < O || ldw % 8 != 0 ||
      OH < 1 ||
      OW < 1 || kh < 1 || kw < 1 || kh * kw > MAX_BOX || sh < 1 || sw < 1 ||
      splits < 1 || splits > MAX_SPLITS || splits > chunks ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (dtype != 0 && dtype != 1) ||
      (long)B * ((O + BN - 1) / BN) * ((OH * OW + BM - 1) / BM + OH) *
              splits > 0x7fffffffL ||
      !geom_for(g))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t c = C, o = O, ld = ldw, wd = W, h = H;
  const uint64_t x_dims[4] = {c, wd, h, static_cast<uint64_t>(B)};
  const uint64_t x_strides[3] = {c * 2, wd * c * 2, h * wd * c * 2};
  const uint32_t x_box[4] = {CK, static_cast<uint32_t>(g.box_w), 1, 1};
  const uint64_t w_dims[3] = {o, c, static_cast<uint64_t>(kh * kw)};
  const uint64_t w_strides[2] = {ld * 2, c * ld * 2};
  const uint32_t w_box[3] = {BN, CK, static_cast<uint32_t>(kh * kw)};
  CUtensorMap x_map, w_map;
  if (!hopper::make_map(&x_map, x, 4, x_dims, x_strides, x_box,
                        CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::make_map(&w_map, w, 3, w_dims, w_strides, w_box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch(x_map, w_map, bias, static_cast<__nv_bfloat16*>(out), g,
                  stream);
  return launch(x_map, w_map, bias, static_cast<__half*>(out), g, stream);
}

// What repro_im2col_conv16 launches for args = (B, H, W, C, O, ldw, OH,
// OW, kh, kw, sh, sw, ph, pw, splits, dtype), as describe.cuh lays it out
// (which 0: its one kernel).
extern "C" int repro_im2col_conv_16_describe(const int* args, int nargs,
                                             int which, long long* out) {
  if (nargs != 16 || which != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{args[0], args[1], args[2],  args[3],  args[4],  args[5],
         args[6], args[7], args[8],  args[9],  args[10], args[11],
         args[12], args[13], 0, args[14]};
  const int dtype = args[15];
  const int chunks = (g.C + CK - 1) / CK;
  if (g.B < 1 || g.C < 8 || g.O < 1 || g.OH < 1 || g.OW < 1 || g.kh < 1 ||
      g.kw < 1 || g.kh * g.kw > MAX_BOX || g.sh < 1 || g.sw < 1 ||
      g.splits < 1 || g.splits > MAX_SPLITS || g.splits > chunks ||
      (dtype != 0 && dtype != 1) || !geom_for(g))
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  const cudaError_t err = dtype == 0 ? plan16c<__nv_bfloat16>(g, &l)
                                     : plan16c<__half>(g, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return describe::write(l, out);
}
