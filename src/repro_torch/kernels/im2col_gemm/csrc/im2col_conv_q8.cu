// Implicit-GEMM (fused im2col + GEMM) int8 convolution, NHWC / HWIO, for
// sm_90a, on the int8 tensor cores: exact int32 sums, split-K, and a fused
// fp32 dequant + bias + activation epilogue.
//
// Replaces the int8 bodies of the TPU kernel
// src/repro/kernels/im2col_gemm/kernel.py::conv2d_im2col_gemm_pallas
// (_accumulate_taps_q8, _conv_q8_kernel, _conv_q8_bias_kernel, :97-159):
// out = act(float(conv(x_q, w_q)) * scale + bias), x_q (B, H, W, C) and
// w_q (kh, kw, C, O) int8, scale and bias (O,) fp32, out fp32.
//
// Design.  The TPU kernel keeps a whole padded image slab per program and
// walks the in-channel blocks as a sequential grid axis into an int32 VMEM
// accumulator.  Here one block owns a toh x tow output tile (toh * tow <=
// 64) of one image and 64 out channels: a 64 x 64 int32 tile of the GEMM
// whose rows are output pixels and whose K runs over (channel chunk, tap,
// 32 channels).  Its 8 warps (4 x 2) each hold a 16 pixel x 32 channel
// quarter-slab as mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// accumulators: one k32 step is one tap of 32 channels, so A's rows are
// the tile's pixels read through that tap's offset into the staged input
// window (ldmatrix takes any row address), and B is the tap's weights.
// The sum is exact in int32 (the wrapper refuses K * 127^2 >= 2^31), as
// the plain version's, so the output equals it bit for bit.
//
// Staging.  Per chunk of 32 channels the block needs the input window of
// its tile — (toh-1)*sh + kh rows by (tow-1)*sw + kw columns, the halo
// included, 32 bytes a pixel — and the (kh*kw, 32, 64) weight slice; both
// go into the idle one of two buffers while the block computes from the
// other, one barrier a chunk.  The window goes by cp.async, 16 bytes a
// copy, zero-filled outside the image (the conv's padding: the caller pads
// nothing spatially) and past C (C % 32 == 16 leaves the last chunk's
// upper half zero).  B's fragment wants 4 consecutive K bytes of one out
// channel, while HWIO keeps O contiguous, so the weights are transposed on
// the way: each thread reads 4 channel rows x 4 out channels as 4 words
// (bytes where O % 4 != 0), rearranges them with __byte_perm into 4 words
// of 4 channels each and stores those as the [tap][o][32 channels] rows
// ldmatrix reads.  The loads of the next chunk's weights are issued into
// registers before the current chunk's products and stored after them,
// so their latency hides behind the tensor cores (kernels with more than
// 10 taps load them after the products instead).  Each 32-byte row keeps
// its two 16-byte halves swapped where (row / 4) is odd, so the 8 rows of
// an ldmatrix phase fall on distinct banks; the stores rotate their order
// by out-channel group for the same reason.
//
// Split-K.  At batch 1 the 13x13 layers of YOLOv3-tiny give 32-64 blocks
// for 132 SMs.  The chunks are cut into `splits` contiguous ranges, split s
// taking [s * n / splits, (s + 1) * n / splits) of n chunks, on the grid's
// z axis beside the image (ops.py::call_splits_q8 picks splits from the
// shape and RESIDENT_BLOCKS_Q8, this kernel's __launch_bounds__ minimum).
// With splits > 1 each block writes its int32 partial tile to a workspace
// (splits, B*OH*OW, O), and im2col_conv_q8_splitk_reduce_kernel adds the
// partials in split order (exact) and applies the epilogue; with splits ==
// 1 the conv kernel applies it.  The epilogue is float(acc) * scale[o]
// then + bias[o], each rounded on its own (__fmul_rn, __fadd_rn: no FMA
// contraction), then the activation.
//
// The s8 helpers (ldmatrix, mma, cp.async, the __byte_perm turn of the
// weights, the epilogue and the split-K reduce) live in
// kernels/csrc/s8_mma.cuh, shared with the int8 GEMM (gemm/csrc/gemm_q8.cu).
//
// What bounds it.  The int8 layers are small (0.1-1.4 GOP at batch 1): a
// call is 1-4 chunks' latency — the weight slice from L2, the window from
// device memory, the register-staged transpose — plus, where it splits, a
// reduce launch, far below the 1979 TOP/s of the tensor cores.  Inside a
// chunk, 3 ldmatrix.x4 feed 4 mma per warp and tap.  Split-K halves
// YOLOv3-tiny's seven calls, and 3 blocks a SM (85 registers, spilling)
// is slower than 2 (scripts/conv_tc_variants.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "describe.cuh"
#include "per_device.cuh"
#include "s8_mma.cuh"

namespace {

using s8mma::cp_async16;
using s8mma::cp_async_commit;
using s8mma::dequant;
using s8mma::ldmatrix_x4;
using s8mma::mma_s8;
using s8mma::smem_addr;

constexpr int CK = 32;         // channels per chunk: one k32 step per tap
constexpr int BO = 64;         // out channels per block
constexpr int PIX = 64;        // output pixels per block (toh * tow <= PIX)
constexpr int THREADS = 256;   // 8 warps: 4 over pixels x 2 over channels
constexpr int MIN_BLOCKS = 2;  // __launch_bounds__ minimum blocks a SM
constexpr int ROW = CK;        // bytes of a window pixel or a weight row
constexpr int W_ITEMS = 5;     // register-staged weight items a thread
constexpr int MAX_SMEM = 232448;
// Weight items of a chunk: taps x 8 groups of 4 channels x 16 groups of 4
// out channels.
constexpr int ITEMS_PER_TAP = (CK / 4) * (BO / 4);

__device__ __forceinline__ void cp_async_wait_all() {
  s8mma::cp_async_wait<0>();
}

// Byte offset of 16-byte half h of 32-byte row `row`: halves swapped where
// (row / 4) is odd, so rows r and r + 4 of an ldmatrix phase differ in bank.
__device__ __forceinline__ int row_half(int row, int h) {
  return row * ROW + 16 * (h ^ ((row >> 2) & 1));
}

// One weight item: 4 channel rows x 4 out channels, as loaded (word r holds
// out channels o .. o + 3 of channel row r).
using WItem = s8mma::Quad;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
im2col_conv_q8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int* __restrict__ ws, int B, int H, int W, int C, int O,
                      int OH, int OW, int kh, int kw, int sh, int sw, int ph,
                      int pw, int toh, int tow, int col_tiles, int act,
                      int splits) {
  extern __shared__ __align__(16) unsigned char smem_q8[];
  const int win_h = (toh - 1) * sh + kh;
  const int win_w = (tow - 1) * sw + kw;
  const int win_px = win_h * win_w;
  const int taps = kh * kw;
  const int win_bytes = win_px * ROW;
  const int buf_bytes = win_bytes + taps * BO * ROW;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;     // 16-pixel and 32-channel slab
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int o0 = blockIdx.y * BO;
  const int oh0 = (blockIdx.x / col_tiles) * toh;
  const int ow0 = (blockIdx.x % col_tiles) * tow;
  const int ih0 = oh0 * sh - ph;
  const int iw0 = ow0 * sw - pw;
  const int chunks = (C + CK - 1) / CK;
  const int chunk_lo = split * chunks / splits;
  const int chunk_hi = (split + 1) * chunks / splits;
  const bool w_vec =
      O % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 3) == 0;
  const int n_items = taps * ITEMS_PER_TAP;
  const bool w_prefetch = n_items <= W_ITEMS * THREADS;

  // The input window of chunk `chunk` into buffer `buf`, by cp.async.
  auto stage_window = [&](int chunk, int buf) {
    unsigned char* win = smem_q8 + buf * buf_bytes;
    const int c0 = chunk * CK;
    for (int idx = tid; idx < win_px * 2; idx += THREADS) {
      const int px = idx / 2, h = idx % 2;
      const int ih = ih0 + px / win_w, iw = iw0 + px % win_w;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W && c0 + 16 * h < C;
      cp_async16(win + row_half(px, h),
                 in ? x + (((size_t)b * H + ih) * W + iw) * C + c0 + 16 * h : x,
                 in);
    }
  };
  // Item `item` of chunk `chunk`: (tap, group of 4 out channels, group of
  // 4 channels), the channel group fastest; zero past C and O.
  auto load_item = [&](int chunk, int item, WItem& it) {
    const int cg = item % (CK / 4), og = (item / (CK / 4)) % (BO / 4);
    const int tap = item / ITEMS_PER_TAP;
    const int c = chunk * CK + 4 * cg, o = o0 + 4 * og;
    const int8_t* src = w + ((size_t)tap * C + c) * O + o;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t v = 0;
      if (c + r < C) {
        if (w_vec) {
          if (o < O)
            v = __ldg(reinterpret_cast<const uint32_t*>(src + (size_t)r * O));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (o + j < O)
              v |= (uint32_t)(uint8_t)__ldg(src + (size_t)r * O + j) << (8 * j);
        }
      }
      it.w[r] = v;
    }
  };
  // The item turned into 4 words of 4 channels, one per out channel
  // (s8mma::turn_quad), stored as [tap][o][32 channels] rows of buffer
  // `buf`.
  auto store_item = [&](int item, const WItem& it, int buf) {
    unsigned char* wgt = smem_q8 + buf * buf_bytes + win_bytes;
    const int cg = item % (CK / 4), og = (item / (CK / 4)) % (BO / 4);
    const int tap = item / ITEMS_PER_TAP;
    uint32_t v[4];
    s8mma::turn_quad(it, v);
    // Rotated by og % 4, so the 4 groups of a warp store to 4 banks.
    const int r = og & 3;
    const uint32_t t0 = (r & 1) ? v[1] : v[0], t1 = (r & 1) ? v[2] : v[1];
    const uint32_t t2 = (r & 1) ? v[3] : v[2], t3 = (r & 1) ? v[0] : v[3];
    const uint32_t u[4] = {(r & 2) ? t2 : t0, (r & 2) ? t3 : t1,
                           (r & 2) ? t0 : t2, (r & 2) ? t1 : t3};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int row = tap * BO + 4 * og + ((s + r) & 3);
      *reinterpret_cast<uint32_t*>(wgt + row_half(row, cg / 4) +
                                   4 * (cg % 4)) = u[s];
    }
  };

  // This lane's ldmatrix rows of A: tile pixel m -> its window pixel at
  // tap (0, 0), or pixel 0 for rows past the tile (computed, never stored).
  const int a_m = 16 * wm + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_half = lane >> 4;
  int a_px;
  {
    const int r = a_m / tow, q = a_m % tow;
    a_px = a_m < toh * tow ? r * sh * win_w + q * sw : 0;
  }
  // ... and of B: out channel row and half, per pair of n8 tiles.
  const int b_o = 32 * wn + 8 * (lane >> 4) + (lane & 7);
  const int b_half = (lane >> 3) & 1;

  int acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0;

  WItem pre[W_ITEMS];
  stage_window(chunk_lo, 0);
  cp_async_commit();
  for (int item = tid; item < n_items; item += THREADS) {
    WItem it;
    load_item(chunk_lo, item, it);
    store_item(item, it, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const int buf = (chunk - chunk_lo) & 1;
    const bool more = chunk + 1 < chunk_hi;
    if (more) {
      stage_window(chunk + 1, buf ^ 1);
      if (w_prefetch) {
#pragma unroll
        for (int k = 0; k < W_ITEMS; ++k) {
          const int item = tid + k * THREADS;
          if (item < n_items) load_item(chunk + 1, item, pre[k]);
        }
      }
    }
    cp_async_commit();

    const uint32_t win = smem_addr(smem_q8 + buf * buf_bytes);
    const uint32_t wgt = win + win_bytes;
    for (int di = 0; di < kh; ++di) {
      for (int dj = 0; dj < kw; ++dj) {
        const int tap = di * kw + dj;
        uint32_t a[4], bw[2][4];
        ldmatrix_x4(a, win + row_half(a_px + di * win_w + dj, a_half));
#pragma unroll
        for (int pair = 0; pair < 2; ++pair)
          ldmatrix_x4(bw[pair],
                      wgt + row_half(tap * BO + b_o + 16 * pair, b_half));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[ni], a, bw[ni / 2][2 * (ni % 2)],
                 bw[ni / 2][2 * (ni % 2) + 1]);
      }
    }

    if (more) {
      if (w_prefetch) {
#pragma unroll
        for (int k = 0; k < W_ITEMS; ++k) {
          const int item = tid + k * THREADS;
          if (item < n_items) store_item(item, pre[k], buf ^ 1);
        }
      } else {
        for (int item = tid; item < n_items; item += THREADS) {
          WItem it;
          load_item(chunk + 1, item, it);
          store_item(item, it, buf ^ 1);
        }
      }
    }
    // The next chunk has landed in buf ^ 1, and every warp is done with buf.
    cp_async_wait_all();
    __syncthreads();
  }

  // splits == 1: the epilogue into out; else the int32 partial tile into
  // this split's slice of the workspace.
  const int g = lane / 4, t = lane % 4;
  const size_t pixels = (size_t)B * OH * OW;
  const bool pair_ok = O % 2 == 0;
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int m = 16 * wm + g + 8 * hrow;
    if (m >= toh * tow) continue;
    const int oh = oh0 + m / tow, ow = ow0 + m % tow;
    if (oh >= OH || ow >= OW) continue;
    const size_t pix = ((size_t)b * OH + oh) * OW + ow;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int o = o0 + 32 * wn + 8 * ni + 2 * t;
      const int v0 = acc[ni][2 * hrow], v1 = acc[ni][2 * hrow + 1];
      if (splits == 1) {
        float f[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (o + e >= O) continue;
          f[e] = dequant(e ? v1 : v0, __ldg(scale + o + e),
                         bias != nullptr ? __ldg(bias + o + e) : 0.f,
                         bias != nullptr, act);
        }
        float* dst = out + pix * O + o;
        if (pair_ok && o + 1 < O) {
          *reinterpret_cast<float2*>(dst) = make_float2(f[0], f[1]);
        } else {
          if (o < O) dst[0] = f[0];
          if (o + 1 < O) dst[1] = f[1];
        }
      } else {
        int* dst = ws + (split * pixels + pix) * O + o;
        if (pair_ok && o + 1 < O) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          if (o < O) dst[0] = v0;
          if (o + 1 < O) dst[1] = v1;
        }
      }
    }
  }
}

// out = act(float(sum over the splits of ws) * scale + bias), V
// consecutive elements per thread (V = 4 when O % 4 == 0): the shared
// split-K reduce, under this kernel's own name.
template <int V>
__global__ void __launch_bounds__(256)
im2col_conv_q8_splitk_reduce_kernel(const int* __restrict__ ws,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, size_t n, int O,
                                    int splits, int act) {
  s8mma::splitk_reduce<V>(ws, scale, bias, out, n, O, splits, act);
}

// The conv kernel's launch: its window and weight rows double-buffered in
// dynamic shared memory (the limit raised on the current device where it
// passes 48 KB), one block a (row tile, column tile) x 64 out channels x
// image x split.  cudaErrorInvalidValue where the buffers pass MAX_SMEM.
cudaError_t plan_conv_q8(int B, int O, int OH, int OW, int kh, int kw,
                         int sh, int sw, int toh, int tow, int splits,
                         describe::Launch* l) {
  const int win_px = ((toh - 1) * sh + kh) * ((tow - 1) * sw + kw);
  const size_t smem = 2 * (size_t)(win_px + kh * kw * BO) * ROW;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // The limit raised on each device so far (0: the default 48 KB).
  static size_t smem_limit[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && smem > smem_limit[dev]) {
    err = cudaFuncSetAttribute(im2col_conv_q8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_limit[dev] = smem;
  }
  const int row_tiles = (OH + toh - 1) / toh;
  const int col_tiles = (OW + tow - 1) / tow;
  l->grid = dim3(row_tiles * col_tiles, (O + BO - 1) / BO, B * splits);
  l->threads = THREADS;
  l->smem = smem;
  l->stages = 2;
  l->func = (const void*)&im2col_conv_q8_kernel;
  return cudaSuccess;
}

// The reduce's launch over the B x OH x OW x O output.
describe::Launch plan_conv_q8_reduce(int B, int O, int OH, int OW) {
  return describe::reduce(
      (size_t)B * OH * OW * O, O,
      (const void*)&im2col_conv_q8_splitk_reduce_kernel<4>,
      (const void*)&im2col_conv_q8_splitk_reduce_kernel<1>);
}

}  // namespace

// out (B, OH, OW, O) = act(float(conv(x_q, w_q)) * scale + bias), x_q
// (B, H, W, C), w_q (kh, kw, C, O) int8.  C % 16 == 0, x 16-byte aligned,
// toh * tow <= 64, 1 <= splits <= ceil(C / 32); bias may be null; ws holds
// splits * B * OH * OW * O int32 when splits > 1 (else it may be null).
// Returns cudaGetLastError().
extern "C" int repro_im2col_conv_q8(const int8_t* x, const int8_t* w,
                                    const float* scale, const float* bias,
                                    float* out, int* ws, int B, int H, int W,
                                    int C, int O, int OH, int OW, int kh,
                                    int kw, int sh, int sw, int ph, int pw,
                                    int toh, int tow, int act, int splits,
                                    cudaStream_t stream) {
  const int chunks = (C + CK - 1) / CK;
  if (C % 16 != 0 || toh * tow > PIX || toh < 1 || tow < 1 || splits < 1 ||
      splits > chunks || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  cudaError_t err =
      plan_conv_q8(B, O, OH, OW, kh, kw, sh, sw, toh, tow, splits, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (OW + tow - 1) / tow;
  im2col_conv_q8_kernel<<<l.grid, l.threads, l.smem, stream>>>(
      x, w, scale, bias, out, ws, B, H, W, C, O, OH, OW, kh, kw, sh, sw, ph,
      pw, toh, tow, col_tiles, act, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * OH * OW * O;
  const describe::Launch red = plan_conv_q8_reduce(B, O, OH, OW);
  if (O % 4 == 0)
    im2col_conv_q8_splitk_reduce_kernel<4><<<red.grid, red.threads, 0,
                                             stream>>>(ws, scale, bias, out,
                                                       n, O, splits, act);
  else
    im2col_conv_q8_splitk_reduce_kernel<1><<<red.grid, red.threads, 0,
                                             stream>>>(ws, scale, bias, out,
                                                       n, O, splits, act);
  return static_cast<int>(cudaGetLastError());
}

// What repro_im2col_conv_q8 launches for args = (B, H, W, C, O, OH, OW,
// kh, kw, sh, sw, ph, pw, toh, tow, splits): the conv kernel (which 0) or
// the reduce (which 1), as describe.cuh lays it out.
extern "C" int repro_im2col_conv_q8_describe(const int* args, int nargs,
                                             int which, long long* out) {
  if (nargs != 16 || which < 0 || which > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int B = args[0], O = args[4], OH = args[5], OW = args[6];
  const int toh = args[13], tow = args[14], splits = args[15];
  if (B < 1 || O < 1 || OH < 1 || OW < 1 || toh < 1 || tow < 1 ||
      toh * tow > PIX || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  if (which == 1) {
    l = plan_conv_q8_reduce(B, O, OH, OW);
  } else {
    const cudaError_t err = plan_conv_q8(B, O, OH, OW, args[7], args[8],
                                         args[9], args[10], toh, tow, splits,
                                         &l);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return describe::write(l, out);
}
