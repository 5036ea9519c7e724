// Implicit-GEMM (fused im2col + GEMM) bf16 and fp16 convolution, NHWC /
// HWIO, for sm_90a, on the tensor cores (mma.sync m16n8k16, fp32 sums),
// with split-K and a fused bias + activation epilogue.
//
// Replaces the 16-bit bodies of the TPU kernel
// src/repro/kernels/im2col_gemm/kernel.py::conv2d_im2col_gemm_pallas
// (_accumulate_taps, _conv_kernel, _conv_bias_kernel): out = act(conv(x, w)
// + bias), x (B, H, W, C) and w (kh, kw, C, O) of one 16-bit type T, bias
// fp32, out of type T (the TPU kernel writes x.dtype).  The products are
// summed in fp32; bias and activation act on the fp32 sum, rounded to T
// once, at the store.
//
// Design.  The shape of the int8 kernel im2col_conv_q8.cu, on 16-bit
// operands.  The TPU kernel keeps a whole padded image slab per program and
// walks the in-channel blocks as a sequential grid axis into an fp32 VMEM
// accumulator.  Here one block owns a toh x tow output tile (toh * tow <=
// 64) of one image and 64 out channels: a 64 x 64 fp32 tile of the GEMM
// whose rows are output pixels and whose K runs over (channel chunk, tap,
// 16 channels).  Its 8 warps (4 x 2) each hold a 16 pixel x 32 channel
// slab as m16n8k16 accumulators: one k16 step is one tap of 16 channels, so
// A's rows are the tile's pixels read through that tap's offset into the
// staged input window (ldmatrix takes any row address), and B is the tap's
// weights, read transposed by ldmatrix.x4.trans from rows of out channels,
// so the HWIO weights are copied as they lie.
//
// Staging.  Per chunk of 16 channels the block needs the input window of
// its tile — (toh-1)*sh + kh rows by (tow-1)*sw + kw columns, the halo
// included, 32 bytes a pixel — and the (kh*kw, 16, 64) weight slice; both
// go by cp.async, 16 bytes a copy, into the idle one of two buffers while
// the block computes from the other, one barrier a chunk.  The window is
// zero-filled outside the image (the conv's padding: the caller pads
// nothing spatially) and past C (C % 16 == 8 leaves the last chunk's upper
// half zero); the weights past C and O.  Weight rows where O % 8 != 0 go
// value by value through registers.  Each 32-byte window row keeps its two
// 16-byte halves swapped where (row / 4) is odd, so the 8 rows of an
// ldmatrix phase fall on distinct banks at stride 1; the weight rows are
// padded to 144 bytes for the same reason.
//
// Split-K.  As the int8 kernel: the chunks are cut into `splits`
// contiguous ranges on the grid's z axis beside the image
// (ops.py::call_splits_16 picks splits from the shape and
// RESIDENT_BLOCKS_16, this kernel's __launch_bounds__ minimum).  With
// splits > 1 each block writes its fp32 partial tile to a workspace
// (splits, B*OH*OW, O), and im2col16_conv_splitk_reduce_kernel adds the
// partials in split order, applies the epilogue and rounds; with splits ==
// 1 the conv kernel does.
//
// What bounds it.  At batch 1 the layers are small (0.1-1.4 GFLOP): a
// call is a few chunks' latency — the weight slice from L2, the window
// from device memory — far below the 989 TFLOP/s of the tensor cores.
// Inside a chunk, 3 ldmatrix.x4 feed 4 mma per warp and tap.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmma16.cuh"

namespace {

namespace hm = hmma16;

constexpr int CK = 16;         // channels per chunk: one k16 step per tap
constexpr int BO = 64;         // out channels per block
constexpr int PIX = 64;        // output pixels per block (toh * tow <= PIX)
constexpr int THREADS = 256;   // 8 warps: 4 over pixels x 2 over channels
constexpr int MIN_BLOCKS = 2;  // __launch_bounds__ minimum blocks a SM
constexpr int ROW = CK * 2;    // bytes of a window pixel's chunk
constexpr int W_ROW = (BO + 8) * 2;  // bytes of a weight row (64 out ch)
constexpr int MAX_SMEM = 232448;

// Byte offset of 16-byte half h of 32-byte row `row`: halves swapped where
// (row / 4) is odd, so rows r and r + 4 of an ldmatrix phase differ in bank.
__device__ __forceinline__ int row_half(int row, int h) {
  return row * ROW + 16 * (h ^ ((row >> 2) & 1));
}

template <class T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
im2col16_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ ws, int B, int H, int W, int C, int O,
                     int OH, int OW, int kh, int kw, int sh, int sw, int ph,
                     int pw, int toh, int tow, int col_tiles, int act,
                     int splits) {
  extern __shared__ __align__(16) unsigned char smem_16[];
  const int win_h = (toh - 1) * sh + kh;
  const int win_w = (tow - 1) * sw + kw;
  const int win_px = win_h * win_w;
  const int taps = kh * kw;
  const int win_bytes = win_px * ROW;
  const int buf_bytes = win_bytes + taps * CK * W_ROW;

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
      O % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  // The input window of chunk `chunk` into buffer `buf`.
  auto stage_window = [&](int chunk, int buf) {
    unsigned char* win = smem_16 + buf * buf_bytes;
    const int c0 = chunk * CK;
    for (int idx = tid; idx < win_px * 2; idx += THREADS) {
      const int px = idx / 2, h = idx % 2;
      const int ih = ih0 + px / win_w, iw = iw0 + px % win_w;
      const bool in =
          ih >= 0 && ih < H && iw >= 0 && iw < W && c0 + 8 * h < C;
      hm::cp_async16(
          win + row_half(px, h),
          in ? x + (((size_t)b * H + ih) * W + iw) * C + c0 + 8 * h : x, in);
    }
  };
  // The weights of chunk `chunk` into buffer `buf`, as [tap][16 channels]
  // rows of 64 out channels: 8 groups of 8 a row, zero past C and O.
  auto stage_weights = [&](int chunk, int buf) {
    unsigned char* wgt = smem_16 + buf * buf_bytes + win_bytes;
    const int c0 = chunk * CK;
    for (int idx = tid; idx < taps * CK * (BO / 8); idx += THREADS) {
      const int g = idx % (BO / 8), row = idx / (BO / 8);
      const int tap = row / CK, c = c0 + row % CK, o = o0 + 8 * g;
      unsigned char* dst = wgt + row * W_ROW + 16 * g;
      const size_t off = ((size_t)tap * C + c) * O + o;
      if (w_vec) {
        const bool in = c < C && o < O;
        hm::cp_async16(dst, in ? w + off : w, in);
      } else {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(w) + off;
        uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = c < C && o + e < O ? src[e] : uint16_t(0);
      }
    }
  };

  // This lane's ldmatrix rows of A: tile pixel m -> its window pixel at
  // tap (0, 0), or pixel 0 for rows past the tile (computed, never stored).
  const int a_m = 16 * wm + hm::a_frag_row(lane);
  const int a_half = hm::a_frag_col(lane) / 8;
  int a_px;
  {
    const int r = a_m / tow, q = a_m % tow;
    a_px = a_m < toh * tow ? r * sh * win_w + q * sw : 0;
  }
  // ... and of B: the weight row (channel) and out channel of this lane,
  // per pair of n8 tiles.
  const int b_k = hm::b_frag_k(lane);
  const int b_n = 32 * wn + hm::b_frag_n(lane);

  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  stage_window(chunk_lo, 0);
  stage_weights(chunk_lo, 0);
  hm::cp_async_commit();
  hm::cp_async_wait<0>();
  __syncthreads();

  for (int chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const int buf = (chunk - chunk_lo) & 1;
    if (chunk + 1 < chunk_hi) {
      stage_window(chunk + 1, buf ^ 1);
      stage_weights(chunk + 1, buf ^ 1);
    }
    hm::cp_async_commit();

    const uint32_t win = hm::smem_addr(smem_16 + buf * buf_bytes);
    const uint32_t wgt = win + win_bytes;
    for (int di = 0; di < kh; ++di) {
      for (int dj = 0; dj < kw; ++dj) {
        const int tap = di * kw + dj;
        uint32_t a[4], bw[2][4];
        hm::ldsm_x4(a, win + row_half(a_px + di * win_w + dj, a_half));
#pragma unroll
        for (int pair = 0; pair < 2; ++pair)
          hm::ldsm_x4_trans(bw[pair], wgt + (tap * CK + b_k) * W_ROW +
                                          2 * (b_n + 16 * pair));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          hm::mma16<T>(acc[ni], a, bw[ni / 2][2 * (ni % 2)],
                       bw[ni / 2][2 * (ni % 2) + 1]);
      }
    }
    // The next chunk has landed in buf ^ 1, and every warp is done with buf.
    hm::cp_async_wait<0>();
    __syncthreads();
  }

  // splits == 1: the epilogue, rounded into out; else the fp32 partial
  // tile into this split's slice of the workspace.
  const int g = lane / 4, t = lane % 4;
  const size_t pixels = (size_t)B * OH * OW;
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
      float v0 = acc[ni][2 * hrow], v1 = acc[ni][2 * hrow + 1];
      if (splits == 1) {
        v0 = hm::activate(v0 + (bias != nullptr && o < O ? __ldg(bias + o)
                                                          : 0.f), act);
        v1 = hm::activate(v1 + (bias != nullptr && o + 1 < O
                                    ? __ldg(bias + o + 1) : 0.f), act);
        hm::store_pair16(out + pix * O, 0, 0, o, O, v0, v1);
      } else {
        hm::store_pair32(ws + (split * pixels + pix) * O, 0, 0, o, O, v0,
                         v1);
      }
    }
  }
}

// out = act(sum over the splits of ws + bias) rounded to T, V consecutive
// elements per thread (V = 4 when O % 4 == 0).
template <class T, int V>
__global__ void __launch_bounds__(256)
im2col16_conv_splitk_reduce_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ bias,
                                   T* __restrict__ out, size_t n, int O,
                                   int splits, int act) {
  hm::splitk_reduce<T, V>(ws, bias, out, n, O, splits, act);
}

template <class T>
int launch(const T* x, const T* w, const float* bias, T* out, float* ws,
           int B, int H, int W, int C, int O, int OH, int OW, int kh, int kw,
           int sh, int sw, int ph, int pw, int toh, int tow, int act,
           int splits, cudaStream_t stream) {
  const int win_px = ((toh - 1) * sh + kh) * ((tow - 1) * sw + kw);
  const size_t smem =
      2 * ((size_t)win_px * ROW + (size_t)kh * kw * CK * W_ROW);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_limit = 48 * 1024;
  if (smem > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        im2col16_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem;
  }
  const int row_tiles = (OH + toh - 1) / toh;
  const int col_tiles = (OW + tow - 1) / tow;
  const dim3 grid(row_tiles * col_tiles, (O + BO - 1) / BO, B * splits);
  im2col16_conv_kernel<T><<<grid, THREADS, smem, stream>>>(
      x, w, bias, out, ws, B, H, W, C, O, OH, OW, kh, kw, sh, sw, ph, pw, toh,
      tow, col_tiles, act, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * OH * OW * O;
  if (O % 4 == 0) {
    const unsigned blocks = static_cast<unsigned>((n / 4 + 255) / 256);
    im2col16_conv_splitk_reduce_kernel<T, 4><<<blocks, 256, 0, stream>>>(
        ws, bias, out, n, O, splits, act);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    im2col16_conv_splitk_reduce_kernel<T, 1><<<blocks, 256, 0, stream>>>(
        ws, bias, out, n, O, splits, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, OH, OW, O) = act(conv(x, w) + bias), x (B, H, W, C) and w (kh,
// kw, C, O) bf16 (dtype 0) or fp16 (dtype 1), bias fp32 or null, out of
// the same type.  C % 8 == 0, x and out 16-byte aligned, toh * tow <= 64,
// 1 <= splits <= ceil(C / 16); ws holds splits * B * OH * OW * O floats
// when splits > 1 (else it may be null).  Returns cudaGetLastError().
extern "C" int repro_im2col_conv16(const void* x, const void* w,
                                   const float* bias, void* out, float* ws,
                                   int B, int H, int W, int C, int O, int OH,
                                   int OW, int kh, int kw, int sh, int sw,
                                   int ph, int pw, int toh, int tow, int act,
                                   int splits, int dtype,
                                   cudaStream_t stream) {
  const int chunks = (C + CK - 1) / CK;
  if (C % 8 != 0 || C < 8 || toh * tow > PIX || toh < 1 || tow < 1 ||
      splits < 1 || splits > chunks || (splits > 1 && ws == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w), bias,
                  static_cast<__nv_bfloat16*>(out), ws, B, H, W, C, O, OH, OW,
                  kh, kw, sh, sw, ph, pw, toh, tow, act, splits, stream);
  return launch(static_cast<const __half*>(x), static_cast<const __half*>(w),
                bias, static_cast<__half*>(out), ws, B, H, W, C, O, OH, OW,
                kh, kw, sh, sw, ph, pw, toh, tow, act, splits, stream);
}
