// Implicit-GEMM (fused im2col + GEMM) fp32 convolution, NHWC / HWIO, for
// sm_90a, with a fused bias + activation epilogue.
//
// Replaces the TPU kernel
// src/repro/kernels/im2col_gemm/kernel.py::conv2d_im2col_gemm_pallas
// (fp32 bodies): out = act(conv(x, w) + bias) without an im2col matrix in
// device memory.
//
// Design.  The TPU kernel keeps a whole padded image slab (1, Hp, Wp, bc)
// resident per program and walks the in-channel blocks as a sequential
// "arbitrary" grid axis.  A Hopper block has at most 227 KB of shared
// memory (a 608x608 slab of 8 channels alone is 11 MB), and blocks run in
// parallel.  So one block owns one output tile of toh x tow pixels
// (toh * tow <= 64) of one image and 64 out channels; the in-channel
// reduction is a loop inside the block with the 64x64 accumulator in
// registers (a 4 pixel x 4 channel micro-tile per thread).  Each step of
// the loop stages, for BC = 8 channels, the input window the tile needs —
// (toh-1)*sh + kh rows by (tow-1)*sw + kw columns, the halo included — and
// the (kh, kw, BC, 64) weight slice in shared memory; every tap then reads
// its shifted, strided view of the window.  The conv's zero padding is
// applied while staging (out-of-image reads load 0), so the caller pads
// nothing spatially; out channels and the ragged last row/column tile are
// masked.  Bias and activation run once, after the last channel chunk.
//
// What bounds it.  The deep 13x13 layers of YOLOv3-tiny (K = 9 * 512) are
// operation-bound in principle, but a 13x13 map gives only 4 row tiles, so
// at batch 1 a 1024-channel layer launches 64 blocks for 132 SMs.  Inside
// the loop, shared-memory loads (16 LDS.128 per 128 FMA) limit the rate.
// fp32 FMA on CUDA cores only, no TF32.
#include <cuda_runtime.h>

namespace {

constexpr int BC = 8;        // in channels per reduction step (C % BC == 0)
constexpr int BO = 64;       // out channels per block
constexpr int PIX = 64;      // output pixels per block (toh * tow <= PIX)
constexpr int TP = 4;        // pixels per thread
constexpr int TO = 4;        // out channels per thread
constexpr int THREADS = 256; // (PIX / TP) * (BO / TO)

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

__global__ void __launch_bounds__(THREADS)
im2col_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int C, int O, int OH, int OW, int kh, int kw,
                   int sh, int sw, int ph, int pw, int toh, int tow,
                   int col_tiles, int act) {
  extern __shared__ __align__(16) float smem[];
  const int win_h = (toh - 1) * sh + kh;
  const int win_w = (tow - 1) * sw + kw;
  const int win_px = win_h * win_w;
  const int taps = kh * kw;
  float* win = smem;                      // [win_px][BC]
  float* wgt = smem + win_px * BC;        // [taps][BC][BO]

  const int tid = threadIdx.x;
  const int tx = tid % (BO / TO);         // out-channel group
  const int ty = tid / (BO / TO);         // pixel group
  const int b = blockIdx.z;
  const int o0 = blockIdx.y * BO;
  const int oh0 = (blockIdx.x / col_tiles) * toh;
  const int ow0 = (blockIdx.x % col_tiles) * tow;
  const int ih0 = oh0 * sh - ph;
  const int iw0 = ow0 * sw - pw;

  // This thread's pixels: m = ty + 16 * i within the toh x tow tile.
  int pix_off[TP];
  bool pix_ok[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int m = ty + (PIX / TP) * i;
    const int r = m / tow, q = m % tow;
    pix_ok[i] = m < toh * tow && oh0 + r < OH && ow0 + q < OW;
    pix_off[i] = pix_ok[i] ? (r * sh * win_w + q * sw) * BC : 0;
  }

  float acc[TP][TO];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    // Stage the input window (zero outside the image: the conv padding).
    for (int idx = tid; idx < win_px * (BC / 4); idx += THREADS) {
      const int px = idx / (BC / 4), v = idx % (BC / 4);
      const int ih = ih0 + px / win_w, iw = iw0 + px % win_w;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        val = __ldg(reinterpret_cast<const float4*>(
            x + (((size_t)b * H + ih) * W + iw) * C + c0 + 4 * v));
      reinterpret_cast<float4*>(win)[idx] = val;
    }
    // Stage the (taps, BC, BO) weight slice (zero past the last out channel).
    for (int idx = tid; idx < taps * BC * BO; idx += THREADS) {
      const int ol = idx % BO, rest = idx / BO;
      const int c = rest % BC, tap = rest / BC;
      const int o = o0 + ol;
      wgt[idx] = o < O ? __ldg(w + ((size_t)tap * C + c0 + c) * O + o) : 0.f;
    }
    __syncthreads();

    for (int di = 0; di < kh; ++di) {
      for (int dj = 0; dj < kw; ++dj) {
        const int tap_off = (di * win_w + dj) * BC;
        const float* wt = wgt + (di * kw + dj) * BC * BO + tx * TO;
        float a[TP][BC];
#pragma unroll
        for (int i = 0; i < TP; ++i) {
          const float4 lo =
              *reinterpret_cast<const float4*>(win + pix_off[i] + tap_off);
          const float4 hi =
              *reinterpret_cast<const float4*>(win + pix_off[i] + tap_off + 4);
          a[i][0] = lo.x; a[i][1] = lo.y; a[i][2] = lo.z; a[i][3] = lo.w;
          a[i][4] = hi.x; a[i][5] = hi.y; a[i][6] = hi.z; a[i][7] = hi.w;
        }
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + c * BO);
#pragma unroll
          for (int i = 0; i < TP; ++i) {
            acc[i][0] = fmaf(a[i][c], wv.x, acc[i][0]);
            acc[i][1] = fmaf(a[i][c], wv.y, acc[i][1]);
            acc[i][2] = fmaf(a[i][c], wv.z, acc[i][2]);
            acc[i][3] = fmaf(a[i][c], wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TP; ++i) {
    if (!pix_ok[i]) continue;
    const int m = ty + (PIX / TP) * i;
    const int oh = oh0 + m / tow, ow = ow0 + m % tow;
    float* dst = out + (((size_t)b * OH + oh) * OW + ow) * O;
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const int o = o0 + tx * TO + j;
      if (o >= O) continue;
      const float v = acc[i][j] + (bias != nullptr ? __ldg(bias + o) : 0.f);
      dst[o] = activate(v, act);
    }
  }
}

}  // namespace

// out (B, OH, OW, O) = act(conv(x (B, H, W, C), w (kh, kw, C, O)) + bias).
// C % 8 == 0, toh * tow <= 64; bias may be null.  Returns cudaGetLastError().
extern "C" int repro_im2col_conv(const float* x, const float* w,
                                 const float* bias, float* out, int B, int H,
                                 int W, int C, int O, int OH, int OW, int kh,
                                 int kw, int sh, int sw, int ph, int pw,
                                 int toh, int tow, int act,
                                 cudaStream_t stream) {
  if (C % BC != 0 || toh * tow > PIX || toh < 1 || tow < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int win_px = ((toh - 1) * sh + kh) * ((tow - 1) * sw + kw);
  const size_t smem = (size_t)(win_px * BC + kh * kw * BC * BO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        im2col_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_tiles = (OH + toh - 1) / toh;
  const int col_tiles = (OW + tow - 1) / tow;
  const dim3 grid(row_tiles * col_tiles, (O + BO - 1) / BO, B);
  im2col_conv_kernel<<<grid, THREADS, smem, stream>>>(
      x, w, bias, out, H, W, C, O, OH, OW, kh, kw, sh, sw, ph, pw, toh, tow,
      col_tiles, act);
  return static_cast<int>(cudaGetLastError());
}
