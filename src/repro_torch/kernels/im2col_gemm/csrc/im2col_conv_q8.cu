// Implicit-GEMM (fused im2col + GEMM) int8 convolution, NHWC / HWIO, for
// sm_90a: int32 accumulation, fused fp32 dequant + bias + activation.
//
// Replaces the int8 bodies of the TPU kernel
// src/repro/kernels/im2col_gemm/kernel.py::conv2d_im2col_gemm_pallas
// (_accumulate_taps_q8, _conv_q8_kernel, _conv_q8_bias_kernel, :97-159):
// out = act(float(conv(x_q, w_q)) * scale + bias), x_q (B, H, W, C) and
// w_q (kh, kw, C, O) int8, scale and bias (O,) fp32, out fp32.
//
// Design.  The fp32 kernel's tiling (im2col_conv.cu), in int8.  The TPU
// kernel keeps a whole padded image slab per program and walks the
// in-channel blocks as a sequential grid axis into an int32 VMEM
// accumulator; here one block owns a toh x tow output tile (toh * tow <=
// 64) of one image and 64 out channels, and the in-channel reduction is a
// loop inside the block with the 64x64 int32 accumulator in registers (a
// 4 pixel x 4 channel micro-tile per thread).  Each step of the loop
// stages, for BC = 16 channels, the input window of the tile — (toh-1)*sh
// + kh rows by (tow-1)*sw + kw columns, the halo included — one 16-byte
// load per pixel, and the (kh, kw, 16, 64) weight slice, packed as words
// of 4 channels.  The conv's zero padding is applied while staging, so the
// caller pads nothing spatially; out channels and the ragged last row and
// column tiles are masked.  The inner product is __dp4a (4 signed byte
// products into an int32 per instruction), exact: the wrapper refuses K =
// kh*kw*C with K * 127^2 >= 2^31.  The epilogue runs once, after the last
// channel step: float(acc) * scale[o] + bias[o], each rounded on its own
// (no FMA contraction), then the activation.
//
// What bounds it.  As the fp32 kernel: YOLOv3-tiny's 13x13 layers give 4
// row tiles, so at batch 1 a 512-channel layer launches 32 blocks for 132
// SMs; inside the loop shared-memory loads (8 LDS.128 per 64 dp4a) and
// dp4a's issue rate limit it.  It reads a quarter of the fp32 kernel's
// operand bytes and does 4 multiply-adds per instruction.  The int8 tensor
// cores are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BC = 16;       // in channels per reduction step (C % BC == 0)
constexpr int BC4 = BC / 4;  // packed words per pixel and step
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
im2col_conv_q8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int H, int W, int C, int O, int OH, int OW, int kh,
                      int kw, int sh, int sw, int ph, int pw, int toh, int tow,
                      int col_tiles, int act) {
  extern __shared__ __align__(16) int smem_q8[];
  const int win_h = (toh - 1) * sh + kh;
  const int win_w = (tow - 1) * sw + kw;
  const int win_px = win_h * win_w;
  const int taps = kh * kw;
  int* win = smem_q8;                     // [win_px][BC4]
  int* wgt = smem_q8 + win_px * BC4;      // [taps][BC4][BO]

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
    pix_off[i] = pix_ok[i] ? (r * sh * win_w + q * sw) * BC4 : 0;
  }

  int acc[TP][TO];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < C; c0 += BC) {
    // Stage the input window, 16 channels (one int4) per pixel; zero
    // outside the image: the conv padding.
    for (int px = tid; px < win_px; px += THREADS) {
      const int ih = ih0 + px / win_w, iw = iw0 + px % win_w;
      int4 val = make_int4(0, 0, 0, 0);
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        val = __ldg(reinterpret_cast<const int4*>(
            x + (((size_t)b * H + ih) * W + iw) * C + c0));
      reinterpret_cast<int4*>(win)[px] = val;
    }
    // Stage the (taps, BC4, BO) packed weight slice (zero past the last
    // out channel): word (tap, c4, o) holds channels 4*c4 .. 4*c4+3.
    for (int idx = tid; idx < taps * BC4 * BO; idx += THREADS) {
      const int ol = idx % BO, rest = idx / BO;
      const int c4 = rest % BC4, tap = rest / BC4;
      const int o = o0 + ol;
      int word = 0;
      if (o < O) {
        const int8_t* src = w + ((size_t)tap * C + c0 + 4 * c4) * O + o;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          word |= (int)(uint8_t)__ldg(src + (size_t)r * O) << (8 * r);
      }
      wgt[idx] = word;
    }
    __syncthreads();

    for (int di = 0; di < kh; ++di) {
      for (int dj = 0; dj < kw; ++dj) {
        const int tap_off = (di * win_w + dj) * BC4;
        const int* wt = wgt + (di * kw + dj) * BC4 * BO + tx * TO;
        int a[TP][BC4];
#pragma unroll
        for (int i = 0; i < TP; ++i) {
          const int4 v =
              *reinterpret_cast<const int4*>(win + pix_off[i] + tap_off);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
#pragma unroll
        for (int c4 = 0; c4 < BC4; ++c4) {
          const int4 wv = *reinterpret_cast<const int4*>(wt + c4 * BO);
#pragma unroll
          for (int i = 0; i < TP; ++i) {
            acc[i][0] = __dp4a(a[i][c4], wv.x, acc[i][0]);
            acc[i][1] = __dp4a(a[i][c4], wv.y, acc[i][1]);
            acc[i][2] = __dp4a(a[i][c4], wv.z, acc[i][2]);
            acc[i][3] = __dp4a(a[i][c4], wv.w, acc[i][3]);
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
      float v = __fmul_rn(__int2float_rn(acc[i][j]), __ldg(scale + o));
      if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + o));
      dst[o] = activate(v, act);
    }
  }
}

}  // namespace

// out (B, OH, OW, O) = act(float(conv(x_q, w_q)) * scale + bias), x_q
// (B, H, W, C), w_q (kh, kw, C, O) int8.  C % 16 == 0, x 16-byte aligned,
// toh * tow <= 64; bias may be null.  Returns cudaGetLastError().
extern "C" int repro_im2col_conv_q8(const int8_t* x, const int8_t* w,
                                    const float* scale, const float* bias,
                                    float* out, int B, int H, int W, int C,
                                    int O, int OH, int OW, int kh, int kw,
                                    int sh, int sw, int ph, int pw, int toh,
                                    int tow, int act, cudaStream_t stream) {
  if (C % BC != 0 || toh * tow > PIX || toh < 1 || tow < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int win_px = ((toh - 1) * sh + kh) * ((tow - 1) * sw + kw);
  const size_t smem =
      (size_t)(win_px * BC4 + kh * kw * BC4 * BO) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        im2col_conv_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_tiles = (OH + toh - 1) / toh;
  const int col_tiles = (OW + tow - 1) / tow;
  const dim3 grid(row_tiles * col_tiles, (O + BO - 1) / BO, B);
  im2col_conv_q8_kernel<<<grid, THREADS, smem, stream>>>(
      x, w, scale, bias, out, H, W, C, O, OH, OW, kh, kw, sh, sw, ph, pw, toh,
      tow, col_tiles, act);
  return static_cast<int>(cudaGetLastError());
}
