// Implicit-GEMM (fused im2col + GEMM) fp32 convolution, NHWC / HWIO, for
// sm_90a, with a fused bias + activation epilogue and split-K.
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
// (toh * tow <= 64) of one image and 64 out channels, with the 64x64
// accumulator in registers (a 4 pixel x 4 channel micro-tile per thread).
// Each step of its reduction stages, for BC = 8 channels, the input window
// the tile needs — (toh-1)*sh + kh rows by (tow-1)*sw + kw columns, the
// halo included — and the (kh, kw, BC, 64) weight slice in shared memory;
// every tap then reads its shifted, strided view of the window.
//
// Asynchronous staging.  Both are copied by cp.async, 16 bytes a thread,
// into the second of two buffers while the step before computes from the
// first; one barrier per step orders both.  The conv's zero padding is
// the copies' zero fill (out-of-image pixels read 0 bytes), so the caller
// pads nothing spatially; weights past the last out channel are zero
// filled the same way (when O is not a multiple of 4, the weight slice is
// loaded with plain loads instead, still into the idle buffer).
//
// Split-K.  A 13x13 map gives only 4 row tiles, so at batch 1 a 512-
// channel layer has 32 blocks of 256 threads for 132 SMs.  The reduction
// over the C / 8 channel chunks (each with all kh * kw taps) is cut into
// `splits` contiguous ranges, chunk [s * n / splits, (s + 1) * n / splits)
// for split s of n chunks, on the grid's z axis beside the image; the
// wrapper picks `splits` from the shape (ops.py::split_k).  With splits > 1
// each block writes its fp32 partial tile to a workspace (splits, B*OH*OW,
// O) and im2col_conv_splitk_reduce_kernel sums the partials in split
// order — deterministic, no atomics — then adds the bias and applies the
// activation; with splits == 1 the conv kernel does that epilogue itself.
// Out channels and the ragged last row/column tile are masked.
//
// What bounds it.  The deep 13x13 layers of YOLOv3-tiny (K = 9 * 512) are
// operation-bound, at the 67 TFLOP/s fp32 CUDA-core peak: fp32 FMA only,
// no TF32.  Inside a step, shared-memory loads (16 LDS.128 per 128 FMA per
// thread) and the 52-of-64 pixels a 13-wide row tile uses hold the rate
// below that peak; 256 threads and at most 128 registers a thread keep two
// blocks on each SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "describe.cuh"
#include "per_device.cuh"

namespace {

constexpr int BC = 8;        // in channels per reduction step (C % BC == 0)
constexpr int BO = 64;       // out channels per block
constexpr int PIX = 64;      // output pixels per block (toh * tow <= PIX)
constexpr int TP = 4;        // pixels per thread
constexpr int TO = 4;        // out channels per thread
constexpr int THREADS = 256; // (PIX / TP) * (BO / TO)
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : 0.1f * v;
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
im2col_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ ws, int B, int H, int W, int C, int O,
                   int OH, int OW, int kh, int kw, int sh, int sw, int ph,
                   int pw, int toh, int tow, int col_tiles, int act,
                   int splits) {
  extern __shared__ __align__(16) float smem[];
  const int win_h = (toh - 1) * sh + kh;
  const int win_w = (tow - 1) * sw + kw;
  const int win_px = win_h * win_w;
  const int taps = kh * kw;
  const int buf_floats = win_px * BC + taps * BC * BO;

  const int tid = threadIdx.x;
  const int tx = tid % (BO / TO);         // out-channel group
  const int ty = tid / (BO / TO);         // pixel group
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int o0 = blockIdx.y * BO;
  const int oh0 = (blockIdx.x / col_tiles) * toh;
  const int ow0 = (blockIdx.x % col_tiles) * tow;
  const int ih0 = oh0 * sh - ph;
  const int iw0 = ow0 * sw - pw;
  const bool o_vec = O % 4 == 0;
  const int chunks = C / BC;
  const int chunk_lo = split * chunks / splits;
  const int chunk_hi = (split + 1) * chunks / splits;

  // Copies of chunk c's window and weight slice into buffer buf.
  auto stage = [&](int chunk, int buf) {
    float* win = smem + buf * buf_floats;   // [win_px][BC]
    float* wgt = win + win_px * BC;         // [taps][BC][BO]
    const int c0 = chunk * BC;
    for (int idx = tid; idx < win_px * (BC / 4); idx += THREADS) {
      const int px = idx / (BC / 4), v = idx % (BC / 4);
      const int ih = ih0 + px / win_w, iw = iw0 + px % win_w;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      cp_async16(win + 4 * idx,
                 in ? x + (((size_t)b * H + ih) * W + iw) * C + c0 + 4 * v : x,
                 in);
    }
    if (o_vec) {
      for (int idx = tid; idx < taps * BC * (BO / 4); idx += THREADS) {
        const int o = o0 + 4 * (idx % (BO / 4));
        const int rest = idx / (BO / 4);    // tap * BC + c
        const int c = rest % BC, tap = rest / BC;
        cp_async16(wgt + 4 * idx,
                   o < O ? w + ((size_t)tap * C + c0 + c) * O + o : w, o < O);
      }
    } else {
      for (int idx = tid; idx < taps * BC * BO; idx += THREADS) {
        const int o = o0 + idx % BO, rest = idx / BO;
        const int c = rest % BC, tap = rest / BC;
        wgt[idx] = o < O ? __ldg(w + ((size_t)tap * C + c0 + c) * O + o) : 0.f;
      }
    }
  };

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

  stage(chunk_lo, 0);
  cp_async_commit();
  for (int chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const int buf = (chunk - chunk_lo) & 1;
    // This chunk has landed in buf, and every thread is done with the
    // other buffer, which the next chunk now takes.
    cp_async_wait_all();
    __syncthreads();
    if (chunk + 1 < chunk_hi) stage(chunk + 1, buf ^ 1);
    cp_async_commit();

    const float* win = smem + buf * buf_floats;
    const float* wgt = win + win_px * BC;
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
  }
  cp_async_wait_all();

  // splits == 1: act(acc + bias) into out; else the partial sums into
  // this split's slice of the workspace.
  const size_t pixels = (size_t)B * OH * OW;
  float* dst_base = splits == 1 ? out : ws + split * pixels * O;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    if (!pix_ok[i]) continue;
    const int m = ty + (PIX / TP) * i;
    const int oh = oh0 + m / tow, ow = ow0 + m % tow;
    float* dst = dst_base + (((size_t)b * OH + oh) * OW + ow) * O;
    const int o = o0 + tx * TO;
    float v[TO];
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      v[j] = acc[i][j];
      if (splits == 1 && o + j < O)
        v[j] = activate(v[j] + (bias != nullptr ? __ldg(bias + o + j) : 0.f),
                        act);
    }
    if (o_vec && o < O) {
      *reinterpret_cast<float4*>(dst + o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TO; ++j)
        if (o + j < O) dst[o + j] = v[j];
    }
  }
}

// out = act(sum over the splits of ws + bias), V consecutive elements per
// thread (V = 4 when O % 4 == 0), the splits summed in order.
template <int V>
__global__ void __launch_bounds__(256)
im2col_conv_splitk_reduce_kernel(const float* __restrict__ ws,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, size_t n, int O,
                                 int splits, int act) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float* src = ws + p * n + i;
    if (V == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src));
      s[0] += t.x; s[1] += t.y; s[2] += t.z; s[3] += t.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += __ldg(src + e);
    }
  }
  const int o = static_cast<int>(i % O);
#pragma unroll
  for (int e = 0; e < V; ++e)
    out[i + e] =
        activate(s[e] + (bias != nullptr ? __ldg(bias + o + e) : 0.f), act);
}

// The conv kernel's launch: its window and weight slice double-buffered
// in dynamic shared memory (the limit raised on the current device where
// it passes 48 KB), one block a (row tile, column tile) x 64 out channels
// x image x split.  cudaErrorInvalidValue where the buffers pass MAX_SMEM.
cudaError_t plan_conv(int B, int O, int OH, int OW, int kh, int kw, int sh,
                      int sw, int toh, int tow, int splits,
                      describe::Launch* l) {
  const int win_px = ((toh - 1) * sh + kh) * ((tow - 1) * sw + kw);
  const size_t smem =
      2 * (size_t)(win_px * BC + kh * kw * BC * BO) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // The limit raised on each device so far (0: the default 48 KB).
  static size_t smem_limit[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && smem > smem_limit[dev]) {
    err = cudaFuncSetAttribute(im2col_conv_kernel,
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
  l->func = (const void*)&im2col_conv_kernel;
  return cudaSuccess;
}

// The reduce's launch over the B x OH x OW x O output.
describe::Launch plan_conv_reduce(int B, int O, int OH, int OW) {
  return describe::reduce(
      (size_t)B * OH * OW * O, O,
      (const void*)&im2col_conv_splitk_reduce_kernel<4>,
      (const void*)&im2col_conv_splitk_reduce_kernel<1>);
}

}  // namespace

// out (B, OH, OW, O) = act(conv(x (B, H, W, C), w (kh, kw, C, O)) + bias).
// C % 8 == 0, toh * tow <= 64, 1 <= splits <= C / 8; bias may be null; ws
// holds splits * B * OH * OW * O floats when splits > 1 (else it may be
// null); x and w 16-byte aligned.  Returns cudaGetLastError().
extern "C" int repro_im2col_conv(const float* x, const float* w,
                                 const float* bias, float* out, float* ws,
                                 int B, int H, int W, int C, int O, int OH,
                                 int OW, int kh, int kw, int sh, int sw,
                                 int ph, int pw, int toh, int tow, int act,
                                 int splits, cudaStream_t stream) {
  if (C % BC != 0 || toh * tow > PIX || toh < 1 || tow < 1 || splits < 1 ||
      splits > C / BC || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  cudaError_t err =
      plan_conv(B, O, OH, OW, kh, kw, sh, sw, toh, tow, splits, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (OW + tow - 1) / tow;
  im2col_conv_kernel<<<l.grid, l.threads, l.smem, stream>>>(
      x, w, bias, out, ws, B, H, W, C, O, OH, OW, kh, kw, sh, sw, ph, pw, toh,
      tow, col_tiles, act, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * OH * OW * O;
  const describe::Launch red = plan_conv_reduce(B, O, OH, OW);
  if (O % 4 == 0)
    im2col_conv_splitk_reduce_kernel<4><<<red.grid, red.threads, 0, stream>>>(
        ws, bias, out, n, O, splits, act);
  else
    im2col_conv_splitk_reduce_kernel<1><<<red.grid, red.threads, 0, stream>>>(
        ws, bias, out, n, O, splits, act);
  return static_cast<int>(cudaGetLastError());
}

// What repro_im2col_conv launches for args = (B, H, W, C, O, OH, OW, kh,
// kw, sh, sw, ph, pw, toh, tow, splits): the conv kernel (which 0) or the
// reduce (which 1), as describe.cuh lays it out.
extern "C" int repro_im2col_conv_describe(const int* args, int nargs,
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
    l = plan_conv_reduce(B, O, OH, OW);
  } else {
    const cudaError_t err = plan_conv(B, O, OH, OW, args[7], args[8],
                                      args[9], args[10], toh, tow, splits, &l);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return describe::write(l, out);
}
