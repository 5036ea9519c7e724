// Fused Winograd F(6x6, 3x3) fp32 kernel for sm_90a: input transform,
// 64 per-position tuple products, output transform, bias and activation in
// one pass.
//
// Replaces the TPU kernel
// src/repro/kernels/winograd/kernel.py::fused_winograd_pallas:
//   tiles (T, 8, 8, C) x U (8, 8, C, O) -> Y (T, 6, 6, O),
//   V = B^T d B, M[p] = sum_c V[p][t][c] U[p][c][o], Y = act(A^T M A + bias).
//
// Design.  The TPU kernel accumulates M in an (8, 8, bt, bo) fp32 VMEM
// scratch across a sequential in-channel grid axis; at its floor block
// (8, 128, 128) that scratch is 256 KiB, more than a Hopper block's shared
// memory and register file together can spare.  Here a block owns bt tiles
// x bo out channels with bt * bo = 256, one (tile, out channel) pair per
// thread, and M for that pair — all 64 positions — lives in the thread's
// registers (64 floats).  That keeps the output transform thread-local.
// The in-channel reduction is a loop inside the block over chunks of
// BC = 8 channels: the chunk's (bt, 8, 8, BC) tiles are read from device
// memory, transformed separably (rows, then columns) in place in shared
// memory as V[p][t][c], and each thread then adds sum_c V[p][t][c] * U[p][c][o]
// for its pair, reading U through the read-only cache (the bt threads of a
// column share each U value).  Tiles past T and out channels past O are
// masked; C must be a multiple of BC.
//
// What bounds it.  On the main path these layers are small (about 80
// MFLOP each at batch 1); per FMA the loop issues one global (L1-hit) load
// of U, so load issue, not the FMA rate, limits it.  fp32 FMA only.
#include <cuda_runtime.h>

#include "winograd_transforms.cuh"

namespace {

constexpr int BC = 8;          // in channels per reduction step
constexpr int THREADS = 256;   // bt * bo
constexpr int MAX_BT = 16;     // bo >= 16

__global__ void __launch_bounds__(THREADS)
winograd_fused_kernel(const float* __restrict__ tiles,
                      const float* __restrict__ U,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int T, int C, int O, int bt, int bo, int act) {
  // V for the chunk: vs[(p * bt + t) * BC + c], p = 8 * row + col.
  __shared__ __align__(16) float vs[64 * MAX_BT * BC];

  const int tid = threadIdx.x;
  const int ol = tid % bo, tl = tid / bo;
  const int t0 = blockIdx.x * bt, o0 = blockIdx.y * bo;
  const int t = t0 + tl, o = o0 + ol;
  const bool o_ok = o < O;
  const float* u_col = U + (o_ok ? o : 0);

  float acc[64];
#pragma unroll
  for (int p = 0; p < 64; ++p) acc[p] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    // Input transform, one (tile, channel) pair per thread: rows first
    // (device memory -> shared), then columns in place.
    for (int pair = tid; pair < bt * BC; pair += THREADS) {
      const int tp = pair / BC, c = pair % BC;
      const int tg = t0 + tp;
      float* v = vs + tp * BC + c;          // slot p at v[p * bt * BC]
      const int vstride = bt * BC;
      const float* d = tiles + (size_t)tg * 64 * C + c0 + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float row[8], r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          row[j] = tg < T ? __ldg(d + (size_t)(i * 8 + j) * C) : 0.f;
        winograd::bt_apply(row, r);                   // r[b] = sum_j BT[b][j] d[i][j]
#pragma unroll
        for (int b = 0; b < 8; ++b) v[(i * 8 + b) * vstride] = r[b];
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float col[8], r[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) col[i] = v[(i * 8 + b) * vstride];
        winograd::bt_apply(col, r);                   // V[a][b] = sum_i BT[a][i] col[i]
#pragma unroll
        for (int a = 0; a < 8; ++a) v[(a * 8 + b) * vstride] = r[a];
      }
    }
    __syncthreads();

    // Tuple products for this thread's (tile, out channel) pair.
#pragma unroll
    for (int p = 0; p < 64; ++p) {
      const float4* vp =
          reinterpret_cast<const float4*>(vs + (p * bt + tl) * BC);
      const float4 v0 = vp[0], v1 = vp[1];
      const float* u = u_col + ((size_t)p * C + c0) * O;
      float s = acc[p];
      s = fmaf(v0.x, __ldg(u), s);
      s = fmaf(v0.y, __ldg(u + O), s);
      s = fmaf(v0.z, __ldg(u + 2 * O), s);
      s = fmaf(v0.w, __ldg(u + 3 * O), s);
      s = fmaf(v1.x, __ldg(u + 4 * O), s);
      s = fmaf(v1.y, __ldg(u + 5 * O), s);
      s = fmaf(v1.z, __ldg(u + 6 * O), s);
      s = fmaf(v1.w, __ldg(u + 7 * O), s);
      acc[p] = s;
    }
    __syncthreads();
  }

  if (t >= T || !o_ok) return;
  winograd::output_tile(acc, bias != nullptr ? __ldg(bias + o) : 0.f, act,
                        out + (size_t)t * 36 * O + o, O);
}

}  // namespace

// Y (T, 6, 6, O) = act(A^T [sum_c (B^T d B) U] A + bias) for tiles
// (T, 8, 8, C) and U (8, 8, C, O).  C % 8 == 0, bt * bo == 256, bo >= 16;
// bias may be null.  Returns cudaGetLastError().
extern "C" int repro_winograd_fused(const float* tiles, const float* U,
                                    const float* bias, float* out, int T,
                                    int C, int O, int bt, int bo, int act,
                                    cudaStream_t stream) {
  if (C % BC != 0 || bt * bo != THREADS || bt > MAX_BT || bt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + bt - 1) / bt, (O + bo - 1) / bo);
  winograd_fused_kernel<<<grid, THREADS, 0, stream>>>(tiles, U, bias, out, T,
                                                      C, O, bt, bo, act);
  return static_cast<int>(cudaGetLastError());
}
