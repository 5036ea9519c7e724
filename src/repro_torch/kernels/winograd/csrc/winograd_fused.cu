// Fused Winograd F(6x6, 3x3) fp32 kernel for sm_90a: input transform,
// the 64 per-position tuple products on the tensor cores (3xTF32), output
// transform, bias and activation in one pass.
//
// Replaces the TPU kernel
// src/repro/kernels/winograd/kernel.py::fused_winograd_pallas:
//   tiles (T, 8, 8, C) x U (8, 8, C, O) -> Y (T, 6, 6, O),
//   V = B^T d B, M[p] = sum_c V[p][t][c] U[p][c][o], Y = act(A^T M A + bias).
//
// Design.  The TPU kernel accumulates M in an (8, 8, bt, bo) fp32 VMEM
// scratch across a sequential in-channel grid axis.  Here a block owns
// BT = 16 tiles x BO = 32 out channels, and M for all 64 positions of its
// 512 (tile, out channel) pairs lives in registers as mma.sync
// accumulators, spread over the 16 warps by position: warp w holds
// positions 4w .. 4w + 3, each a 16 x 32 tile of 4 m16n8 fragments (64
// floats a thread).  The in-channel reduction is a loop over chunks of BC
// = 8 channels, one k8 step of the 64 small GEMMs M[p] += V[p] . U[p]:
//
//  - U's chunk, 64 positions x 8 channels x 32 out channels, is copied by
//    cp.async into the idle one of two stages while the block transforms
//    and multiplies the current chunk (16-byte copies, 4-byte ones where
//    O % 4 != 0, zero past O), so each U value is read once per 16 tiles
//    (the old kernel's (4, 8, 64) block read it once per 4).
//  - Each warp owns one tile: it copies the tile's chunk (64 positions x
//    32 bytes) by cp.async into shared memory, one chunk ahead, and
//    transforms it with 4 lanes per channel, every thread two rows and then
//    two columns (B^T d B, separably, into V in shared memory, warp
//    barriers between the passes), so all 512 threads take part.
//  - Each product runs as three TF32 mma.sync.m16n8k8 (lo.hi, hi.lo,
//    hi.hi; kernels/csrc/sgemm_3xtf32.cuh's split_tf32 and mma_tf32),
//    which keeps fp32 accuracy (about 1e-6 of max(1, max|ref|) in the
//    CPU replay of tests/test_torch_winograd_tc.py).
//
// After the last chunk the accumulators go through shared memory, and each
// thread applies the output transform, bias and activation to one (tile,
// out channel) pair, writing 36 outputs coalesced over out channels.  V and
// M never leave the chip.  Two barriers a chunk.
//
// Shared memory: U 2 x 64 x 8 x 32 floats (16-byte groups swizzled so the
// B fragment loads hit 32 banks), the tiles 16 x 8 rows of 72 floats (the
// row pass hits 32 banks), V 64 x 200 floats (16 tiles of 12: the A
// fragment loads and the column pass hit 32 banks): 219,136 bytes, one
// block of 512 threads a SM.  M (64 x 16 x 40 floats) reuses U's stages
// and the tiles.  The accumulators take 64 of a thread's 128 registers,
// so nothing else is held across a chunk: the copies are cp.async (no
// registers in flight), each thread's copy offsets advance by constant
// strides, and the output transform reads M a column at a time.
//
// What bounds it.  One block a SM, so nothing overlaps its two barriers a
// chunk but the copies.  Left out one at a time (scripts/
// conv_tc_variants.py, on MODEL_20 608's six calls), the products
// (fragment loads, hi/lo splits, mma.sync) are a third of the time, the
// copies and the transform arithmetic a quarter together; the rest is the
// barriers' latency and the output phase.  The deep layers (C >= 128)
// have fewer blocks than SMs.
#include <cuda_runtime.h>

#include "describe.cuh"
#include "per_device.cuh"
#include "sgemm_3xtf32.cuh"
#include "winograd_transforms.cuh"

namespace {

namespace tc = sgemm_tc;

constexpr int BT = 16;         // tiles per block
constexpr int BO = 32;         // out channels per block
constexpr int BC = 8;          // in channels per chunk (one k8 step)
constexpr int THREADS = 512;   // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int POS = 64 / WARPS;  // positions per warp
constexpr int LDR = 72;        // tile row stride: 8 positions x 8 channels + 8
constexpr int LDV = BC + 4;    // V tile stride within a position (floats)
constexpr int PS = 200;        // V position stride (>= BT * LDV, = 8 mod 32)
constexpr int LDM = BO + 8;    // M row stride (floats)
constexpr int U_STAGE = 64 * BC * BO;
constexpr int RAW = BT * 8 * LDR;
constexpr int SMEM_FLOATS = 2 * U_STAGE + RAW + 64 * PS;
static_assert(64 * BT * LDM <= 2 * U_STAGE + RAW,
              "M reuses U's stages and the raw tiles");
static_assert(BT == WARPS && BT * BO == THREADS,
              "one tile a warp, one pair a thread");

// Float offset of U's (position p, channel c, out channel o) in a stage:
// rows of 32 out channels whose 16-byte groups are XOR-swizzled by
// 2 (c % 4), so a warp's B fragment loads (k = t4 and t4 + 4, n = g) hit
// 32 banks.
__device__ __forceinline__ int u_off(int p, int c, int o) {
  return (p * BC + c) * BO + 4 * ((o >> 2) ^ (2 * (c & 3))) + (o & 3);
}

// out[a] = sum_i BT[a][i] in[i], with BT's zeros and the symmetric row
// pairs (1, 2), (3, 4), (5, 6) taken out.
__device__ __forceinline__ void bt8(const float d[8], float r[8]) {
  r[0] = fmaf(5.25f, d[4] - d[2], d[0] - d[6]);
  r[7] = fmaf(5.25f, d[3] - d[5], d[7] - d[1]);
  const float a1 = fmaf(-4.25f, d[4], d[2] + d[6]);
  const float b1 = fmaf(-4.25f, d[3], d[1] + d[5]);
  r[1] = a1 + b1;
  r[2] = a1 - b1;
  const float a3 = fmaf(0.25f, d[2], fmaf(-1.25f, d[4], d[6]));
  const float b3 = fmaf(0.5f, d[1], fmaf(-2.5f, d[3], 2.f * d[5]));
  r[3] = a3 + b3;
  r[4] = a3 - b3;
  const float a5 = fmaf(4.f, d[2], fmaf(-5.f, d[4], d[6]));
  const float b5 = fmaf(2.f, d[1], fmaf(-2.5f, d[3], 0.5f * d[5]));
  r[5] = a5 + b5;
  r[6] = a5 - b5;
}

// out[x] = sum_a AT[x][a] in[a] (6 of 8), with the pairs (1, 2), (3, 4),
// (5, 6) as sums and differences.
__device__ __forceinline__ void at8(const float m[8], float r[6]) {
  const float s12 = m[1] + m[2], d12 = m[1] - m[2];
  const float s34 = m[3] + m[4], d34 = m[3] - m[4];
  const float s56 = m[5] + m[6], d56 = m[5] - m[6];
  r[0] = m[0] + s12 + s34 + s56;
  r[1] = fmaf(2.f, d34, fmaf(0.5f, d56, d12));
  r[2] = fmaf(4.f, s34, fmaf(0.25f, s56, s12));
  r[3] = fmaf(8.f, d34, fmaf(0.125f, d56, d12));
  r[4] = fmaf(16.f, s34, fmaf(0.0625f, s56, s12));
  r[5] = fmaf(32.f, d34, fmaf(0.03125f, d56, d12)) + m[7];
}

__global__ void __launch_bounds__(THREADS, 1)
winograd_fused_kernel(const float* __restrict__ tiles,
                      const float* __restrict__ U,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int T, int C, int O, int act) {
  extern __shared__ __align__(16) float smem_w[];
  float* us = smem_w;                       // [2][64][BC][BO], swizzled
  float* raw = smem_w + 2 * U_STAGE;        // [BT][8 rows][LDR]
  float* vs = raw + RAW;                    // [64][PS]: [p][tile * LDV + c]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * BT, o0 = blockIdx.y * BO;
  const int chunks = C / BC;
  const bool u_vec = O % 4 == 0;

  // U's chunk `chunk` into stage s: rows (p, c) of BO out channels.  In
  // 16-byte copies a thread keeps its channel c and group v and takes
  // positions p0 + 8 k, so its offsets advance by constant strides.
  constexpr int U_ROW_COPIES = BC * (BO / 4);     // 16-byte copies of a p
  constexpr int U_P_STEP = THREADS / U_ROW_COPIES;  // positions a round
  constexpr int U_ROUNDS = 64 / U_P_STEP;
  static_assert(THREADS % U_ROW_COPIES == 0 && 64 % U_P_STEP == 0,
                "16-byte U copies: a fixed (c, v) a thread");
  const int uv = tid % (BO / 4), uc = (tid / (BO / 4)) % BC;
  const int up0 = tid / U_ROW_COPIES;
  const bool u_in = o0 + 4 * uv < O;
  const int u_dst = u_off(up0, uc, 4 * uv);
  const float* u_src = U + ((size_t)up0 * C + uc) * O + o0 + 4 * uv;
  auto stage_u = [&](int chunk, int s) {
    if (u_vec) {
      float* dst = us + s * U_STAGE + u_dst;
      const float* src = u_in ? u_src + (size_t)chunk * BC * O : U;
      const size_t src_step = u_in ? (size_t)U_P_STEP * C * O : 0;
#pragma unroll
      for (int k = 0; k < U_ROUNDS; ++k)
        tc::cp_async16(dst + k * U_P_STEP * BC * BO, src + k * src_step,
                       u_in);
    } else {
      float* dst0 = us + s * U_STAGE;
      const int c0 = chunk * BC;
#pragma unroll 1
      for (int idx = tid; idx < 64 * BC * BO; idx += THREADS) {
        const int ol = idx % BO, row = idx / BO;
        const int p = row / BC, c = row % BC;
        const int o = o0 + ol;
        const bool in = o < O;
        tc::cp_async4(dst0 + u_off(p, c, ol),
                      in ? U + ((size_t)p * C + c0 + c) * O + o : U, in);
      }
    }
  };

  // The input transform's roles: this warp's tile, this lane's channel and
  // its rows / columns q and q + 4.  Each warp copies and transforms its
  // own tile, so warp barriers order its copies and its two passes.
  const int tt = warp, tc_c = lane % BC, q = lane / BC;
  const int tg = t0 + tt;
  const bool t_ok = tg < T;
  const float* t_src = tiles + (size_t)(t_ok ? tg : 0) * 64 * C;
  float* r_tile = raw + tt * 8 * LDR;  // (i, j, c) at [i * LDR + j * BC + c]
  float* v_base = vs + tt * LDV + tc_c;     // slot p at v_base[p * PS]
  // This warp's tile, chunk `chunk`: 64 positions x two 16-byte halves,
  // zero past T; lane l copies half l % 2 of positions l / 2 + 16 k.
  const int tpos = lane / 2, th = lane % 2;
  float* t_dst = r_tile + (tpos / 8) * LDR + (tpos % 8) * BC + 4 * th;
  auto stage_tile = [&](int chunk) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* dst = t_dst + 2 * k * LDR;
      tc::cp_async16(
          dst, t_src + (size_t)(tpos + 16 * k) * C + chunk * BC + 4 * th,
          t_ok);
    }
  };

  // This warp's accumulators: positions 4 warp + pp, m16 = the 16 tiles,
  // 4 n8 tiles over the 32 out channels.
  const int g = lane / 4, t4 = lane % 4;
  float acc[POS][4][4];
#pragma unroll
  for (int pp = 0; pp < POS; ++pp)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pp][ni][e] = 0.f;

  stage_u(0, 0);
  stage_tile(0);
  tc::cp_async_commit();

  for (int chunk = 0; chunk < chunks; ++chunk) {
    // This chunk's U and tiles have landed, and every warp is done with V
    // and with the U stage the next copy takes.
    tc::cp_async_wait<0>();
    __syncthreads();
    // The next chunk's U flies behind this chunk's transform and products.
    if (chunk + 1 < chunks) stage_u(chunk + 1, (chunk + 1) & 1);

    // Rows: V[8 i + b] = sum_j BT[b][j] d[i][j] for rows i = q, q + 4.
    // Lane q stores column b = (k + q) % 8 at step k, so the 4 lanes of a
    // channel store to 4 banks.
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int i = q + 4 * s;
      float d[8], r[8], t[8], rr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = r_tile[i * LDR + j * BC + tc_c];
      bt8(d, r);
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = (q & 1) ? r[(k + 1) & 7] : r[k];
#pragma unroll
      for (int k = 0; k < 8; ++k) rr[k] = (q & 2) ? t[(k + 2) & 7] : t[k];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v_base[(8 * i + ((k + q) & 7)) * PS] = rr[k];
    }
    __syncwarp();
    // The warp's next tile chunk, into the buffer its row pass has read.
    if (chunk + 1 < chunks) stage_tile(chunk + 1);
    tc::cp_async_commit();
    // Columns b = q, q + 4, in place: V[8 a + b] = sum_i BT[a][i] V[8 i + b].
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int b = q + 4 * s;
      float col[8], r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) col[i] = v_base[(8 * i + b) * PS];
      bt8(col, r);
#pragma unroll
      for (int a = 0; a < 8; ++a) v_base[(8 * a + b) * PS] = r[a];
    }
    __syncthreads();

    const float* ust = us + (chunk & 1) * U_STAGE;
#pragma unroll
    for (int pp = 0; pp < POS; ++pp) {
      const int p = POS * warp + pp;
      // A = V[p] (16 tiles x 8 channels): (g, t4), (g + 8, t4), (g, t4 + 4),
      // (g + 8, t4 + 4).
      const float* va = vs + p * PS + g * LDV + t4;
      uint32_t ah[4], al[4];
      tc::split_tf32(va[0], ah[0], al[0]);
      tc::split_tf32(va[8 * LDV], ah[1], al[1]);
      tc::split_tf32(va[4], ah[2], al[2]);
      tc::split_tf32(va[8 * LDV + 4], ah[3], al[3]);
      // B = U[p] (8 channels x 32 out channels): (k t4, n g), (k t4 + 4, n g).
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t bh[2], bl[2];
        tc::split_tf32(ust[u_off(p, t4, 8 * ni + g)], bh[0], bl[0]);
        tc::split_tf32(ust[u_off(p, t4 + 4, 8 * ni + g)], bh[1], bl[1]);
        tc::mma_tf32(acc[pp][ni], al, bh);
        tc::mma_tf32(acc[pp][ni], ah, bl);
        tc::mma_tf32(acc[pp][ni], ah, bh);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // M through shared memory (over U's stages and the raw tiles):
  // ms[(p * BT + tile) * LDM + o].
  float* ms = smem_w;
#pragma unroll
  for (int pp = 0; pp < POS; ++pp) {
    const int p = POS * warp + pp;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            ms + (p * BT + g + 8 * h) * LDM + 8 * ni + 2 * t4) =
            make_float2(acc[pp][ni][2 * h], acc[pp][ni][2 * h + 1]);
  }
  __syncthreads();

  // One (tile, out channel) pair a thread: Y = act(A^T M A + bias),
  // columns then rows, reading M a column at a time so that 64 values
  // never sit in registers at once.
  const int pt = tid / BO, po = tid % BO;
  const int t = t0 + pt, o = o0 + po;
  if (t >= T || o >= O) return;
  const float* mp = ms + pt * LDM + po;     // position p at mp[p * BT * LDM]
  float tmp[6][8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    float col[8], r[6];
#pragma unroll
    for (int a = 0; a < 8; ++a) col[a] = mp[(a * 8 + b) * BT * LDM];
    at8(col, r);
#pragma unroll
    for (int x = 0; x < 6; ++x) tmp[x][b] = r[x];
  }
  const float bo_v = bias != nullptr ? __ldg(bias + o) : 0.f;
  float* dst = out + (size_t)t * 36 * O + o;
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    float r[6];
    at8(tmp[x], r);
#pragma unroll
    for (int y = 0; y < 6; ++y)
      dst[(size_t)(x * 6 + y) * O] = winograd::activate(r[y] + bo_v, act);
  }
}

// The kernel's launch, after its shared memory limit is raised on the
// current device (once): a block a 16 tiles x 32 out channels.
cudaError_t plan_fused(int T, int O, describe::Launch* l) {
  constexpr size_t smem = SMEM_FLOATS * sizeof(float);
  static bool smem_set[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(winograd_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  l->grid = dim3((T + BT - 1) / BT, (O + BO - 1) / BO);
  l->threads = THREADS;
  l->smem = smem;
  l->stages = 2;
  l->func = (const void*)&winograd_fused_kernel;
  return cudaSuccess;
}

}  // namespace

// Y (T, 6, 6, O) = act(A^T [sum_c (B^T d B) U] A + bias) for tiles
// (T, 8, 8, C) and U (8, 8, C, O).  C % 8 == 0, (bt, bo) the compiled
// (16, 32), tiles and U 16-byte aligned; bias may be null.  Returns
// cudaGetLastError().
extern "C" int repro_winograd_fused(const float* tiles, const float* U,
                                    const float* bias, float* out, int T,
                                    int C, int O, int bt, int bo, int act,
                                    cudaStream_t stream) {
  if (C % BC != 0 || C < BC || bt != BT || bo != BO)
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  const cudaError_t err = plan_fused(T, O, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  winograd_fused_kernel<<<l.grid, l.threads, l.smem, stream>>>(
      tiles, U, bias, out, T, C, O, act);
  return static_cast<int>(cudaGetLastError());
}

// What repro_winograd_fused launches for args = (T, C, O), as describe.cuh
// lays it out (which 0: its one kernel).
extern "C" int repro_winograd_fused_describe(const int* args, int nargs,
                                             int which, long long* out) {
  if (nargs != 3 || which != 0 || args[0] < 1 || args[2] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  describe::Launch l;
  const cudaError_t err = plan_fused(args[0], args[2], &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return describe::write(l, out);
}
