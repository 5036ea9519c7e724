// Fused Winograd F(6x6, 3x3) bf16 and fp16 kernel for sm_90a: input
// transform, the 64 per-position tuple products on the tensor cores
// (mma.sync m16n8k16, fp32 sums), output transform, bias and activation in
// one pass, with the in-channel reduction split across blocks where the
// grid alone would leave SMs idle.
//
// Replaces the 16-bit bodies of the TPU kernel
// src/repro/kernels/winograd/kernel.py::fused_winograd_pallas:
//   tiles (T, 8, 8, C) of one 16-bit type T x U (8, 8, C, O) -> Y (T, 6, 6,
//   O) of type T (the TPU kernel writes tiles.dtype), bias fp32;
//   V = B^T d B, M[p] = sum_c V[p][t][c] U[p][c][o], Y = act(A^T M A + bias).
// The TPU kernel computes V in fp32 from the 16-bit tiles and multiplies
// it by the caller's fp32 U, in fp32; M, the inverse transform and the
// epilogue are fp32 and Y is rounded once.  So does this kernel, with V
// and U each carried as two values of T, hi + lo: V is split in registers
// after the transform, U comes split offline
// (core/winograd.py::split_transformed: hi and lo of U[p] * 2^k[p], a
// power of two per position that keeps fp16's lo parts out of its
// subnormals), and each product is three m16n8k16 products into the fp32
// accumulator, V.lo U.hi + V.hi U.lo + V.hi U.hi (the V.lo U.lo term, 2^-16
// of a bf16 product and 2^-22 of an fp16 one, is dropped).  M is scaled
// back by 2^-k[p] (exact) on its way to the output transform.  F(6,3)
// needs it: with U or V rounded to bf16 the output of a 64-channel layer
// is off by 8 % of its largest value, against 0.2 % here (the CPU replay
// of the plain versions, PERF.md).
//
// Design.  A block of BT = 16 tiles x BO = 32 out channels keeps M for all
// 64 positions of its 512 (tile, out channel) pairs in registers as
// mma.sync accumulators, 64 floats a thread over 16 warps; warp w owns the
// positions w, w + 16, w + 32, w + 48, one of each group of 16.  The
// in-channel reduction is a loop over chunks of BC = 16 channels, one k16
// step of the 64 small GEMMs M[p] += V[p] . U[p]:
//
//  - U streams through a ring of STAGES stages, each one position group's
//    chunk (16 positions x 16 channels x 32 out channels, hi and lo: 32 KB),
//    copied by one 4-d TMA box (64-byte rows, 64-byte swizzle) that
//    completes on the stage's "full" mbarrier.  A warp releases a stage
//    once its fragments are in registers (a shared counter a stage), and
//    the last warp to release it at once issues the copy STAGES groups
//    ahead into it; so U's copies run behind the input transform and the
//    products of the groups before, and no block-wide barrier waits for
//    U.  Every stage feeds all 16 warps (each takes its own position of
//    the group).
//  - Each warp owns one tile: it copies the tile's chunk (64 positions x
//    32 bytes) by cp.async into shared memory, one chunk ahead, and
//    transforms it with 2 lanes per channel: each lane the rows i = q, q +
//    2, q + 4, q + 6 (q = lane / 16) in fp32 registers, then, after trading
//    half of them with its partner lane (__shfl_xor 16), the columns b =
//    4 q .. 4 q + 3; V's hi and lo parts are stored in shared memory as
//    the A operands of the products (16 tiles x 16 channels a position).
//    Two barriers of the 16 warps a chunk: V is free (every warp past the
//    previous chunk's products; the row pass runs before it), V is whole.
//  - The products read V by ldmatrix.x4 and U by ldmatrix.x4.trans (U
//    keeps its (c, o) rows as they lie in device memory).
//
// After the last chunk the accumulators go through shared memory (over the
// U ring and V), and each thread applies the output transform to one
// (tile, out channel) pair in fp32.  Unsplit (splits == 1), it adds the
// bias, applies the activation and writes 36 outputs rounded to T,
// coalesced over out channels.  Split, block z takes the chunks [z n /
// splits, (z + 1) n / splits) of the n = ceil(C / 16) and writes its 36
// fp32 partial outputs A^T M_z A (the transform is linear) to the
// workspace (splits, T, 6, 6, O); winograd16_split_reduce_kernel adds the
// partials in split order (no atomics: the same bits every run), the bias
// and the activation, and rounds once.  The split count comes from
// kernels/winograd/ops.py::call_splits_16 (kernels/_splitk.py::split_k,
// one block a SM): VGG-16's 56-block layers run 2 splits on 132 SMs.
//
// Shared memory: the U ring 3 x 32 KB, V 2 parts x 64 positions of 528
// bytes (16 tiles x 16 channels, halves swapped as in the implicit-GEMM
// conv, and 16 bytes that put the positions a warp writes at once on
// other banks), the tiles 16 x 8 rows of 288 bytes, 3 mbarriers and
// counters, 512 bytes to align the ring: 203,300 bytes, one block of 512
// threads a SM.  M (64 x 16 x 40 floats) reuses the ring and V.
//
// What bounds it.  No one unit: a block of 16 warps an SM runs the
// transform, the products and U's copies in lockstep, and leaving out any
// one of the products, U's copies, V's stores or a barrier saves a tenth
// of the time or less (scripts/winograd16_variants.py, PERF.md).  Shared
// memory moves 448 KB a chunk (U in by TMA and out by ldmatrix, 128 KB
// each way; V, 64 KB each way; the tiles, 32 KB each way), V's and the
// tiles' 2 bytes a lane.  The ring keeps U's copies off the critical path;
// the split fills the SMs a small grid leaves idle.
#include <cuda_runtime.h>

#include "describe.cuh"
#include "hmma16.cuh"
#include "hopper_async.cuh"
#include "per_device.cuh"
#include "winograd16_transforms.cuh"

namespace {

namespace hm = hmma16;
namespace hp = hopper;
using winograd16::at8;
using winograd16::bt8;

constexpr int BT = 16;            // tiles per block
constexpr int BO = 32;            // out channels per block
constexpr int BC = 16;            // in channels per chunk (one k16 step)
constexpr int THREADS = 512;      // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int GP = WARPS;         // positions per group (one a warp)
constexpr int GROUPS = 64 / GP;   // position groups per chunk
constexpr int STAGES = 3;         // U ring stages
constexpr int U_ROW = BO * 2;     // bytes of a (p, c) row of U
constexpr int U_P = BC * U_ROW;   // bytes of a position of U
constexpr int U_PART = GP * U_P;  // bytes of one part (hi or lo) of a stage
constexpr int U_STAGE = 2 * U_PART;
constexpr int U_RING = STAGES * U_STAGE;
// Bytes of a position of V: 16 tiles x 16 channels, and 16 more, so that
// the positions p and p + 4 one warp writes at once fall on other banks.
constexpr int V_P = BT * 32 + 16;
constexpr int V_PART = 64 * V_P;  // bytes of one part (hi or lo) of V
// Bytes of a tile row: 8 positions and 32 more, so that the rows i and
// i + 1 one warp reads at once fall on other banks.
constexpr int RAW_LD = 8 * 32 + 32;
constexpr int RAW_TILE = 8 * RAW_LD;
constexpr int RAW = BT * RAW_TILE;
constexpr int V_OFF = U_RING;
constexpr int RAW_OFF = V_OFF + 2 * V_PART;
constexpr int BAR_OFF = RAW_OFF + RAW;
constexpr int ALIGN = 512;        // the 64-byte swizzle's period
constexpr int SMEM_BYTES = BAR_OFF + STAGES * (8 + 4) + ALIGN;
constexpr int LDM = BO + 8;       // M row stride (floats)
static_assert(SMEM_BYTES <= 232448, "one block's shared memory");
static_assert(64 * BT * LDM * 4 <= V_OFF + 2 * V_PART,
              "M reuses the U ring and V");
static_assert(BT == WARPS && BT * BO == THREADS,
              "one tile a warp, one pair a thread");

// Byte offset of U's (position p of the group, channel c, out channel o)
// in one part of a stage, as the TMA box lays it out: 64-byte rows (p, c),
// their 16-byte groups of 8 out channels XOR-ed by row bits 1-2 (the
// 64-byte swizzle on a 512-byte aligned stage).
__device__ __forceinline__ int u_off(int p, int c, int o) {
  return p * U_P + c * U_ROW + 16 * ((o >> 3) ^ ((c >> 1) & 3)) + 2 * (o & 7);
}

// Byte offset of half h (channels 8 h .. 8 h + 7) of tile row `t` of a
// position of V: halves swapped where (t / 4) is odd.
__device__ __forceinline__ int v_half(int t, int h) {
  return t * 32 + 16 * (h ^ ((t >> 2) & 1));
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
winograd16_fused_kernel(const __grid_constant__ CUtensorMap u_map,
                        const T* __restrict__ tiles,
                        const float* __restrict__ inv_scale,
                        const float* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ ws, int T_, int C, int O, int act,
                        int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((ALIGN - (hp::smem_u32(smem_raw) & (ALIGN - 1))) &
                  (ALIGN - 1));
  unsigned char* us = smem;                    // [STAGES][2 parts][GP][BC] rows
  unsigned char* vs = smem + V_OFF;            // [2 parts][64][BT] rows
  unsigned char* raw = smem + RAW_OFF;         // [BT][8 rows][RAW_LD]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  int* released = reinterpret_cast<int*>(full + STAGES);  // warps, a stage

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * BT, o0 = blockIdx.y * BO, split = blockIdx.z;
  const int chunks = (C + BC - 1) / BC;
  const int lo = split * chunks / splits, hi = (split + 1) * chunks / splits;
  const int n_it = (hi - lo) * GROUPS;   // U stages this block reads

  // Copy j of U (chunk lo + j / GROUPS, position group j % GROUPS) into
  // stage j % STAGES, which no warp reads any more.
  auto issue = [&](int j) {
    const int s = j % STAGES;
    hp::mbar_expect_tx(&full[s], U_STAGE);
    hp::tma_load_4d(us + s * U_STAGE, &u_map, &full[s], o0,
                    (lo + j / GROUPS) * BC, (j % GROUPS) * GP, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < STAGES && j < n_it; ++j) issue(j);

  // The input transform's roles: this warp's tile, this lane's channel and
  // its row / column half q.
  const int tt = warp, tcn = lane % BC, q = lane / BC;
  const int tg = t0 + tt;
  const bool t_ok = tg < T_;
  const T* t_src = tiles + (size_t)(t_ok ? tg : 0) * 64 * C;
  unsigned char* r_tile = raw + tt * RAW_TILE;  // (i, j, c) at i*RAW_LD+j*32+2c
  // This warp's tile, chunk `chunk`: 64 positions x two 16-byte halves,
  // zero past T and C; lane l copies half l % 2 of positions l / 2 + 16 k.
  const int tpos = lane / 2, th = lane % 2;
  auto stage_tile = [&](int chunk) {
    const int c = chunk * BC + 8 * th;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = tpos + 16 * k;
      const bool in = t_ok && c < C;
      hm::cp_async16(r_tile + (pos / 8) * RAW_LD + (pos % 8) * 32 + 16 * th,
                     in ? t_src + (size_t)pos * C + c : tiles, in);
    }
  };

  // This warp's accumulators: group g's position GP g + warp, m16 = the 16
  // tiles, 4 n8 tiles over the 32 out channels.
  float acc[GROUPS][4][4];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][ni][e] = 0.f;

  const uint32_t us_addr = hp::smem_u32(us);
  const int a_off = v_half(hm::a_frag_row(lane), hm::a_frag_col(lane) / 8);
  const int b_k = hm::b_frag_k(lane), b_n = hm::b_frag_n(lane);
  const uint32_t vs_addr = hp::smem_u32(vs);
  // This lane's V slot within a position (tile tt, channel tcn).
  const int v_slot = v_half(tt, tcn / 8) + 2 * (tcn % 8);

  stage_tile(lo);
  hm::cp_async_commit();

  for (int chunk = lo; chunk < hi; ++chunk) {
    const int i = chunk - lo;
    // This warp's tile chunk has landed.
    hm::cp_async_wait<0>();
    __syncwarp();

    // Rows i = 2 s + q: r[s][b] = sum_j BT[b][j] d[i][j], in fp32.
    float r[4][8];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int row = 2 * s + q;
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = hm::to_f32(*reinterpret_cast<const T*>(
            r_tile + row * RAW_LD + j * 32 + 2 * tcn));
      bt8(d, r[s]);
    }
    __syncwarp();
    // The warp's next tile chunk, into the buffer its row pass has read.
    if (chunk + 1 < hi) stage_tile(chunk + 1);
    hm::cp_async_commit();
    // Every warp is past the previous chunk's products: V is free.
    hp::bar_sync(1, THREADS);
    // Columns b = 4 q + k: the partner lane (q ^ 1, same channel) holds the
    // other 4 rows; each lane sends the partner's column.  V[8 a + b] =
    // sum_i BT[a][i] r[i][b], split into hi and lo parts of T.
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float col[8];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float mine = q ? r[s][4 + k] : r[s][k];
        const float other = __shfl_xor_sync(0xffffffffu,
                                            q ? r[s][k] : r[s][4 + k], 16);
        col[2 * s] = q ? other : mine;
        col[2 * s + 1] = q ? mine : other;
      }
      float v[8];
      bt8(col, v);
      const int b = 4 * q + k;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const T vh = hm::from_f32<T>(v[a]);
        unsigned char* slot = vs + (8 * a + b) * V_P + v_slot;
        *reinterpret_cast<T*>(slot) = vh;
        *reinterpret_cast<T*>(slot + V_PART) =
            hm::from_f32<T>(v[a] - hm::to_f32(vh));
      }
    }
    // V is whole for every warp.
    hp::bar_sync(1, THREADS);

#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int it = GROUPS * i + g;
      const int s = it % STAGES;
      hp::mbar_wait(&full[s], (it / STAGES) & 1);
      const int p = GP * g + warp;
      // A = V[p] (16 tiles x 16 channels), hi and lo; B = U[p] (16
      // channels x 32 out channels), hi and lo, two x4.trans loads of 16
      // out channels each.
      uint32_t ah[4], al[4], bh[2][4], bl[2][4];
      hm::ldsm_x4(ah, vs_addr + p * V_P + a_off);
      hm::ldsm_x4(al, vs_addr + V_PART + p * V_P + a_off);
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const uint32_t ua =
            us_addr + s * U_STAGE + u_off(warp, b_k, 16 * pair + b_n);
        hm::ldsm_x4_trans(bh[pair], ua);
        hm::ldsm_x4_trans(bl[pair], ua + U_PART);
      }
      // This warp is done with stage s; the last warp to be done refills
      // it, STAGES groups ahead.
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if (atomicAdd(&released[s], 1) % WARPS == WARPS - 1 &&
            it + STAGES < n_it) {
          __threadfence_block();
          issue(it + STAGES);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int pr = ni / 2, e = 2 * (ni % 2);
        hm::mma16<T>(acc[g][ni], al, bh[pr][e], bh[pr][e + 1]);
        hm::mma16<T>(acc[g][ni], ah, bl[pr][e], bl[pr][e + 1]);
        hm::mma16<T>(acc[g][ni], ah, bh[pr][e], bh[pr][e + 1]);
      }
    }
  }
  // Every warp is done with U and V (every copy issued has been waited
  // for).
  __syncthreads();

  // M through shared memory (over the U ring and V), scaled back by
  // 2^-k[p]: ms[(p * BT + tile) * LDM + o].
  float* ms = reinterpret_cast<float*>(smem);
  const int gr = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int p = GP * g + warp;
    const float sc = __ldg(inv_scale + p);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            ms + (p * BT + gr + 8 * h) * LDM + 8 * ni + 2 * t4) =
            make_float2(acc[g][ni][2 * h] * sc, acc[g][ni][2 * h + 1] * sc);
  }
  __syncthreads();

  // One (tile, out channel) pair a thread: A^T M A in fp32, columns then
  // rows, reading M a column at a time; unsplit, act(. + bias) rounded to
  // T, split, the fp32 partial into the workspace.
  const int pt = tid / BO, po = tid % BO;
  const int t = t0 + pt, o = o0 + po;
  if (t >= T_ || o >= O) return;
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
  if (splits > 1) {
    float* dst = ws + ((size_t)split * T_ + t) * 36 * O + o;
#pragma unroll
    for (int x = 0; x < 6; ++x) {
      float r[6];
      at8(tmp[x], r);
#pragma unroll
      for (int y = 0; y < 6; ++y) dst[(size_t)(x * 6 + y) * O] = r[y];
    }
    return;
  }
  const float bo_v = bias != nullptr ? __ldg(bias + o) : 0.f;
  T* dst = out + (size_t)t * 36 * O + o;
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    float r[6];
    at8(tmp[x], r);
#pragma unroll
    for (int y = 0; y < 6; ++y)
      dst[(size_t)(x * 6 + y) * O] =
          hm::from_f32<T>(hm::activate(r[y] + bo_v, act));
  }
}

// Y = act(sum over the splits of ws + bias) rounded to T, V consecutive
// elements per thread (V = 4 when O % 4 == 0), the splits summed in order.
template <class T, int V>
__global__ void __launch_bounds__(256)
winograd16_split_reduce_kernel(const float* __restrict__ ws,
                               const float* __restrict__ bias,
                               T* __restrict__ out, size_t n, int O,
                               int splits, int act) {
  hm::splitk_reduce<T, V>(ws, bias, out, n, O, splits, act);
}

// The kernel's launch, after its shared memory limit is raised on the
// current device (once): a block a 16 tiles x 32 out channels x split.
template <class T>
cudaError_t plan_fused16(int T_, int O, int splits, describe::Launch* l) {
  static bool smem_set[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return err;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(winograd16_fused_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  l->grid = dim3((T_ + BT - 1) / BT, (O + BO - 1) / BO, splits);
  l->threads = THREADS;
  l->smem = SMEM_BYTES;
  l->stages = STAGES;
  l->func = (const void*)&winograd16_fused_kernel<T>;
  return cudaSuccess;
}

// The reduce's launch over the T x 36 x O output.
template <class T>
describe::Launch plan_fused16_reduce(int T_, int O) {
  return describe::reduce(
      (size_t)T_ * 36 * O, O,
      (const void*)&winograd16_split_reduce_kernel<T, 4>,
      (const void*)&winograd16_split_reduce_kernel<T, 1>);
}

template <class T>
int launch(const CUtensorMap& u_map, const T* tiles, const float* inv_scale,
           const float* bias, T* out, float* ws, int T_, int C, int O,
           int act, int splits, cudaStream_t stream) {
  describe::Launch l;
  cudaError_t err = plan_fused16<T>(T_, O, splits, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  winograd16_fused_kernel<T><<<l.grid, l.threads, l.smem, stream>>>(
      u_map, tiles, inv_scale, bias, out, ws, T_, C, O, act, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)T_ * 36 * O;
  const describe::Launch red = plan_fused16_reduce<T>(T_, O);
  if (O % 4 == 0)
    winograd16_split_reduce_kernel<T, 4><<<red.grid, red.threads, 0,
                                           stream>>>(ws, bias, out, n, O,
                                                     splits, act);
  else
    winograd16_split_reduce_kernel<T, 1><<<red.grid, red.threads, 0,
                                           stream>>>(ws, bias, out, n, O,
                                                     splits, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (T, 6, 6, O) = act(A^T M A + bias), M[p] = sum_c (B^T d B)[p] (U hi +
// U lo)[p] * inv_scale[p], for tiles (T, 8, 8, C) and U (2, 8, 8, C, O8)
// (hi, then lo; O8 = O rounded up to a multiple of 8, the rows past O
// zero), bf16 (dtype 0) or fp16 (dtype 1), inv_scale (64,) and bias fp32
// (bias may be null), Y of the tiles' type.  C % 8 == 0, (bt, bo) the
// compiled (16, 32), tiles and U 16-byte aligned; 1 <= splits <=
// ceil(C / 16), ws holds splits * T * 36 * O floats when splits > 1 (else
// it may be null).  Returns cudaGetLastError().
extern "C" int repro_winograd16_fused(const void* tiles, const void* U,
                                      const float* inv_scale,
                                      const float* bias, void* out, float* ws,
                                      int T, int C, int O, int bt, int bo,
                                      int act, int splits, int dtype,
                                      cudaStream_t stream) {
  const int chunks = (C + BC - 1) / BC;
  if (T < 1 || O < 1 || C % 8 != 0 || C < 8 || bt != BT || bo != BO ||
      splits < 1 || splits > chunks || splits > 65535 ||
      (splits > 1 && ws == nullptr) || (O + BO - 1) / BO > 65535 ||
      (reinterpret_cast<uintptr_t>(tiles) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(U) & 15) != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // U as (2, 64, C, O8): boxes of 32 out channels x 16 channels x 16
  // positions x both parts, 64-byte rows swizzled.
  const uint64_t o8 = (O + 7) / 8 * 8;
  const uint64_t dims[4] = {o8, (uint64_t)C, 64, 2};
  const uint64_t strides[3] = {o8 * 2, (uint64_t)C * o8 * 2,
                               64 * (uint64_t)C * o8 * 2};
  const uint32_t box[4] = {BO, BC, GP, 2};
  CUtensorMap u_map;
  if (!hp::make_map(&u_map, U, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch(u_map, static_cast<const __nv_bfloat16*>(tiles), inv_scale,
                  bias, static_cast<__nv_bfloat16*>(out), ws, T, C, O, act,
                  splits, stream);
  return launch(u_map, static_cast<const __half*>(tiles), inv_scale, bias,
                static_cast<__half*>(out), ws, T, C, O, act, splits, stream);
}

// What repro_winograd16_fused launches for args = (T, C, O, splits,
// dtype): the fused kernel (which 0) or the reduce (which 1), as
// describe.cuh lays it out.
extern "C" int repro_winograd_fused_16_describe(const int* args, int nargs,
                                                int which, long long* out) {
  if (nargs != 5 || which < 0 || which > 1 || args[0] < 1 || args[2] < 1 ||
      args[3] < 1 || (args[4] != 0 && args[4] != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T_ = args[0], O = args[2], splits = args[3];
  describe::Launch l;
  if (which == 1) {
    l = args[4] == 0 ? plan_fused16_reduce<__nv_bfloat16>(T_, O)
                     : plan_fused16_reduce<__half>(T_, O);
  } else {
    const cudaError_t err =
        args[4] == 0 ? plan_fused16<__nv_bfloat16>(T_, O, splits, &l)
                     : plan_fused16<__half>(T_, O, splits, &l);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return describe::write(l, out);
}
