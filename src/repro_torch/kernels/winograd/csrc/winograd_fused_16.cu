// Fused Winograd F(6x6, 3x3) bf16 and fp16 kernel for sm_90a: input
// transform, the 64 per-position tuple products on the tensor cores
// (mma.sync m16n8k16, fp32 sums), output transform, bias and activation in
// one pass.
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
// Design.  The fp32 kernel's (winograd_fused.cu) block of BT = 16 tiles x
// BO = 32 out channels, with M for all 64 positions of its 512 (tile, out
// channel) pairs in registers as mma.sync accumulators, spread over the 16
// warps by position: warp w holds positions 4w .. 4w + 3, each a 16 x 32
// tile of 4 m16n8 fragments (64 floats a thread).  The in-channel
// reduction is a loop over chunks of BC = 16 channels, one k16 step of the
// 64 small GEMMs M[p] += V[p] . U[p]:
//
//  - U's chunk, 64 positions x 16 channels x 32 out channels, hi and lo,
//    is copied by cp.async into shared memory (16-byte copies; value by
//    value where O % 8 != 0; zero past C and O), behind the chunk's input
//    transform.  The two parts take 128 KB, so there is one stage: the
//    copy starts once the previous chunk's products are done.
//  - Each warp owns one tile: it copies the tile's chunk (64 positions x
//    32 bytes) by cp.async into shared memory, one chunk ahead, and
//    transforms it with 2 lanes per channel: each lane the rows i = q, q +
//    2, q + 4, q + 6 (q = lane / 16) in fp32 registers, then, after trading
//    half of them with its partner lane (__shfl_xor 16), the columns b =
//    4 q .. 4 q + 3; V's hi and lo parts are stored in shared memory as
//    the A operands of the products (16 tiles x 16 channels a position).
//  - The products read V by ldmatrix.x4 and U by ldmatrix.x4.trans (U
//    keeps its (c, o) rows as they lie in device memory).
//
// After the last chunk the accumulators go through shared memory, and each
// thread applies the output transform, bias and activation to one (tile,
// out channel) pair in fp32 and writes 36 outputs, rounded, coalesced over
// out channels.  V and M never leave the chip.  Three barriers a chunk.
//
// Shared memory: U 2 parts x 64 x 16 x 32 values (64-byte rows whose
// 16-byte groups are XOR-swizzled by (c / 2) % 4, so the 8 rows of an
// ldmatrix phase hit distinct banks), the tiles 16 x 8 rows of 272 bytes,
// V 2 parts x 64 x 16 x 32 bytes (halves swapped as in the implicit-GEMM
// conv): 231,424 bytes, one block of 512 threads a SM.  M (64 x 16 x 40
// floats) reuses U and the tiles.
//
// What bounds it.  One block a SM, so nothing overlaps its barriers but
// the copies; the products are three 16-bit products per fp32 product
// (the fp32 kernel's are three TF32 ones, at half the rate), and the
// transforms on the CUDA cores are the same.
#include <cuda_runtime.h>

#include "hmma16.cuh"
#include "winograd16_transforms.cuh"

namespace {

namespace hm = hmma16;
using winograd16::at8;
using winograd16::bt8;

constexpr int BT = 16;           // tiles per block
constexpr int BO = 32;           // out channels per block
constexpr int BC = 16;           // in channels per chunk (one k16 step)
constexpr int THREADS = 512;     // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int POS = 64 / WARPS;  // positions per warp
constexpr int U_ROW = BO * 2;    // bytes of a (p, c) row of U
constexpr int U_P = BC * U_ROW;  // bytes of a position of U
constexpr int U_PART = 64 * U_P; // bytes of one part (hi or lo) of U
constexpr int RAW_LD = 8 * 32 + 16;  // bytes of a tile row: 8 positions + 16
constexpr int RAW_TILE = 8 * RAW_LD;
constexpr int RAW = BT * RAW_TILE;
constexpr int V_P = BT * 32;     // bytes of a position of V: 16 tiles x 16 c
constexpr int V_PART = 64 * V_P; // bytes of one part (hi or lo) of V
constexpr int SMEM_BYTES = 2 * U_PART + RAW + 2 * V_PART;
constexpr int LDM = BO + 8;      // M row stride (floats)
static_assert(SMEM_BYTES <= 232448, "one block's shared memory");
static_assert(64 * BT * LDM * 4 <= 2 * U_PART + RAW,
              "M reuses U and the raw tiles");
static_assert(BT == WARPS && BT * BO == THREADS,
              "one tile a warp, one pair a thread");

// Byte offset of U's (position p, channel c, out channel o) in a stage:
// 16-byte groups of 8 out channels, XOR-swizzled by (c / 2) % 4.
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
winograd16_fused_kernel(const T* __restrict__ tiles, const T* __restrict__ U,
                        const float* __restrict__ inv_scale,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int T_, int C, int O, int act) {
  extern __shared__ __align__(16) unsigned char smem_wf[];
  unsigned char* us = smem_wf;                   // [2 parts][64][BC] rows
  unsigned char* raw = smem_wf + 2 * U_PART;     // [BT][8 rows][RAW_LD]
  unsigned char* vs = raw + RAW;                 // [2 parts][64][BT] rows

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * BT, o0 = blockIdx.y * BO;
  const int chunks = (C + BC - 1) / BC;
  const size_t u_lo = (size_t)64 * C * O;        // U's lo part, in values
  const bool u_vec =
      O % 8 == 0 && (reinterpret_cast<uintptr_t>(U) & 15) == 0;

  // U's chunk `chunk`, both parts: rows (part, p, c) of BO out channels, 4
  // groups of 8 a row.  A thread keeps its channel c and group g and takes
  // positions p0 + 8 k of both parts.
  const int ug = tid % (BO / 8), uc = (tid / (BO / 8)) % BC;
  const int up0 = tid / (BC * (BO / 8));
  constexpr int U_P_STEP = THREADS / (BC * (BO / 8));
  static_assert(64 % U_P_STEP == 0, "U copies");
  const int uo = o0 + 8 * ug;
  auto stage_u = [&](int chunk) {
    const int c = chunk * BC + uc;
    const bool in_c = c < C;
#pragma unroll 2
    for (int part = 0; part < 2; ++part) {
#pragma unroll 4
      for (int p = up0; p < 64; p += U_P_STEP) {
        unsigned char* dst = us + part * U_PART + u_off(p, uc, 8 * ug);
        const size_t off = part * u_lo + ((size_t)p * C + c) * O + uo;
        if (u_vec) {
          const bool in = in_c && uo < O;
          hm::cp_async16(dst, in ? U + off : U, in);
        } else {
          const uint16_t* src = reinterpret_cast<const uint16_t*>(U) + off;
          uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            d[e] = in_c && uo + e < O ? src[e] : uint16_t(0);
        }
      }
    }
  };

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

  // This warp's accumulators: positions 4 warp + pp, m16 = the 16 tiles,
  // 4 n8 tiles over the 32 out channels.
  float acc[POS][4][4];
#pragma unroll
  for (int pp = 0; pp < POS; ++pp)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pp][ni][e] = 0.f;

  const uint32_t us_addr = hm::smem_addr(us);
  const uint32_t vs_addr = hm::smem_addr(vs);
  const int a_off = v_half(hm::a_frag_row(lane), hm::a_frag_col(lane) / 8);
  const int b_k = hm::b_frag_k(lane), b_n = hm::b_frag_n(lane);
  // This lane's V slot within a position (tile tt, channel tcn).
  const int v_slot = v_half(tt, tcn / 8) + 2 * (tcn % 8);

  stage_tile(0);
  hm::cp_async_commit();

  for (int chunk = 0; chunk < chunks; ++chunk) {
    // Every warp is past the previous chunk's products (the barrier that
    // ends each chunk): U and V are free.
    stage_u(chunk);
    hm::cp_async_commit();
    // This warp's tile chunk has landed (U's copy may still fly).
    hm::cp_async_wait<1>();
    __syncwarp();

    // Rows i = 2 s + q: r[s][b] = sum_j BT[b][j] d[i][j], in fp32.
    float r[4][8];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = 2 * s + q;
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = hm::to_f32(*reinterpret_cast<const T*>(
            r_tile + i * RAW_LD + j * 32 + 2 * tcn));
      bt8(d, r[s]);
    }
    __syncwarp();
    // The warp's next tile chunk, into the buffer its row pass has read.
    if (chunk + 1 < chunks) stage_tile(chunk + 1);
    hm::cp_async_commit();
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
        const T hi = hm::from_f32<T>(v[a]);
        unsigned char* slot = vs + (8 * a + b) * V_P + v_slot;
        *reinterpret_cast<T*>(slot) = hi;
        *reinterpret_cast<T*>(slot + V_PART) =
            hm::from_f32<T>(v[a] - hm::to_f32(hi));
      }
    }
    // U's chunk has landed (the next tile's copy may still fly); then V
    // and U are complete for every warp.
    hm::cp_async_wait<1>();
    __syncthreads();

#pragma unroll
    for (int pp = 0; pp < POS; ++pp) {
      const int p = POS * warp + pp;
      // A = V[p] (16 tiles x 16 channels), hi and lo; B = U[p] (16
      // channels x 32 out channels), hi and lo, two x4.trans loads of 16
      // out channels each.
      uint32_t ah[4], al[4], bh[2][4], bl[2][4];
      hm::ldsm_x4(ah, vs_addr + p * V_P + a_off);
      hm::ldsm_x4(al, vs_addr + V_PART + p * V_P + a_off);
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const uint32_t ua = us_addr + u_off(p, b_k, 16 * pair + b_n);
        hm::ldsm_x4_trans(bh[pair], ua);
        hm::ldsm_x4_trans(bl[pair], ua + U_PART);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int pr = ni / 2, e = 2 * (ni % 2);
        hm::mma16<T>(acc[pp][ni], al, bh[pr][e], bh[pr][e + 1]);
        hm::mma16<T>(acc[pp][ni], ah, bl[pr][e], bl[pr][e + 1]);
        hm::mma16<T>(acc[pp][ni], ah, bh[pr][e], bh[pr][e + 1]);
      }
    }
    // Every warp is done with U and V before the next chunk replaces them.
    __syncthreads();
  }
  hm::cp_async_wait<0>();
  __syncthreads();

  // M through shared memory (over U and the raw tiles), scaled back by
  // 2^-k[p]: ms[(p * BT + tile) * LDM + o].
  float* ms = reinterpret_cast<float*>(smem_wf);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int pp = 0; pp < POS; ++pp) {
    const int p = POS * warp + pp;
    const float sc = __ldg(inv_scale + p);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            ms + (p * BT + g + 8 * h) * LDM + 8 * ni + 2 * t4) =
            make_float2(acc[pp][ni][2 * h] * sc, acc[pp][ni][2 * h + 1] * sc);
  }
  __syncthreads();

  // One (tile, out channel) pair a thread: Y = act(A^T M A + bias) in
  // fp32, columns then rows, reading M a column at a time; each output
  // rounded to T.
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

template <class T>
int launch(const T* tiles, const T* U, const float* inv_scale,
           const float* bias, T* out, int T_, int C, int O, int act,
           cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        winograd16_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((T_ + BT - 1) / BT, (O + BO - 1) / BO);
  winograd16_fused_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      tiles, U, inv_scale, bias, out, T_, C, O, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (T, 6, 6, O) = act(A^T M A + bias), M[p] = sum_c (B^T d B)[p] (U hi +
// U lo)[p] * inv_scale[p], for tiles (T, 8, 8, C) and U (2, 8, 8, C, O)
// (hi, then lo), bf16 (dtype 0) or fp16 (dtype 1), inv_scale (64,) and
// bias fp32 (bias may be null), Y of the tiles' type.  C % 8 == 0, (bt,
// bo) the compiled (16, 32), tiles 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int repro_winograd16_fused(const void* tiles, const void* U,
                                      const float* inv_scale,
                                      const float* bias, void* out, int T,
                                      int C, int O, int bt, int bo, int act,
                                      int dtype, cudaStream_t stream) {
  if (T < 1 || O < 1 || C % 8 != 0 || C < 8 || bt != BT || bo != BO ||
      (reinterpret_cast<uintptr_t>(tiles) & 15) != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch(static_cast<const __nv_bfloat16*>(tiles),
                  static_cast<const __nv_bfloat16*>(U), inv_scale, bias,
                  static_cast<__nv_bfloat16*>(out), T, C, O, act, stream);
  return launch(static_cast<const __half*>(tiles),
                static_cast<const __half*>(U), inv_scale, bias,
                static_cast<__half*>(out), T, C, O, act, stream);
}
