// Flash attention (backward) for sm_90a: dq, dk and dv of the forward in
// flash_attention.cu from q, k, v, the forward's output o, the output's
// gradient dO and the row statistic lse the forward wrote (flash_common.cuh's
// store_lse), without writing the (S, Sk) probabilities to device memory.
// One C entry, repro_flash_attention_bwd, dispatches by type: bf16 inputs
// run flash_attention_bwd_bf16.cuh's kernels (mma.sync m16n8k16), fp32
// inputs flash_attention_bwd_fp32.cuh's (3xTF32 on mma.sync m16n8k8), both
// on the tensor cores and of one shape.
//
// It replaces no TPU kernel.  The JAX package trains through plain XLA
// attention (repro/models/attention.py: attention_naive, attention_chunked)
// differentiated by jax.value_and_grad; its Pallas flash kernel has no
// custom_vjp and is on no training path.  The port sends every prefill
// attention through its flash kernel, so the counterpart of that autodiff
// is a backward of the kernel: kernels/flash_attention/ops.py's
// autograd.Function launches this entry, and ref.py::attention_bwd_ref is
// its plain version, step for step.
//
// What it computes, per (batch, query head h, query row i, key j), with
// h on KV head h / (H / KV) as in the forward:
//   s = q_i . k_j;  y = s * scale (scale = 1/sqrt(hd));  s~ = y, or
//   cap * tanh(y / cap) with a softcap; x = s~ * log2 e (the forward's
//   units);  p = exp2(x - lse_i) on a valid pair, else 0 (the mask of
//   flash_common.cuh);
//   D_i = sum_d dO_id o_id                     (the dot kernel, fp32)
//   dv_j += p dO_i;  dp = dO_i . v_j;  ds~ = p (dp - D_i)
//   ds = ds~ * scale * (1 - tanh^2(y / cap))   (the factor 1 without a cap)
//   dk_j += ds q_i;  dq_i += ds k_j.
// dk and dv sum over the G = H / KV query heads of their KV head
// (flash_common.cuh's bwd_x computes x and the factor of ds).
//
// Launches, no atomics, so the result is deterministic:
//   1. flash_bwd_dot_kernel: D, one warp a (batch, row, head), fp32;
//   2. flash_bwd_dkdv_kernel: dk and dv, one block a (batch, KV head, key
//      block), looping over the query heads of its KV head and the query
//      tiles that hold a valid pair for its keys;
//   3. with split > 1 only: flash_bwd_reduce_kernel, twice (dk, dv),
//      for both bodies;
//   4. flash_bwd_dq_kernel: dq, one block a (batch, head, query block),
//      looping over the key tiles of its rows.
// The dk/dv launch may split the G query heads of a KV head into
// `split` groups (blockIdx.z), where B KV ceil(Sk / BK) blocks alone would
// leave SMs idle (ops.py's bwd_head_split chooses it: MQA at hd 256 splits,
// Llama's microbatch does not).  Each group then writes its fp32 partial
// dk and dv to the workspace `ws`, and the reduce launch sums the groups
// in group order (and in bf16 rounds once), so the result does not depend
// on the split's timing and is bit-equal from call to call.
//
// What bounds it, and each body's design: the notes of the two headers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_bwd_bf16.cuh"
#include "flash_attention_bwd_fp32.cuh"
#include "flash_common.cuh"
#include "hmma16.cuh"
#include "per_device.cuh"

namespace {
namespace flash_bwd {

namespace fc = flash_common;

constexpr int DOT_THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D = rowsum(dO o o) in fp32, one warp a row of (B, S, H) rows, written
// as (B, H, S).
template <typename T>
__global__ void __launch_bounds__(DOT_THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                     float* __restrict__ D, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * (DOT_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + (size_t)row * hd;
  const T* gp = dO + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(op[d]), to_f(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H;   // row = (b S + s) H + h
    const int b = bs / S, s = bs % S;
    D[((size_t)b * H + h) * S + s] = acc;
  }
}

template <typename T>
void launch_dot(const void* o, const void* dO, float* D, int B, int S, int H,
                int hd, cudaStream_t stream) {
  const int rows = B * S * H;
  flash_bwd_dot_kernel<T>
      <<<(rows + DOT_THREADS / 32 - 1) / (DOT_THREADS / 32), DOT_THREADS, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dO), D,
                   rows, S, H, hd);
}

// dk or dv of a split launch: the groups' fp32 partials ws[groups][n]
// summed in group order, so the result does not depend on the order the
// groups ran in, and rounded once to T (hmma16.cuh's ordered split-K
// reduce; hd % 4 == 0, so n is too).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                        size_t n, int hd, int groups) {
  hmma16::splitk_reduce<T, 4>(ws, nullptr, out, n, hd, groups, 0);
}

// The reduce launches of a split dk/dv launch: dk's groups, then dv's.
template <typename T>
void launch_reduce(const float* ws, void* dk, void* dv, int B, int Sk, int KV,
                   int hd, int split, cudaStream_t stream) {
  const size_t n = (size_t)B * Sk * KV * hd;
  const unsigned blocks = (unsigned)((n / 4 + 255) / 256);
  flash_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      ws, static_cast<T*>(dk), n, hd, split);
  flash_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      ws + split * n, static_cast<T*>(dv), n, hd, split);
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, const void* o,
                const void* dO, const float* lse, float* D, void* dq,
                void* dk, void* dv, int B, int S, int Sk, int H, int KV,
                int causal, int window, float cap, int split, float* ws,
                cudaStream_t stream) {
  namespace f = flash_bwd_fp32;
  using C = f::Cfg<HD>;
  static bool configured[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(f::flash_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_DKDV);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(f::flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_DQ);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const int q_blocks = (S + C::BQ - 1) / C::BQ;
  const int k_blocks = (Sk + C::BK - 1) / C::BK;
  if (q_blocks > 65535 || k_blocks > 65535 || split > 65535 ||
      (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const fc::BwdScale sc = fc::bwd_scale(HD, cap);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dO);
  float* dkt = static_cast<float*>(dk);
  float* dvt = static_cast<float*>(dv);
  launch_dot<float>(o, dO, D, B, S, H, HD, stream);
  f::flash_bwd_dkdv_kernel<HD>
      <<<dim3(B * KV, k_blocks, split), C::THREADS, C::SMEM_DKDV, stream>>>(
          qt, kt, vt, gt, lse, D, dkt, dvt, ws, S, Sk, H, KV, causal, window,
          sc);
  if (split > 1)
    launch_reduce<float>(ws, dk, dv, B, Sk, KV, HD, split, stream);
  f::flash_bwd_dq_kernel<HD>
      <<<dim3(B * H, q_blocks), C::THREADS, C::SMEM_DQ, stream>>>(
          qt, kt, vt, gt, lse, D, static_cast<float*>(dq), S, Sk, H, KV,
          causal, window, sc);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dO, const float* lse, float* D, void* dq,
                void* dk, void* dv, int B, int S, int Sk, int H, int KV,
                int causal, int window, float cap, int split, float* ws,
                cudaStream_t stream) {
  namespace f = flash_bwd_bf16;
  using C = f::Cfg<HD>;
  using bf16 = __nv_bfloat16;
  static bool configured[per_device::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(f::flash_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_DKDV);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(f::flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_DQ);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const int q_blocks = (S + C::BQ - 1) / C::BQ;
  const int k_blocks = (Sk + C::BK - 1) / C::BK;
  if (q_blocks > 65535 || k_blocks > 65535 || split > 65535 ||
      (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const fc::BwdScale sc = fc::bwd_scale(HD, cap);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dO);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  launch_dot<bf16>(o, dO, D, B, S, H, HD, stream);
  f::flash_bwd_dkdv_kernel<HD>
      <<<dim3(B * KV, k_blocks, split), C::THREADS, C::SMEM_DKDV, stream>>>(
          qt, kt, vt, gt, lse, D, dkt, dvt, ws, S, Sk, H, KV, causal, window,
          sc);
  if (split > 1)
    launch_reduce<bf16>(ws, dk, dv, B, Sk, KV, HD, split, stream);
  f::flash_bwd_dq_kernel<HD>
      <<<dim3(B * H, q_blocks), C::THREADS, C::SMEM_DQ, stream>>>(
          qt, kt, vt, gt, lse, D, static_cast<bf16*>(dq), S, Sk, H, KV,
          causal, window, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_bwd
}  // namespace

// dq (B, S, H, hd), dk and dv (B, Sk, KV, hd), in the inputs' type, of the
// forward attention(q, k, v) with its output o (B, S, H, hd) and that
// output's gradient dO (like o), from the forward's lse (B, H, S) fp32.
// D is a (B, H, S) fp32 workspace.  dtype 0: float, 1: bfloat16; hd in
// {16, 32, 64, 80, 128, 256}; H % KV == 0; window <= 0: no window; cap <=
// 0: no softcap.  split: the groups of the G = H / KV query heads of a KV
// head that the dk/dv launch takes apart, dividing G;
// with split > 1, ws is a (2, split, B, Sk, KV, hd) fp32 workspace (dk's
// partials, then dv's).  They come last, after the stream, so that the
// variants scripts can pass them to an earlier build of this entry, which
// has no such arguments and ignores them.  Every tensor contiguous.
// Returns cudaGetLastError().
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* D, void* dq, void* dk, void* dv,
    int B, int S, int Sk, int H, int KV, int hd, int dtype, int causal,
    int window, float cap, cudaStream_t stream, int split, float* ws) {
  if (B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV != 0 || dtype < 0 ||
      dtype > 1 || split < 1 || (H / KV) % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_BWD_CASE(HD)                                              \
  case HD:                                                                    \
    return dtype == 0                                                         \
               ? flash_bwd::launch_fp32<HD>(q, k, v, o, dO, lse, D, dq, dk,   \
                                            dv, B, S, Sk, H, KV, causal,      \
                                            window, cap, split, ws, stream)   \
               : flash_bwd::launch_bf16<HD>(q, k, v, o, dO, lse, D, dq, dk,   \
                                            dv, B, S, Sk, H, KV, causal,      \
                                            window, cap, split, ws, stream);
  switch (hd) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(80)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD_CASE
}

// The dynamic shared memory of one instance, in bytes: the dk/dv kernel's
// (kernel 0) or the dq kernel's (1) at head dim hd and type dtype (as
// above); 0 for anything not compiled.  chip_smoke.py prints it beside
// ptxas' registers.
extern "C" int repro_flash_attention_bwd_smem(int hd, int dtype, int kernel) {
#define REPRO_FLASH_BWD_SMEM(HD)                                              \
  case HD:                                                                    \
    return dtype == 0 ? (kernel == 0 ? flash_bwd_fp32::Cfg<HD>::SMEM_DKDV     \
                                     : flash_bwd_fp32::Cfg<HD>::SMEM_DQ)      \
                      : (kernel == 0 ? flash_bwd_bf16::Cfg<HD>::SMEM_DKDV     \
                                     : flash_bwd_bf16::Cfg<HD>::SMEM_DQ);
  if (dtype < 0 || dtype > 1 || kernel < 0 || kernel > 1) return 0;
  switch (hd) {
    REPRO_FLASH_BWD_SMEM(16)
    REPRO_FLASH_BWD_SMEM(32)
    REPRO_FLASH_BWD_SMEM(64)
    REPRO_FLASH_BWD_SMEM(80)
    REPRO_FLASH_BWD_SMEM(128)
    REPRO_FLASH_BWD_SMEM(256)
    default: return 0;
  }
#undef REPRO_FLASH_BWD_SMEM
}
