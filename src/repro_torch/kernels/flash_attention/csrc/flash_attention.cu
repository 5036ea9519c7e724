// Flash attention (forward) for sm_90a: online-softmax attention that never
// writes the (S, Sk) score matrix to device memory.  One C entry,
// repro_flash_attention, dispatches by type: fp32 inputs run
// flash_attention_fp32.cuh's kernel (3xTF32 mma.sync), bf16 inputs
// flash_attention_bf16.cuh's (bf16 mma.sync); both take their block
// layout, tile ranges, mask and softmax from flash_common.cuh.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas and
// computes what its body _flash_kernel computes, row by row:
//   s = (q . k) * (1/sqrt(hd)); s = tanh(s / cap) * cap when cap > 0;
//   masked pairs get the finite NEG_INF; an online softmax with fp32 running
//   max m, sum l and accumulator acc; out = acc / max(l, 1e-37).
// Both kernels run the softmax in base 2, with log2 e folded into the
// scale, and give a masked pair p = 0 where the TPU kernel adds
// exp(NEG_INF - NEG_INF) = 1 to a row that has seen no valid key yet and
// clears it when one arrives (alpha = 0), so the results agree.  The
// wrapper refuses inputs in which some row has no valid key at all.
//
// Layout.  q (B, S, H, hd) and k, v (B, Sk, KV, hd) are read in place:
// query head h reads KV head h / (H / KV), the grouping of
// q.reshape(b, s, kv, g, hd) in repro/models/attention.py, so no K/V head is
// copied or broadcast.  The output is (B, S, H, hd), like q.  The TPU kernel
// walks a (BH, S/bq, Sk/bk) grid in order and carries m, l and acc in VMEM
// scratch across the kv axis; here a block owns a run of query rows of one
// (batch, head) and loops over the kv tiles itself, with m, l and acc in
// registers.  Ragged S and Sk are masked in the kernels, so nothing is
// padded (the reference wrapper's non-causal padding fault cannot arise).
//
// What bounds it.  At Llama-3.2-1B's prefill (hd 64, S 4096, causal) the
// work is 4 hd FLOPs per valid pair against q, k, v and o read or written
// once: far above the card's bytes-per-FLOP line, so operations bound
// both kernels; each file says what holds it below its tensor-core peak.
#include <cuda_runtime.h>

#include "flash_attention_bf16.cuh"
#include "flash_attention_fp32.cuh"

// o (B, S, H, hd) = attention(q (B, S, H, hd), k, v (B, Sk, KV, hd)).
// dtype 0: float (3xTF32 tensor cores), 1: bfloat16 (bf16 tensor cores);
// q, k and v 16-byte aligned.  hd in {16, 32, 64, 80, 128, 256};
// H % KV == 0;
// window <= 0: no window; cap <= 0: no softcap.  lse: null, or the
// (B, H, S) fp32 row statistics that flash_attention_bwd.cu reads
// (flash_common.cuh's store_lse: m + log2(l), base 2), written by each
// body's own instance with LSE = true, so the instances the serving calls
// take (lse null) compile as they did before the backward existed.  It
// comes last, after the stream, so that the variants scripts can pass it
// to an earlier build of this entry, which has no such argument and
// ignores it.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int Sk, int H, int KV, int hd, int dtype,
                                     int causal, int window, float cap,
                                     cudaStream_t stream, float* lse) {
  if (B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV != 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(HD)                                                  \
  case HD:                                                                    \
    return dtype == 0                                                         \
               ? flash_fp32::launch<HD>(q, k, v, o, lse, B, S, Sk, H, KV,     \
                                        causal, window, cap, stream)          \
               : flash_bf16::launch<HD>(q, k, v, o, lse, B, S, Sk, H, KV,     \
                                        causal, window, cap, stream);
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}
