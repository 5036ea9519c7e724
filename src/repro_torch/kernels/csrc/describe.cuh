// What a launcher launches, told without launching.
//
// Each library's launcher computes its launch (grid, cluster, threads,
// dynamic shared memory, the ring's stages, and for a persistent grid the
// resident blocks a SM it sized the grid by) in one planning function, and
// launches what that function returns.  The library's describe entry,
// repro_<library>_describe, runs the same planning function on the same
// shapes and writes what it returned, with the kernel's own attributes
// (cudaFuncGetAttributes: static shared memory, registers, the dynamic
// shared memory the function may take, local memory) and the device's SM
// count and opt-in shared memory a block, into FIELDS int64 values:
//
//   0-2 grid x, y, z        3-5 cluster x, y, z      6 threads
//   7 dynamic shared memory 8 stages (0: no ring)    9 resident (0: not
//   persistent)  10 static shared memory  11 registers a thread
//   12 the function's dynamic shared memory limit  13 SMs
//   14 the device's opt-in shared memory a block  15 local memory a thread
//
// The planning functions make the same per-device setup a launch makes
// (the shared memory limit raised on the current device), so an
// occupancy query answers as it does for the launch.  The port's
// verifier (repro_torch/analysis) holds these figures against the launch
// descriptors the Python wrappers build (kernels/_launch.py).
#pragma once

#include <cuda_runtime.h>

namespace describe {

constexpr int FIELDS = 16;

struct Launch {
  dim3 grid{1, 1, 1};
  dim3 cluster{1, 1, 1};
  int threads = 0;
  size_t smem = 0;
  int stages = 0;
  int resident = 0;
  const void* func = nullptr;
};

// out[0 .. FIELDS) as above; returns a cudaError_t's int value.
inline int write(const Launch& l, long long* out) {
  cudaFuncAttributes a = {};
  cudaError_t err = cudaFuncGetAttributes(&a, l.func);
  int dev = 0, sms = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[FIELDS] = {
      l.grid.x,    l.grid.y,    l.grid.z,
      l.cluster.x, l.cluster.y, l.cluster.z,
      l.threads,   static_cast<long long>(l.smem),
      l.stages,    l.resident,
      static_cast<long long>(a.sharedSizeBytes), a.numRegs,
      a.maxDynamicSharedSizeBytes, sms, optin,
      static_cast<long long>(a.localSizeBytes)};
  for (int i = 0; i < FIELDS; ++i) out[i] = v[i];
  return static_cast<int>(cudaSuccess);
}

// The split-K reduce launch shared by the fp32 and int8 GEMM and conv
// kernels and the 16-bit fused Winograd kernel: V = 4 consecutive outputs
// a thread where the row width `cols` is a multiple of 4, else 1; 256
// threads a block over n outputs.
inline Launch reduce(size_t n, int cols, const void* func_v4,
                     const void* func_v1) {
  Launch l;
  const bool vec = cols % 4 == 0;
  l.grid = dim3(static_cast<unsigned>(((vec ? n / 4 : n) + 255) / 256), 1, 1);
  l.threads = 256;
  l.func = vec ? func_v4 : func_v1;
  return l;
}

}  // namespace describe
