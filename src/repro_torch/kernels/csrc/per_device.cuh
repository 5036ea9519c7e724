// Per-device setup of a launch function.
//
// cudaFuncSetAttribute (the dynamic shared memory a kernel may take above
// 48 KB) and a device's properties (its SM count) hold for the current
// device only.  A launch function that sets them up once therefore keeps
// one flag or value per device, indexed by the ordinal cudaGetDevice gives
// (``current`` below), and sets them up at each device's first launch
// there.  With one process-wide flag, a stage or shard on a second card
// would find the flag set, the attribute never raised on that card, and
// every launch there above 48 KB of dynamic shared memory would fail.
#pragma once

#include <cuda_runtime.h>

namespace per_device {

// Devices a launch function keeps setup for; a larger ordinal is refused
// (cudaErrorInvalidDevice), never indexed.
constexpr int MAX_DEVICES = 64;

// The current device's ordinal in ``*dev``, checked against MAX_DEVICES.
inline cudaError_t current(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < MAX_DEVICES ? cudaSuccess
                                         : cudaErrorInvalidDevice;
}

}  // namespace per_device
