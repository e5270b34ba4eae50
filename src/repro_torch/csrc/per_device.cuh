// Per-device one-time setup for the kernel launchers.
//
// A function attribute set with cudaFuncSetAttribute (the dynamic shared
// memory opt-in above 48 KiB, the carveout) belongs to the current device
// only. A launcher that records "done" in one process-wide flag would skip
// the opt-in on every other card, and a launch there asking for more than
// 48 KiB would fail; a data mesh over several cards launches on each. So
// the flag is kept per device, indexed by cudaGetDevice.
#pragma once

#include <cuda_runtime.h>

namespace per_device {
namespace {

constexpr int kMaxDevices = 64;

// Runs ``set`` (returning a cudaError_t) once per device for the caller's
// flags; returns its error, or one from cudaGetDevice, as an int.
template <typename Set>
int once(bool (&done)[kMaxDevices], Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = set();
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

}  // namespace
}  // namespace per_device
