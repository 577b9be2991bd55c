// A kernel's dynamic shared-memory limit, raised once per device.
//
// cudaFuncSetAttribute costs host time on every call, and the fold
// engine captures the training step into a CUDA graph after one eager
// warm-up step: a launch under the capture should find its limit set
// already.  Each launcher keeps, in a function-local static (one per
// template instantiation, so one per kernel), the limit it has set so
// far on each device, and calls the driver only to raise it.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace smem_limit {

constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t raise(Kernel kernel, size_t bytes,
                         int (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  const int want = static_cast<int>(bytes);
  if (want <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             want);
  if (err == cudaSuccess) set[dev] = want;
  return err;
}

}  // namespace smem_limit
