// Shared helpers for the engine's Hopper kernels.
//
// Every kernel is exported through a plain C function that the Python
// wrappers (repro_torch/kernels/ops.py) call via ctypes.  The function
// launches through launch_on() below, on the caller's stream (PyTorch's
// current stream), and returns a CUDA error code, which the wrapper turns
// into an exception when it is not cudaSuccess.  Nothing here allocates
// or synchronises.
//
// All f32 arithmetic goes through the _rn intrinsics (and the build adds
// --fmad=false): the plain PyTorch twins round every add and multiply
// separately, and an FMA contraction could change a bit where a BIG-sized
// term enters a sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr float kBig = 1e7f;  // the engine's "forbidden" cost (bounds.py BIG)

// Runs `launch` (a callable that enqueues one kernel and returns a
// cudaError_t) with `device` current, and returns the first error as an
// int: one that earlier work on this thread left pending (reported here,
// never dropped, so the wrapper raises instead of launching after a
// failure), one from selecting the device, or the launch's own.  The
// caller's current device is restored afterwards.
template <typename Launch>
inline int launch_on(int device, Launch launch) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int prev = device;
  err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch();
  if (err == cudaSuccess) err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
