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
#include <stdint.h>

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

// Asynchronous copies from device to shared memory (cp.async): a block
// issues all its staging copies at once and pays one memory latency for
// them, at wait_async_copies().  copy_async16 needs both addresses 16-byte
// aligned.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Stage `words` contiguous 4-byte words, all threads of the block taking
// part: 16-byte copies where both ends are 16-byte aligned, else 4-byte.
__device__ __forceinline__ void copy_words_async(void* dst, const void* src, long long words,
                                                 int tid, int nthreads) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  long long k = tid;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) & 15) == 0) {
    for (; k < words / 4; k += nthreads) copy_async16(d + 16 * k, s + 16 * k);
    k = words / 4 * 4 + tid;
  }
  for (; k < words; k += nthreads) copy_async4(d + 4 * k, s + 4 * k);
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace repro
