// The dynamic shared-memory cap of a kernel, raised and never lowered.
//
// cudaFuncAttributeMaxDynamicSharedMemorySize belongs to the kernel
// function (per device), not to a launch. Host threads that launch one
// kernel at different sizes (the concurrent sweep's workers, each on its
// own stream) would otherwise race: thread A sets the cap to its size,
// thread B lowers it to a smaller size, and A's launch then asks for more
// than the cap and fails with cudaErrorInvalidValue. Here the cap only
// grows, under one lock, so once a launch's size is allowed it stays
// allowed for every thread.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <utility>

inline cudaError_t raise_smem_cap(const void* func, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> caps;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& cap = caps[{func, device}];
  if (bytes <= cap) return cudaSuccess;
  err = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) cap = bytes;
  return err;
}

template <typename Kernel>
cudaError_t raise_smem_cap(Kernel* kernel, size_t bytes) {
  return raise_smem_cap(reinterpret_cast<const void*>(kernel), bytes);
}
