// Pieces shared by the row kernels (route.cu, lookup.cu). Each .cu
// compiles into its own library, so everything here is internal to the
// including file.
#pragma once

#include <stdint.h>

// Whether ptr is a multiple of `to` bytes (a power of two): the test for
// the 16-byte vector loads and stores of the row streams.
static __host__ __device__ inline bool aligned(const void* ptr, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(ptr) & (to - 1)) == 0;
}
