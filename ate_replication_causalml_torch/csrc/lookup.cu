// Per-tree K-channel leaf lookup.
//
//   out[t, k, row] = table[t, k, ids[t, row]],   0 for an id outside [0, L)
//
// Replaces ate_replication_causalml_tpu/ops/tree_pallas.py::_lookup_kernel
// (entry table_lookup). The forest grower records every training row's
// leaf value with it (K = 1, L = 2^depth = 512 at depth 9). The TPU
// kernel avoided a per-row gather (serialized there) with a one-hot
// contraction on the MXU; on the card a gather is the natural form.
//
// What bounds it on an H100: the bytes, 4 B of id read and 4 * K B of
// values written per (tree, row); the tables (2 KB per tree and channel)
// stay in cache.
//
// Design: one thread per (tree, row), rows of one tree on consecutive
// threads so the id reads and the value writes coalesce. A copy of a
// table entry: exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lookup_kernel(const float* __restrict__ table, int n_chan, int n_slots,
                              const int32_t* __restrict__ ids, int64_t n,
                              float* __restrict__ out) {
  const int t = blockIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int id = ids[static_cast<int64_t>(t) * n + row];
  const bool ok = id >= 0 && id < n_slots;
  for (int k = 0; k < n_chan; ++k) {
    const int64_t tk = static_cast<int64_t>(t) * n_chan + k;
    out[tk * n + row] = ok ? table[tk * n_slots + id] : 0.0f;
  }
}

}  // namespace

extern "C" int ate_lookup(const void* table, int n_trees, int n_chan, int n_slots,
                          const void* ids, int64_t n, void* out, void* stream) {
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads), n_trees);
  lookup_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n_chan, n_slots, static_cast<const int32_t*>(ids),
      n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
