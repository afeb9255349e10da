// Per-level route bit of the forest grower.
//
//   out[t, row] = codes[row, feat[t, id]] > thr[t, id],   id = ids[t, row]
//
// with 0 for an id outside [0, M) (the grower's -1 rows) and a code of 0
// for a feature outside [0, p).
//
// Replaces ate_replication_causalml_tpu/ops/tree_pallas.py::_route_kernel
// (entry route_bits). The TPU kernel computed every node's margin for
// every row as one MXU product against a transposed codes matrix with a
// ones row, then selected the row's own node with a one-hot; that trick
// (codes_transposed, route_table) exists only for the TPU's matrix unit.
//
// What bounds it on an H100: the bytes, about 12 B per (tree, row): the
// id read, the bit written, and one code read from the (n, p) codes,
// which stay in L2 (0.9 MB at the notebook's 11,016 x 21) and are shared
// by every tree. There is no arithmetic to speak of.
//
// Design: one thread per (tree, row), rows of one tree on consecutive
// threads so the id reads and bit writes coalesce; the per-node tables
// are tiny and cached. Integer compares only: exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void route_kernel(const int32_t* __restrict__ codes, int64_t n, int p,
                             const int32_t* __restrict__ ids,
                             const int32_t* __restrict__ feat,
                             const int32_t* __restrict__ thr, int max_nodes,
                             int32_t* __restrict__ out) {
  const int t = blockIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t i = static_cast<int64_t>(t) * n + row;
  const int id = ids[i];
  int bit = 0;
  if (id >= 0 && id < max_nodes) {
    const int64_t node = static_cast<int64_t>(t) * max_nodes + id;
    const int f = feat[node];
    const int code = (f >= 0 && f < p) ? codes[row * p + f] : 0;
    bit = code > thr[node] ? 1 : 0;
  }
  out[i] = bit;
}

}  // namespace

extern "C" int ate_route(const void* codes, int64_t n, int p, const void* ids,
                         const void* feat, const void* thr, int n_trees, int max_nodes,
                         void* out, void* stream) {
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads), n_trees);
  route_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(feat), static_cast<const int32_t*>(thr), max_nodes,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
