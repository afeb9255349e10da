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
//
// route_advance: one grow level's whole row-side step in one launch
// (the streaming grower's loop, models/forest.py::streaming_level_loop),
// in place of the route launch and the six to eight elementwise PyTorch
// ops around it:
//
//   bit      = route bit of (t, row) at id = node_rev[t, row] (as above)
//   node_int = 2 * node_int + bit
//   node_rev = node_rev + bit * M
//   out      = node_rev where bit == 0 else -1      (next level: the left
//              children's rev ids, which the next histogram reads)
//            | node_int                             (after the last level:
//              the leaf ids the leaf sums read)
//   out      = -1 where mask[t, row] is false      (optional (T, n) mask)
//
// What bounds it: the bytes, about 21 B per (tree, row) (two id streams
// read and written, the output written, the mask read) plus the codes
// once; a launch of the old route kernel alone moved a third of that
// and took four times its bound, most of it the launch's fixed cost, so
// the lever is one launch per level in place of eight.
//
// Design: one block per (row tile of 1,024 rows, tree); the tree's (M,)
// feature and threshold tables staged in shared memory (2 KB at M =
// 256); each thread takes 4 consecutive rows with 16-byte loads and
// stores of the id streams, neighbouring threads on neighbouring rows;
// the codes stay in L2. Integer operations only (the id arithmetic in
// uint32, wrapping as PyTorch's int32 does): exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_common.cuh"

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


constexpr int kAdvanceThreads = 256;
constexpr int kRowsPerThread = 4;
// Tables staged in shared memory up to this width (2 x 4 B x M = 32 KB).
constexpr int kMaxStagedNodes = 4096;

__device__ __forceinline__ int route_one(const int32_t* __restrict__ codes, int64_t row, int p,
                                         const int32_t* f_tab, const int32_t* b_tab,
                                         int max_nodes, int id) {
  if (id < 0 || id >= max_nodes) return 0;
  const int f = f_tab[id];
  const int code = (f >= 0 && f < p) ? __ldg(codes + row * p + f) : 0;
  return code > b_tab[id] ? 1 : 0;
}

__global__ void __launch_bounds__(kAdvanceThreads)
route_advance_kernel(const int32_t* __restrict__ codes, int64_t n, int p,
                     const int32_t* __restrict__ feat, const int32_t* __restrict__ thr,
                     int max_nodes, int32_t* __restrict__ node_int,
                     int32_t* __restrict__ node_rev, const uint8_t* __restrict__ mask,
                     int last, int vec, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_tab[];  // [feat | thr] of this block's tree
  const int t = blockIdx.y;
  const int32_t* f_tab = feat + static_cast<int64_t>(t) * max_nodes;
  const int32_t* b_tab = thr + static_cast<int64_t>(t) * max_nodes;
  if (max_nodes <= kMaxStagedNodes) {
    for (int i = threadIdx.x; i < max_nodes; i += blockDim.x) {
      s_tab[i] = f_tab[i];
      s_tab[max_nodes + i] = b_tab[i];
    }
    __syncthreads();
    f_tab = s_tab;
    b_tab = s_tab + max_nodes;
  }
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kRowsPerThread;
  if (row0 >= n) return;
  const int64_t at = static_cast<int64_t>(t) * n + row0;
  int ni[kRowsPerThread], nr[kRowsPerThread], keep[kRowsPerThread];
  const int rows = static_cast<int>(n - row0 < kRowsPerThread ? n - row0 : kRowsPerThread);
  if (vec) {  // n % 4 == 0 and every pointer 16-byte aligned (4 for the mask)
    const int4 a = *reinterpret_cast<const int4*>(node_int + at);
    const int4 b = *reinterpret_cast<const int4*>(node_rev + at);
    ni[0] = a.x; ni[1] = a.y; ni[2] = a.z; ni[3] = a.w;
    nr[0] = b.x; nr[1] = b.y; nr[2] = b.z; nr[3] = b.w;
    if (mask) {
      const uchar4 m = *reinterpret_cast<const uchar4*>(mask + at);
      keep[0] = m.x; keep[1] = m.y; keep[2] = m.z; keep[3] = m.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      ni[j] = j < rows ? node_int[at + j] : 0;
      nr[j] = j < rows ? node_rev[at + j] : -1;
      keep[j] = mask && j < rows ? mask[at + j] : 0;
    }
  }
  int o[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int bit = route_one(codes, row0 + j, p, f_tab, b_tab, max_nodes, nr[j]);
    ni[j] = static_cast<int32_t>((static_cast<uint32_t>(ni[j]) << 1) + bit);
    nr[j] = static_cast<int32_t>(static_cast<uint32_t>(nr[j]) +
                                 static_cast<uint32_t>(bit) * static_cast<uint32_t>(max_nodes));
    o[j] = last ? ni[j] : (bit == 0 ? nr[j] : -1);
    if (mask && !keep[j]) o[j] = -1;
  }
  if (vec) {
    *reinterpret_cast<int4*>(node_int + at) = make_int4(ni[0], ni[1], ni[2], ni[3]);
    *reinterpret_cast<int4*>(node_rev + at) = make_int4(nr[0], nr[1], nr[2], nr[3]);
    *reinterpret_cast<int4*>(out + at) = make_int4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (j < rows) {
        node_int[at + j] = ni[j];
        node_rev[at + j] = nr[j];
        out[at + j] = o[j];
      }
    }
  }
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

extern "C" int ate_route_advance(const void* codes, int64_t n, int p, const void* feat,
                                 const void* thr, int n_trees, int max_nodes, void* node_int,
                                 void* node_rev, const void* mask, int last, void* out,
                                 void* stream) {
  const int rows_per_block = kAdvanceThreads * kRowsPerThread;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block), n_trees);
  const size_t smem = max_nodes <= kMaxStagedNodes ? 2 * sizeof(int32_t) * max_nodes : 0;
  const int vec = n % kRowsPerThread == 0 && aligned(node_int, 16) && aligned(node_rev, 16) &&
                  aligned(out, 16) && (mask == nullptr || aligned(mask, 4));
  route_advance_kernel<<<grid, kAdvanceThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(feat),
      static_cast<const int32_t*>(thr), max_nodes, static_cast<int32_t*>(node_int),
      static_cast<int32_t*>(node_rev), static_cast<const uint8_t*>(mask), last, vec,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
