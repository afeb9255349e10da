// Tree-batched weighted histogram for forest split search, dense form.
//
//   out[t, k, m, f, b] = sum_row  w[t, k, row] * [ids[t, row] == m] * [codes[row, f] == b]
//
// Replaces ate_replication_causalml_tpu/ops/hist_pallas.py::_hist_kernel_batched
// (dense mode), both with per-tree weights (entry bin_histogram_pallas_batched)
// and with one weight stack shared by every tree (shared_weights=True, entry
// bin_histogram_pallas_batched_shared: the weights' tree stride is 0), and with
// it the single-tree _hist_kernel as the T = 1 case. The classifier grower
// calls it per tree chunk and level (K = 2: bootstrap counts and counts * y)
// and for the leaf sums (node_sums: p = 1, n_bins = 1, M = 2^depth); the
// causal grower calls the shared form (K = 5 float moment channels) per
// level below the partition crossover and for the honest leaf sums.
//
// What bounds it on an H100: the bytes. Per row it reads one id, K weights
// and p codes and does p * K additions; the output is T * K * M * p * n_bins
// floats (27.5 MB at T = 16, K = 5, M = 64, p = 21, n_bins = 64). Far below
// the card's arithmetic rate either way.
//
// Design. The TPU kernel built one-hot matrices and contracted them on the
// MXU; on the card the same sum is an ordered accumulation into a shared
// memory tile (hist_common.cuh): one block per (row range, feature, tree),
// a (K, M, n_bins) tile (80 KB at K = 5, M = 64: dynamic shared memory),
// every warp walking every row of the range and keeping the rows whose cell
// it owns (cell mod 4). Ids outside [0, M) and codes outside [0, n_bins)
// add nothing. Float sums are in a fixed order, so reruns are bitwise equal.
// A block has 4 warps, not 16: every warp pays the whole walk's loads and
// ballots for the quarter of the rows it keeps, so more warps per block
// multiply the instructions issued (a 16-warp block ran 0.58-0.82 ms per
// launch at the notebook's shapes on an H100, instruction-bound).
#include "hist_common.cuh"

namespace {

constexpr int kDenseThreads = 128;

__device__ __forceinline__ RowIn dense_row(const int32_t* __restrict__ codes, int p, int f,
                                           const int32_t* __restrict__ ids_t,
                                           const float* __restrict__ w_t, int64_t n,
                                           int64_t row, int64_t row_end, int max_nodes,
                                           int n_bins, int n_weights, int warp,
                                           int n_warps) {
  RowIn r;
  r.cell = -1;
  if (row < row_end) {
    const int id = ids_t[row];
    if (id >= 0 && id < max_nodes) {
      const int code = codes[row * p + f];
      if (code >= 0 && code < n_bins) r.cell = id * n_bins + code;
    }
  }
  if (r.cell % n_warps != warp) r.cell = -1;  // another warp owns this cell
  load_weights(r, w_t, n, row, n_weights);
  return r;
}

__global__ void __launch_bounds__(kDenseThreads) hist_dense(
    const int32_t* __restrict__ codes, int64_t n, int p, const int32_t* __restrict__ ids,
    const float* __restrict__ w, int64_t w_tree_stride, int n_trees, int n_weights,
    int max_nodes, int n_bins, int64_t rows_per_block, float* __restrict__ out) {
  extern __shared__ float tile[];  // (n_weights, max_nodes, n_bins)
  const int part = blockIdx.x;
  const int f = blockIdx.y;
  const int t = blockIdx.z;
  const int chan = max_nodes * n_bins;
  zero_tile(tile, n_weights * chan);
  __syncthreads();

  const int64_t row_begin = static_cast<int64_t>(part) * rows_per_block;
  const int64_t row_end = row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  const int32_t* ids_t = ids + static_cast<int64_t>(t) * n;
  const float* w_t = w + static_cast<int64_t>(t) * w_tree_stride;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  // Rows in steps of 32, the next step's loads issued before this step's adds.
  RowIn cur = dense_row(codes, p, f, ids_t, w_t, n, row_begin + lane, row_end, max_nodes,
                        n_bins, n_weights, warp, n_warps);
  for (int64_t base = row_begin; base < row_end; base += 32) {
    const RowIn next = dense_row(codes, p, f, ids_t, w_t, n, base + 32 + lane, row_end,
                                 max_nodes, n_bins, n_weights, warp, n_warps);
    add_in_lane_order(tile, chan, n_weights, cur);
    cur = next;
  }
  __syncthreads();
  write_tile(tile, n_trees, n_weights, max_nodes, p, n_bins, part, f, t, out);
}

}  // namespace

extern "C" int ate_hist(const void* codes, int64_t n, int p, const void* ids, const void* w,
                        int64_t w_tree_stride, int n_trees, int n_weights, int max_nodes,
                        int n_bins, int n_parts, void* partial, void* out, void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_weights) * max_nodes * n_bins * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_dense, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_per_block = (n + n_parts - 1) / n_parts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(n_parts > 1 ? partial : out);
  hist_dense<<<dim3(n_parts, p, n_trees), kDenseThreads, smem, s>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(ids),
      static_cast<const float*>(w), w_tree_stride, n_trees, n_weights, max_nodes, n_bins,
      rows_per_block, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  return static_cast<int>(launch_reduce(static_cast<const float*>(partial), n_parts, size,
                                        static_cast<float*>(out), s));
}

extern "C" const char* ate_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
