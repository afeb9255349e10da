// Tree-batched weighted histogram, partition form: the same output as
// hist.cu (out[t, k, m, f, b] = sum_row w[t, k, row] [ids[t, row] == m]
// [codes[row, f] == b]), with the rows grouped by node first.
//
// Replaces ate_replication_causalml_tpu/ops/hist_pallas.py::
// _hist_kernel_batched_partition (partition=True on bin_histogram_pallas_batched
// and bin_histogram_pallas_batched_shared; the pack=True branch is not ported).
// The growers launch it under the "auto" policy at and past the crossover
// width (K = 5 causal levels from width 16, K = 2 classifier levels from 32).
//
// What bounds it on an H100: the bytes, as for the dense kernel (the same
// inputs and output, plus a (T, n) permutation written and read once).
//
// Design. The TPU kernel regrouped rows with a one-hot permutation matmul
// in VMEM, so its FLOPs scale with rows instead of rows x nodes. On the card
// the regrouping is a stable counting sort, and what it saves is the dense
// kernel's redundant walk: there every warp of a block reads every row and
// keeps the 1/16 whose cells it owns; here each warp reads only the rows of
// its own nodes.
//   1. partition_rows, one block per (row range, tree): each warp counts
//      the node ids of its own contiguous sixteenth of the range, an
//      exclusive prefix runs in (node, warp) order, then every row's
//      destination = its node's offset + its rank among earlier rows of
//      the same node (__match_any_sync ranks within a 32-row step). The sort is
//      stable, so a node's rows keep ascending row order. Writes perm
//      (T, n) and segment starts seg (T, n_parts, M + 1).
//   2. partition_accumulate, one block per (row range, feature, tree): warp
//      w takes nodes w, w + 16, ... and walks each node's segment in order
//      into the shared (K, M, n_bins) tile with the ordered adds of
//      hist_common.cuh. Each cell thus sums its rows in ascending row order
//      within the range, exactly as in hist.cu, and the same second pass
//      adds the ranges: dense and partition give the same bits.
#include "hist_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) partition_rows(
    const int32_t* __restrict__ ids, int64_t n, int n_parts, int max_nodes,
    int64_t rows_per_block, int32_t* __restrict__ perm, int32_t* __restrict__ seg) {
  extern __shared__ int32_t smem[];
  int32_t* offs = smem;                              // (kWarps, max_nodes)
  int32_t* start = smem + kWarps * max_nodes;        // (max_nodes + 1)
  const int part = blockIdx.x;
  const int t = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * max_nodes; i += blockDim.x) offs[i] = 0;
  __syncthreads();

  const int64_t row_begin = static_cast<int64_t>(part) * rows_per_block;
  const int64_t row_end = row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  const int64_t span = row_end > row_begin ? row_end - row_begin : 0;
  const int64_t per_warp = (span + kWarps - 1) / kWarps;
  const int64_t w_begin = row_begin + warp * per_warp;
  const int64_t w_end = w_begin + per_warp < row_end ? w_begin + per_warp : row_end;
  const int32_t* ids_t = ids + static_cast<int64_t>(t) * n;
  int32_t* my = offs + warp * max_nodes;

  // 1. Per-warp counts: the lowest lane of each id adds its group's size.
  for (int64_t base = w_begin; base < w_end; base += 32) {
    const int64_t row = base + lane;
    const int id = row < w_end ? ids_t[row] : -1;
    const bool valid = id >= 0 && id < max_nodes;
    const unsigned same = __match_any_sync(kFull, valid ? id : -1);
    if (valid && __ffs(same) - 1 == lane) my[id] += __popc(same);
    __syncwarp();
  }
  __syncthreads();

  // 2. Node totals, their exclusive prefix, then per-(node, warp) offsets.
  for (int m = threadIdx.x; m < max_nodes; m += blockDim.x) {
    int32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += offs[w * max_nodes + m];
    start[m] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t run = 0;
    for (int m = 0; m < max_nodes; ++m) {
      const int32_t c = start[m];
      start[m] = run;
      run += c;
    }
    start[max_nodes] = run;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < max_nodes; m += blockDim.x) {
    int32_t run = start[m];
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = offs[w * max_nodes + m];
      offs[w * max_nodes + m] = run;
      run += c;
    }
  }
  int32_t* seg_tp = seg + (static_cast<int64_t>(t) * n_parts + part) * (max_nodes + 1);
  for (int m = threadIdx.x; m <= max_nodes; m += blockDim.x) seg_tp[m] = start[m];
  __syncthreads();

  // 3. Stable scatter: destination = offset + rank among this step's equal ids.
  int32_t* perm_tp = perm + static_cast<int64_t>(t) * n + row_begin;
  for (int64_t base = w_begin; base < w_end; base += 32) {
    const int64_t row = base + lane;
    const int id = row < w_end ? ids_t[row] : -1;
    const bool valid = id >= 0 && id < max_nodes;
    const unsigned same = __match_any_sync(kFull, valid ? id : -1);
    if (valid) {
      perm_tp[my[id] + __popc(same & ((1u << lane) - 1u))] = static_cast<int32_t>(row);
    }
    __syncwarp();
    if (valid && __ffs(same) - 1 == lane) my[id] += __popc(same);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads) partition_accumulate(
    const int32_t* __restrict__ codes, int64_t n, int p, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ seg, const float* __restrict__ w, int64_t w_tree_stride,
    int n_trees, int n_parts, int n_weights, int max_nodes, int n_bins,
    int64_t rows_per_block, float* __restrict__ out) {
  extern __shared__ float tile[];  // (n_weights, max_nodes, n_bins)
  const int part = blockIdx.x;
  const int f = blockIdx.y;
  const int t = blockIdx.z;
  const int chan = max_nodes * n_bins;
  zero_tile(tile, n_weights * chan);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* seg_tp = seg + (static_cast<int64_t>(t) * n_parts + part) * (max_nodes + 1);
  const int32_t* perm_tp = perm + static_cast<int64_t>(t) * n
                           + static_cast<int64_t>(part) * rows_per_block;
  const float* w_t = w + static_cast<int64_t>(t) * w_tree_stride;
  for (int m = warp; m < max_nodes; m += kWarps) {
    const int32_t s1 = seg_tp[m + 1];
    for (int32_t i = seg_tp[m]; i < s1; i += 32) {
      RowIn r;
      r.cell = -1;
      int64_t row = 0;
      if (i + lane < s1) {
        row = perm_tp[i + lane];
        const int code = codes[row * p + f];
        if (code >= 0 && code < n_bins) r.cell = m * n_bins + code;
      }
      load_weights(r, w_t, n, row, n_weights);
      add_in_lane_order(tile, chan, n_weights, r);
    }
  }
  __syncthreads();
  write_tile(tile, n_trees, n_weights, max_nodes, p, n_bins, part, f, t, out);
}

}  // namespace

extern "C" int ate_hist_partition(const void* codes, int64_t n, int p, const void* ids,
                                  const void* w, int64_t w_tree_stride, int n_trees,
                                  int n_weights, int max_nodes, int n_bins, int n_parts,
                                  void* perm, void* seg, void* partial, void* out,
                                  void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows_per_block = (n + n_parts - 1) / n_parts;
  const size_t sort_smem = static_cast<size_t>(kWarps * max_nodes + max_nodes + 1) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      partition_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sort_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_rows<<<dim3(n_parts, n_trees), kThreads, sort_smem, s>>>(
      static_cast<const int32_t*>(ids), n, n_parts, max_nodes, rows_per_block,
      static_cast<int32_t*>(perm), static_cast<int32_t*>(seg));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = static_cast<size_t>(n_weights) * max_nodes * n_bins * sizeof(float);
  err = cudaFuncSetAttribute(partition_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dst = static_cast<float*>(n_parts > 1 ? partial : out);
  partition_accumulate<<<dim3(n_parts, p, n_trees), kThreads, smem, s>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(seg), static_cast<const float*>(w), w_tree_stride, n_trees,
      n_parts, n_weights, max_nodes, n_bins, rows_per_block, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  return static_cast<int>(launch_reduce(static_cast<const float*>(partial), n_parts, size,
                                        static_cast<float*>(out), s));
}

extern "C" const char* ate_hist_partition_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
