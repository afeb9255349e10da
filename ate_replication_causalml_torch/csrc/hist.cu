// Tree-batched weighted histogram for forest split search.
//
//   out[t, k, m, f, b] = sum_row  w[t, k, row] * [ids[t, row] == m] * [codes[row, f] == b]
//
// Replaces ate_replication_causalml_tpu/ops/hist_pallas.py::_hist_kernel_batched
// (dense mode; entry bin_histogram_pallas_batched), and with it the
// single-tree _hist_kernel as the T = 1 case. The forest grower calls it
// once per tree chunk and level (per-level split histograms, K = 2:
// bootstrap counts and counts * y) and once per chunk for the leaf sums
// (node_sums: p = 1, n_bins = 1, M = 2^depth).
//
// What bounds it on an H100: the bytes. Per row it reads one id, K
// weights and p codes and does p * K additions; the output is
// T * K * M * p * n_bins floats (22 MB at T = 16, M = 128, p = 21,
// n_bins = 64). Far below the card's arithmetic rate either way.
//
// Design. The TPU kernel built one-hot matrices and contracted them on
// the MXU; on the card the same sum is a scatter-accumulate. One block
// owns one (tree, feature, row range) and accumulates its (K, M, n_bins)
// tile in shared memory (64 KB at K = 2, M = 128, n_bins = 64: dynamic
// shared memory, raised with cudaFuncSetAttribute), so each row costs
// one global read of its id, weights and code and K shared-memory
// atomics. Ids outside [0, M) and codes outside [0, n_bins) add nothing.
// When several row ranges split the rows (few trees or features, many
// rows), each block writes its tile to a scratch slab and a second pass
// adds the slabs in a fixed order: no float atomics in global memory, so
// reruns are bitwise equal.
//
// Exactness: shared-memory float atomics add in an order that varies
// from run to run. The forest's classifier weights are small integers
// (Poisson counts and counts * y with y in {0, 1}), whose f32 sums are
// exact in any order, so the result is bitwise reproducible there. Float
// weights (a regression forest's centered targets, the causal forest's
// shared-weight channels) will need an ordered in-block reduction
// instead; until then the wrapper (ops/hist.py) launches this kernel
// only for weights its caller states are integers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) hist_accumulate(
    const int32_t* __restrict__ codes, int64_t n, int p,
    const int32_t* __restrict__ ids, const float* __restrict__ w,
    int n_trees, int n_weights, int max_nodes, int n_bins,
    int64_t rows_per_block, float* __restrict__ out) {
  extern __shared__ float tile[];  // (n_weights, max_nodes, n_bins)
  const int part = blockIdx.x;
  const int f = blockIdx.y;
  const int t = blockIdx.z;
  const int tile_size = n_weights * max_nodes * n_bins;
  for (int i = threadIdx.x; i < tile_size; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();

  const int64_t row_begin = static_cast<int64_t>(part) * rows_per_block;
  const int64_t row_end = row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  const int32_t* ids_t = ids + static_cast<int64_t>(t) * n;
  const float* w_t = w + static_cast<int64_t>(t) * n_weights * n;
  const int chan = max_nodes * n_bins;
  for (int64_t row = row_begin + threadIdx.x; row < row_end; row += blockDim.x) {
    const int id = ids_t[row];
    if (id < 0 || id >= max_nodes) continue;
    const int code = codes[row * p + f];
    if (code < 0 || code >= n_bins) continue;
    const int cell = id * n_bins + code;
    for (int k = 0; k < n_weights; ++k) {
      atomicAdd(&tile[k * chan + cell], w_t[static_cast<int64_t>(k) * n + row]);
    }
  }
  __syncthreads();

  // Tile (k, m, b) -> out[part][t][k][m][f][b].
  const int64_t slab = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  float* out_part = out + part * slab;
  const int64_t tree_base = static_cast<int64_t>(t) * n_weights * max_nodes;
  for (int i = threadIdx.x; i < tile_size; i += blockDim.x) {
    const int b = i % n_bins;
    const int km = i / n_bins;  // k * max_nodes + m
    out_part[((tree_base + km) * p + f) * n_bins + b] = tile[i];
  }
}

// out[e] = partial[0][e] + partial[1][e] + ... in this order.
__global__ void hist_reduce(const float* __restrict__ partial, int n_parts,
                            int64_t size, float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < size; e += stride) {
    float s = partial[e];
    for (int r = 1; r < n_parts; ++r) s += partial[r * size + e];
    out[e] = s;
  }
}

}  // namespace

extern "C" int ate_hist(const void* codes, int64_t n, int p, const void* ids,
                        const void* w, int n_trees, int n_weights, int max_nodes,
                        int n_bins, int n_parts, void* partial, void* out,
                        void* stream) {
  const size_t smem = static_cast<size_t>(n_weights) * max_nodes * n_bins * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_per_block = (n + n_parts - 1) / n_parts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(n_parts > 1 ? partial : out);
  hist_accumulate<<<dim3(n_parts, p, n_trees), kThreads, smem, s>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(ids),
      static_cast<const float*>(w), n_trees, n_weights, max_nodes, n_bins,
      rows_per_block, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  const int64_t want = (size + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  hist_reduce<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial), n_parts, size,
                                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
