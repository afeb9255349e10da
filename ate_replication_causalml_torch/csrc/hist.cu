// Tree-batched weighted histogram for forest split search, dense form.
//
//   out[t, k, m, f, b] = sum_row  w[t, k, row] * [ids[t, row] == m] * [codes[row, f] == b]
//
// Replaces ate_replication_causalml_tpu/ops/hist_pallas.py::_hist_kernel_batched
// (dense mode), both with per-tree weights (entry bin_histogram_pallas_batched)
// and with one weight stack shared by every tree (shared_weights=True, entry
// bin_histogram_pallas_batched_shared: the weights' tree stride is 0), and with
// it the single-tree _hist_kernel as the T = 1 case; each also in its bf16
// form (bf16=True, in_dtype=jnp.bfloat16 at hist_pallas.py:618, 755, 842).
// The classifier grower calls it per tree chunk and level (K = 2: bootstrap
// counts and counts * y) and for the leaf sums (node_sums: p = 1, n_bins =
// 1, M = 2^depth); the
// causal grower calls the shared form (K = 5 float moment channels) per
// level below the partition crossover and for the honest leaf sums.
//
// What bounds it on an H100: neither the bytes (per row one id, K weights
// and p codes; the output T * K * M * p * n_bins floats) nor the
// arithmetic, but the latency of the ordered adds (hist_common.cuh): the
// cells of one (tree, row range, feature) are one warp's chain of
// rows-in-range / 32 steps of shared-memory read-modify-writes; and the
// number of live (K, M, n_bins) tiles, which shared memory caps (at K=2,
// M=128 a tile is 64 KB, and the 1,008 tiles of a 16-tree, 21-feature,
// 3-range call need twice the card's shared memory: two waves of chains).
//
// Design. The TPU kernel built one-hot matrices and contracted them on the
// MXU; on the card the same sum is an ordered accumulation into shared
// memory tiles. One block takes (tree, group of F contiguous features,
// group of contiguous nodes, row range); it holds one (K, nodes, n_bins)
// tile per feature, F as many as fit a budget that leaves two blocks on
// an SM, but few enough for 2.5 blocks per SM in the grid
// (ops/hist.py::dense_features_per_block; node groups only where one
// feature's tile alone exceeds the budget). Warp w owns feature f0 + w mod
// F and the w / F-th contiguous run of the group's nodes (4 runs where a
// block has one feature), so each cell has one writer, and a warp reads a
// row only to add it or to skip it for a sibling warp's nodes.
// The block stages the rows of its range 128 at a time into shared memory
// (ids, K weights, and the F codes of each row, one contiguous run of
// codes[row * p + f0 ...]) with 4-byte cp.async copies, four stages deep,
// so three stages of loads are in flight while the warps add the fourth;
// every row's id and weights are read once per block, not once per warp
// and feature. K is a template parameter (1..8), and so is the bf16 form
// (kBf16: each warp rounds a row's staged weights as it reads them,
// hist_common.cuh). Ids outside [0, M) and
// codes outside [0, n_bins) add nothing. The tree is the grid's fastest
// axis, so the blocks of one row range and feature group, which read the
// same codes, run together and share them through L2.
#include "hist_common.cuh"
#include "smem_cap.cuh"

namespace {

constexpr int kDenseMaxThreads = 512;
// Two blocks an SM (the shared-memory budget of ops/hist.py): up to 64
// registers a thread, so ptxas need not spill to reach a higher occupancy.
constexpr int kDenseMinBlocks = 2;
constexpr int kStageRows = 128;
constexpr int kStages = 4;

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: rows [r0, r0 + cnt) into st = ids[kStageRows], then
// w[K][kStageRows], then codes[nf][kStageRows] (feature-major, so that a
// warp reads its feature's codes without bank conflicts).
template <int K>
__device__ __forceinline__ void stage_rows(int32_t* st, int nf, const int32_t* __restrict__ codes,
                                           int p, int f0, const int32_t* __restrict__ ids_t,
                                           const float* __restrict__ w_t, int64_t n, int64_t r0,
                                           int cnt) {
  float* sw = reinterpret_cast<float*>(st + kStageRows);
  int32_t* sc = st + (1 + K) * kStageRows;
  for (int e = threadIdx.x; e < (1 + K) * kStageRows; e += blockDim.x) {
    const int j = e / kStageRows;
    const int r = e - j * kStageRows;
    if (r >= cnt) continue;
    if (j == 0) {
      copy4(st + r, ids_t + r0 + r);
    } else {
      copy4(sw + (j - 1) * kStageRows + r, w_t + static_cast<int64_t>(j - 1) * n + r0 + r);
    }
  }
  for (int e = threadIdx.x; e < nf * cnt; e += blockDim.x) {
    const int r = e / nf;
    const int fi = e - r * nf;
    copy4(sc + fi * kStageRows + r, codes + (r0 + r) * p + f0 + fi);
  }
}

template <int K, bool kBf16>
__global__ void __launch_bounds__(kDenseMaxThreads, kDenseMinBlocks) hist_dense(
    const int32_t* __restrict__ codes, int64_t n, int p, const int32_t* __restrict__ ids,
    const float* __restrict__ w, int64_t w_tree_stride, int n_trees, int max_nodes, int n_bins,
    int features, int group_nodes, int node_groups, int slice_nodes, int64_t rows_per_block,
    float* __restrict__ out) {
  extern __shared__ float smem[];  // features x (K, group_nodes, n_bins), then the stages
  const int t = blockIdx.x;
  const int fg = blockIdx.y / node_groups;
  const int g = blockIdx.y - fg * node_groups;
  const int part = blockIdx.z;
  const int f0 = fg * features;
  const int nf = min(features, p - f0);
  const int m_lo = g * group_nodes;
  const int nodes = min(group_nodes, max_nodes - m_lo);
  const int chan = group_nodes * n_bins;
  const int tile_size = K * chan;
  int32_t* stages = reinterpret_cast<int32_t*>(smem + features * tile_size);
  const int stage_words = (1 + K + features) * kStageRows;
  zero_tile(smem, nf * tile_size);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fi = warp % features;
  const int s_lo = (warp / features) * slice_nodes;  // this warp's nodes, group-relative
  const int s_hi = min(s_lo + slice_nodes, nodes);
  const bool active = fi < nf && s_lo < s_hi;  // warp-uniform
  float* tile = smem + fi * tile_size;

  const int64_t row_begin = static_cast<int64_t>(part) * rows_per_block;
  const int64_t row_end = row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  const int64_t span = row_end > row_begin ? row_end - row_begin : 0;
  const int n_stages = static_cast<int>((span + kStageRows - 1) / kStageRows);
  const int32_t* ids_t = ids + static_cast<int64_t>(t) * n;
  const float* w_t = w + static_cast<int64_t>(t) * w_tree_stride;
  auto rows_in = [&](int s) {
    const int64_t left = row_end - (row_begin + static_cast<int64_t>(s) * kStageRows);
    return static_cast<int>(left < kStageRows ? left : kStageRows);
  };
  auto issue = [&](int s) {  // one commit group per stage, empty past the last
    if (s < n_stages) {
      stage_rows<K>(stages + (s % kStages) * stage_words, nf, codes, p, f0, ids_t, w_t, n,
                    row_begin + static_cast<int64_t>(s) * kStageRows, rows_in(s));
    }
    copy_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n_stages; ++s) {
    issue(s + kStages - 1);
    copy_wait<kStages - 1>();  // stage s has landed (groups complete in order)
    __syncthreads();
    if (active) {
      const int32_t* st = stages + (s % kStages) * stage_words;
      const float* sw = reinterpret_cast<const float*>(st + kStageRows);
      const int32_t* sc = st + (1 + K + fi) * kStageRows;
      const int cnt = rows_in(s);
      for (int i = 0; i < cnt; i += 32) {
        const int r = i + lane;
        int cell = -1;
        if (r < cnt) {
          const int id = st[r];
          const int code = sc[r];
          if (id >= m_lo + s_lo && id < m_lo + s_hi &&
              static_cast<unsigned>(code) < static_cast<unsigned>(n_bins)) {
            cell = (id - m_lo) * n_bins + code;
          }
        }
        float wk[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          wk[k] = operand<kBf16>(sw[k * kStageRows + r]);  // r < kStageRows
        }
        add_ordered<K>(tile, chan, cell, wk);
      }
    }
    __syncthreads();  // the buffer of stage s is refilled next iteration
  }
  __syncthreads();
  for (int j = 0; j < nf; ++j) {
    write_tile(smem + j * tile_size, n_trees, K, max_nodes, p, n_bins, part, f0 + j, t, m_lo,
               nodes, group_nodes, out);
  }
}

struct DenseLaunch {
  const int32_t* codes;
  int64_t n;
  int p;
  const int32_t* ids;
  const float* w;
  int64_t w_tree_stride;
  int n_trees, max_nodes, n_bins, features, group_nodes, node_groups, slice_nodes, slices;
  int64_t rows_per_block;
  int n_parts;
  int bf16;
  float* out;
  cudaStream_t stream;
};

template <int K, bool kBf16>
cudaError_t launch_dense_form(const DenseLaunch& a) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(a.features) * K * a.group_nodes * a.n_bins +
                       static_cast<size_t>(kStages) * (1 + K + a.features) * kStageRows);
  cudaError_t err = raise_smem_cap(hist_dense<K, kBf16>, smem);
  if (err != cudaSuccess) return err;
  const int feature_groups = (a.p + a.features - 1) / a.features;
  const dim3 grid(a.n_trees, feature_groups * a.node_groups, a.n_parts);
  hist_dense<K, kBf16><<<grid, 32 * a.features * a.slices, smem, a.stream>>>(
      a.codes, a.n, a.p, a.ids, a.w, a.w_tree_stride, a.n_trees, a.max_nodes, a.n_bins,
      a.features, a.group_nodes, a.node_groups, a.slice_nodes, a.rows_per_block, a.out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_dense(const DenseLaunch& a) {
  return a.bf16 ? launch_dense_form<K, true>(a) : launch_dense_form<K, false>(a);
}

}  // namespace

// features: F per block; node_groups: G blocks split the nodes; slices:
// warps per feature, each with a contiguous run of the block's nodes; bf16:
// the bf16 form.
extern "C" int ate_hist(const void* codes, int64_t n, int p, const void* ids, const void* w,
                        int64_t w_tree_stride, int n_trees, int n_weights, int max_nodes,
                        int n_bins, int n_parts, int features, int node_groups, int slices,
                        int bf16, void* partial, void* out, void* stream) {
  if (features < 1 || node_groups < 1 || slices < 1 || node_groups > max_nodes ||
      features * slices * 32 > kDenseMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group_nodes = (max_nodes + node_groups - 1) / node_groups;
  const DenseLaunch a{static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(ids),
                      static_cast<const float*>(w), w_tree_stride, n_trees, max_nodes, n_bins,
                      features, group_nodes, node_groups, (group_nodes + slices - 1) / slices,
                      slices, (n + n_parts - 1) / n_parts, n_parts, bf16,
                      static_cast<float*>(n_parts > 1 ? partial : out),
                      static_cast<cudaStream_t>(stream)};
  const cudaError_t err = ATE_WITH_K(n_weights, launch_dense, a);
  const cudaStream_t s = a.stream;
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  return static_cast<int>(launch_reduce(static_cast<const float*>(partial), n_parts, size,
                                        static_cast<float*>(out), s));
}

extern "C" const char* ate_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
