// Pieces shared by the two histogram kernels (hist.cu: dense,
// hist_partition.cu: partition). Each .cu compiles into its own library,
// so everything here is internal to the including file.
//
// The ordered reduction. A block owns one (row range, feature, tree) and
// keeps its (K, M, n_bins) tile in shared memory. Each cell adds its rows
// in ascending row order, one add at a time, starting from 0.0: no float
// atomics, so the result does not depend on scheduling and two launches
// on the same input are bitwise equal. Within a warp, a step covers 32
// rows in lane order; lanes that hit the same cell are ranked by lane
// (__match_any_sync), and the adds of rank r finish before those of rank
// r + 1. Across warps, each cell is written by one warp only (the dense
// kernel gives cell c to warp c mod 4, the partition kernel gives node m
// to warp m mod 16), which walks its rows in ascending order. When
// several row ranges split the rows, a second pass adds their partial
// tiles in range order. Dense and partition share the row ranges and the
// second pass, so they give the same bits for float weights too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // the partition kernels' block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWeights = 8;  // K, the weight channels of one launch
constexpr unsigned kFull = 0xffffffffu;

// One lane's row: its cell in the tile (-1: adds nothing) and weights.
struct RowIn {
  int cell;
  float w[kMaxWeights];
};

__device__ __forceinline__ void load_weights(RowIn& r, const float* __restrict__ w_t,
                                             int64_t n, int64_t row, int n_weights) {
#pragma unroll
  for (int k = 0; k < kMaxWeights; ++k) {
    r.w[k] = (r.cell >= 0 && k < n_weights) ? w_t[static_cast<int64_t>(k) * n + row] : 0.0f;
  }
}

// tile[k * chan + cell] += w[k] for every lane with cell >= 0, lanes of one
// cell in ascending lane order. Warp-uniform: every lane must call it.
__device__ __forceinline__ void add_in_lane_order(float* tile, int chan, int n_weights,
                                                  const RowIn& r) {
  const int lane = threadIdx.x & 31;
  const bool mine = r.cell >= 0;
  const unsigned same = __match_any_sync(kFull, mine ? r.cell : -1);
  const int rank = __popc(same & ((1u << lane) - 1u));
  for (int step = 0; __any_sync(kFull, mine && rank >= step); ++step) {
    if (mine && rank == step) {
#pragma unroll
      for (int k = 0; k < kMaxWeights; ++k) {
        if (k < n_weights) tile[k * chan + r.cell] += r.w[k];
      }
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_tile(float* tile, int size) {
  for (int i = threadIdx.x; i < size; i += blockDim.x) tile[i] = 0.0f;
}

// Tile (k, m, b) of (tree t, feature f) -> out[part][t][k][m][f][b].
__device__ __forceinline__ void write_tile(const float* tile, int n_trees, int n_weights,
                                           int max_nodes, int p, int n_bins, int part, int f,
                                           int t, float* __restrict__ out) {
  const int size = n_weights * max_nodes * n_bins;
  const int64_t slab = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  float* out_part = out + part * slab;
  const int64_t tree_base = static_cast<int64_t>(t) * n_weights * max_nodes;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const int b = i % n_bins;
    const int km = i / n_bins;  // k * max_nodes + m
    out_part[((tree_base + km) * p + f) * n_bins + b] = tile[i];
  }
}

// out[e] = partial[0][e] + partial[1][e] + ... in this order.
__global__ void hist_reduce(const float* __restrict__ partial, int n_parts, int64_t size,
                            float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < size;
       e += stride) {
    float s = partial[e];
    for (int r = 1; r < n_parts; ++r) s += partial[r * size + e];
    out[e] = s;
  }
}

cudaError_t launch_reduce(const float* partial, int n_parts, int64_t size, float* out,
                          cudaStream_t s) {
  const int64_t want = (size + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  hist_reduce<<<blocks, 256, 0, s>>>(partial, n_parts, size, out);
  return cudaGetLastError();
}

}  // namespace
