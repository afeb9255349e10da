// Pieces shared by the two histogram kernels (hist.cu: dense,
// hist_partition.cu: partition). Each .cu compiles into its own library,
// so everything here is internal to the including file.
//
// The ordered reduction. Each cell adds its rows in ascending row order,
// one add at a time, starting from 0.0: no float atomics, so the result
// does not depend on scheduling and two launches on the same input are
// bitwise equal. Within a warp, a step covers 32 rows in lane order;
// lanes that hit the same cell are ranked by lane (__match_any_sync), and
// the adds of rank r finish before those of rank r + 1. Across warps, each
// cell is written by one warp only, which walks its rows in ascending
// order: the dense kernel gives each warp whole features and a contiguous
// run of nodes, and the partition passes a contiguous run of nodes per
// warp and feature (or slot). When several row ranges split the rows,
// their partial tiles are added in range order: by a second pass over one
// slab per range, across the blocks of a thread-block cluster, or by a
// packed-pass block itself, range after range. Dense and partition share
// the row ranges and that sum, so they give the same bits for float
// weights too.
//
// What bounds these kernels on an H100 is latency, not bytes or
// arithmetic: a warp's adds into one tile form a chain of shared-memory
// read-modify-writes, one 32-row step after another, and the contract
// fixes its length (the rows of a range over 32). A step costs the more
// ordered rounds the more of its lanes share a cell (a few at 64 cells, one
// at thousands). So the kernels keep each step short (the K weight
// channels are a template parameter: K registers, no runtime channel loop,
// no local-memory array; one __reduce_max_sync gives the rounds) and put
// as many independent chains on an SM as shared memory allows. Ranks from
// one ballot per bit of the cell index, tried in place of
// __match_any_sync, did not shorten the step.
//
// The bf16 form (the JAX package's hist_backend="pallas_bf16": its kernels'
// in_dtype=bfloat16) rounds each weight once, as it is loaded, to bfloat16
// (round to nearest, ties to even, as XLA's astype) and adds the widened
// value in float32: the products with the 0/1 indicators stay exact and the
// sums keep their order, so dense, partition and packed agree bit for bit in
// this form too. It is a template flag (kBf16): the float32 form compiles
// exactly as before.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // the partition kernels' block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWeights = 8;  // K, the weight channels of one launch
constexpr unsigned kFull = 0xffffffffu;

// tile[k * chan + cell] += w[k] for every lane with cell >= 0, lanes of one
// cell in ascending lane order. Warp-uniform: every lane must call it.
template <int K>
__device__ __forceinline__ void add_ordered(float* tile, int chan, int cell, const float (&w)[K]) {
  const unsigned lane = threadIdx.x & 31u;
  const bool mine = cell >= 0;
  const unsigned same = __match_any_sync(kFull, mine ? cell : -1);
  const unsigned rank = __popc(same & ((1u << lane) - 1u));
  const unsigned rounds = __reduce_max_sync(kFull, mine ? rank + 1u : 0u);
  for (unsigned r = 0; r < rounds; ++r) {
    if (mine && rank == r) {
#pragma unroll
      for (int k = 0; k < K; ++k) tile[k * chan + cell] += w[k];
    }
    __syncwarp();
  }
}

// add_ordered's adds with a step's running sums in registers: the lowest
// lane of each cell reads the tile and adds its weights, each later lane of
// the cell takes the running sum from the one before it (a shuffle) and
// adds its own, and the cell's highest lane writes the sum back. The same
// float adds in the same order, so the same bits; a round costs K shuffles
// and adds where add_ordered's costs K shared-memory read-modify-writes and
// a __syncwarp (the unpacked partition pass's accumulate took 0.75-0.93x
// the time with it, scripts/torch_hist_geometry.py). Warp-uniform: every
// lane must call it.
template <int K>
__device__ __forceinline__ void add_chained(float* tile, int chan, int cell, const float (&w)[K]) {
  const unsigned lane = threadIdx.x & 31u;
  const bool mine = cell >= 0;
  const unsigned same = __match_any_sync(kFull, mine ? cell : -1);
  const unsigned below = same & ((1u << lane) - 1u);
  const unsigned rank = __popc(below);
  const unsigned rounds = __reduce_max_sync(kFull, mine ? rank + 1u : 0u);
  const int prev = below ? 31 - __clz(below) : static_cast<int>(lane);  // rank - 1's lane
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = mine && rank == 0 ? tile[k * chan + cell] + w[k] : 0.0f;
  for (unsigned r = 1; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = __shfl_sync(kFull, acc[k], prev);
      if (mine && rank == r) acc[k] = v + w[k];
    }
  }
  if (mine && (same >> lane) == 1u) {  // the cell's highest lane
#pragma unroll
    for (int k = 0; k < K; ++k) tile[k * chan + cell] = acc[k];
  }
  __syncwarp();
}

// A weight as the kernels add it: rounded to bfloat16 and widened back in
// the bf16 form, unchanged otherwise.
template <bool kBf16>
__device__ __forceinline__ float operand(float w) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(w));
  } else {
    return w;
  }
}

// w[k] = w_t[k * n + row] (as operand<kBf16>) for a lane that holds a row,
// else 0.
template <int K, bool kBf16 = false>
__device__ __forceinline__ void load_weights(float (&w)[K], const float* __restrict__ w_t,
                                             int64_t n, int64_t row, bool live) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = live ? operand<kBf16>(w_t[static_cast<int64_t>(k) * n + row]) : 0.0f;
  }
}

__device__ __forceinline__ void zero_tile(float* tile, int size) {
  for (int i = threadIdx.x; i < size; i += blockDim.x) tile[i] = 0.0f;
}

// A (K, tile_nodes, n_bins) tile holding nodes [m_lo, m_lo + nodes) of
// (tree t, feature f) -> out[part][t][k][m][f][b]; nodes <= tile_nodes.
// With accumulate, out[0][...] += tile instead: a block that adds its row
// ranges in range order itself (the second pass's arithmetic, in place).
__device__ __forceinline__ void write_tile(const float* tile, int n_trees, int n_weights,
                                           int max_nodes, int p, int n_bins, int part, int f,
                                           int t, int m_lo, int nodes, int tile_nodes,
                                           float* __restrict__ out, bool accumulate = false) {
  const int per_k = nodes * n_bins;
  const int size = n_weights * per_k;
  const int64_t slab = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  float* out_part = out + part * slab;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const int k = i / per_k;
    const int mb = i - k * per_k;  // m * n_bins + b within the tile's nodes
    const int m = mb / n_bins;
    const int b = mb - m * n_bins;
    const int64_t km = (static_cast<int64_t>(t) * n_weights + k) * max_nodes + m_lo + m;
    float* dst = out_part + (km * p + f) * n_bins + b;
    const float v = tile[k * tile_nodes * n_bins + mb];
    *dst = accumulate ? *dst + v : v;
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

// FN<K>(args...) with K = k in [1, kMaxWeights] as a compile-time
// constant; cudaErrorInvalidValue for any other k.
#define ATE_WITH_K(k, FN, ...)                                                          \
  ((k) == 1   ? FN<1>(__VA_ARGS__)                                                  \
   : (k) == 2 ? FN<2>(__VA_ARGS__)                                                  \
   : (k) == 3 ? FN<3>(__VA_ARGS__)                                                  \
   : (k) == 4 ? FN<4>(__VA_ARGS__)                                                  \
   : (k) == 5 ? FN<5>(__VA_ARGS__)                                                  \
   : (k) == 6 ? FN<6>(__VA_ARGS__)                                                  \
   : (k) == 7 ? FN<7>(__VA_ARGS__)                                                  \
   : (k) == 8 ? FN<8>(__VA_ARGS__)                                                  \
              : cudaErrorInvalidValue)
