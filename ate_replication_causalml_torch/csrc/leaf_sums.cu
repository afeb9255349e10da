// Per-node weighted sums: the forests' leaf sums.
//
//   out[t, m, k] = sum_row  w[t, k, row] * [ids[t, row] == m]
//
// Replaces ate_replication_causalml_tpu/ops/hist_pallas.py::node_sums and
// ::node_sums_shared, which reach _hist_kernel_batched (through
// bin_histogram / bin_histogram_shared) as the degenerate histogram of
// one constant feature; the port ran them the same way, on hist.cu's
// dense kernel at p = 1, n_bins = 1. The classifier and regressor
// growers call it once a chunk for the leaf counts and sums (K = 2, M =
// 2^depth = 512), the causal grower for the honest leaf payloads (K = 5
// float moment channels shared by every tree, M = 256) and, in the
// direct-rho grower, once a level. Ids outside [0, M) add nothing.
//
// The bits are the dense route's: each (t, m, k) adds its rows in
// ascending row order, from 0.0, within each of ops/hist.py::_n_parts(n,
// T, 1) row ranges of ceil(n / n_parts) rows, and the range sums are
// added in range order, s = range 0's; s += range r's (hist_common.cuh's
// hist_reduce). Integer weights give the same sums in any order; float
// weights (a regressor's counts * y, the causal moments) only in this
// one, and the forests' pinned results depend on it.
//
// What bounds it on an H100: the bytes, per (tree, row) a 4-byte id and,
// per tree or once for shared weights, K 4-byte weights (0.00065 ms for
// the sweep's 16 trees of 11,016 rows at K = 2; 0.057 ms at 1M rows). The
// dense route was far from it: at p = 1 and one bin each of its 4 warps
// walked every row of the range to add a quarter of the leaves, each add
// an ordered shared-memory read-modify-write, a second launch added the
// partial slabs, and an all-zero codes column was filled and staged.
//
// Design. One block (512 threads) takes one row range of one tree and a
// group of leaves (one, unless the leaves' counters exceed the block's
// shared memory). It streams the range in chunks, double buffered with
// cp.async (16-byte copies where the run is aligned): the tree's ids and
// the K weight rows. For each chunk:
//   1. each warp counts the rows of its own contiguous share of the
//      chunk into its own per-leaf counters (shared atomics: a count is
//      the same in any order);
//   2. one exclusive scan of the leaves' totals, then each (leaf, warp)'s
//      offset in (leaf, warp) order: the warp's cursor into the leaf's
//      bucket;
//   3. each row's chunk position goes into its leaf's bucket at a slot a
//      shared atomic on its warp's cursor hands out, so a bucket holds its
//      rows in row order, but for lanes of one 32-row step that share a
//      leaf, which get that step's slots in the order the card serves the
//      atomics;
//   4. one thread owns each leaf and adds its bucket's rows' weights into
//      the leaf's K running sums, which live in shared memory for the
//      whole range and only their owner touches, checking the row order
//      as it goes; a bucket out of order is sorted (each row at most 31
//      places off) and added again.
// Ranking a step's equal ids in place instead (__match_any_sync, or one
// ballot per bit of the leaf index) took most of the kernel at 512
// leaves, where most of a step's 32 ids differ; one-block-wide slots left
// the buckets far out of order, and sorting them cost most of the kernel
// on a forest's skewed leaves; staging shared weights once for 2 or 4
// trees a block was slower, its shorter chunks costing more than the L2
// re-reads it saved (PERF.md, the leaf-sum kernel). Every staged row is
// visited once by each step, and no add waits on another thread. The
// ranges are added in order without a second launch:
// with up to 8 ranges, the range blocks of one (tree, leaf group) form a
// thread-block cluster, and block r adds the r-th share of the sums over
// the cluster's tiles through distributed shared memory, range 0's value
// first (hist_partition.cu's idiom; one range: a cluster of one); with
// more (66 at 1M rows), each block writes its range's tile to a slab and
// the last block of its (tree, leaf group) to arrive, by an atomic count
// in a zeroed buffer that it resets to 0 when done, adds the slabs in
// range order. K is a template parameter (1..8).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_cap.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLeafThreads = 512;
constexpr int kLeafWarps = kLeafThreads / 32;
constexpr int kLeafStep = 32 * kLeafWarps;  // rows one step of every warp covers
constexpr int kMaxWeights = 8;
constexpr int kMaxClusterRanges = 8;  // the portable cluster size
constexpr int kMaxChunkRows = 1 << 16;  // chunk positions are uint16
constexpr unsigned kFull = 0xffffffffu;
// Two blocks an SM (the shared-memory budget of ops/hist.py): up to 64
// registers a thread.
constexpr int kLeafMinBlocks = 2;

enum Fold { kCluster = 0, kSlab = 1 };  // how the range sums are added (ops/hist.py picks)

struct LeafArgs {
  const int32_t* ids;  // (T, n)
  const float* w;      // (T, K, n), tree stride w_tree_stride (0: one (K, n) stack)
  int64_t n;
  int64_t w_tree_stride;
  int64_t rows_per_range;
  int n_trees, max_nodes, n_parts;
  int group_nodes, chunk_rows;
  int fold;
  float* slab;          // kSlab: (n_parts, T, leaf groups, tile)
  unsigned* arrivals;   // kSlab: (T, leaf groups), zero at launch
  float* out;           // (T, M, K)
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a staged run starts in its slot: (src's address / 4) mod 4 words
// in, so that the slot and the source agree modulo 16 bytes.
__device__ __forceinline__ int stage_shift(const void* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
}

// src[0, cnt) (4-byte words) into slot + stage_shift(src): 16-byte copies
// for the aligned body, 4-byte ones for the head and tail. Every thread
// of the block starts its share; the slot holds cnt + 3 words.
__device__ __forceinline__ void stage_run(int32_t* slot, const int32_t* __restrict__ src,
                                          int cnt) {
  const int shift = stage_shift(src);
  int32_t* dst = slot + shift;
  const int head = min(cnt, (4 - shift) & 3);
  const int body = (cnt - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) copy4(dst + i, src + i);
  for (int u = threadIdx.x; u < body; u += blockDim.x) {
    copy16(dst + head + 4 * u, src + head + 4 * u);
  }
  for (int i = head + 4 * body + threadIdx.x; i < cnt; i += blockDim.x) copy4(dst + i, src + i);
}

// Steps 1-3 for one tree of a chunk: bucket m = pos[base[m], base[m + 1])
// holds the chunk positions of the rows with id m_lo + m, in row order but
// for rows of one warp step (see step 3). sid: the chunk's staged ids;
// rows: its rows; cnt: (kLeafWarps, group_nodes) counters.
__device__ __forceinline__ void place(const int32_t* __restrict__ sid, int rows, int m_lo,
                                      int nodes, int group_nodes, int32_t* __restrict__ cnt,
                                      int32_t* __restrict__ base, uint16_t* __restrict__ pos,
                                      int32_t* __restrict__ warp_sums) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kLeafWarps * group_nodes; i += blockDim.x) cnt[i] = 0;
  // Each warp's contiguous share, whole 32-row steps: warps in order hold
  // ascending rows.
  const int share = ((rows + kLeafStep - 1) / kLeafStep) * 32;
  const int w_lo = warp * share;
  const int w_hi = min(w_lo + share, rows);
  int32_t* my = cnt + warp * group_nodes;
  __syncthreads();

  // 1. Each warp counts its share's rows of each leaf (shared atomics on
  //    its own counters: a count is the same in any order).
  for (int r = w_lo + lane; r < w_hi; r += 32) {
    const int id = sid[r];
    if (id >= m_lo && id - m_lo < nodes) atomicAdd(my + (id - m_lo), 1);
  }
  __syncthreads();

  // 2. The leaves' totals, their exclusive scan (each thread a contiguous
  //    run of leaves), then each (leaf, warp)'s offset in (leaf, warp)
  //    order, which becomes the warp's cursor.
  const int per = (nodes + blockDim.x - 1) / blockDim.x;
  const int m0 = min(nodes, static_cast<int>(threadIdx.x) * per);
  const int m1 = min(nodes, m0 + per);
  int32_t local = 0;
  for (int m = m0; m < m1; ++m) {
    int32_t total = 0;
    for (int w = 0; w < kLeafWarps; ++w) total += cnt[w * group_nodes + m];
    base[m] = total;
    local += total;
  }
  int32_t incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t v = lane < kLeafWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    if (lane < kLeafWarps) warp_sums[lane] = v;
  }
  __syncthreads();
  int32_t run = incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int m = m0; m < m1; ++m) {
    const int32_t total = base[m];
    base[m] = run;
    int32_t off = run;
    for (int w = 0; w < kLeafWarps; ++w) {
      const int32_t c = cnt[w * group_nodes + m];
      cnt[w * group_nodes + m] = off;
      off += c;
    }
    run += total;
  }
  if (threadIdx.x == 0) base[nodes] = warp_sums[kLeafWarps - 1];
  __syncthreads();

  // 3. Each row's position into its bucket, at a slot a shared atomic on
  //    its warp's cursor hands out: the warps' shares and each warp's steps
  //    in row order; the lanes of one step that share a leaf get that
  //    step's slots in the order the card serves them, which the owner
  //    checks.
  for (int r = w_lo + lane; r < w_hi; r += 32) {
    const int id = sid[r];
    if (id >= m_lo && id - m_lo < nodes) {
      pos[atomicAdd(my + (id - m_lo), 1)] = static_cast<uint16_t>(r);
    }
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kLeafThreads, kLeafMinBlocks) leaf_sums_kernel(LeafArgs a) {
  extern __shared__ int32_t smem[];
  const int part = blockIdx.x;
  const int t = blockIdx.y;
  const int lg = blockIdx.z;
  const int m_lo = lg * a.group_nodes;
  const int nodes = min(a.group_nodes, a.max_nodes - m_lo);
  const int gm = a.group_nodes;
  const int slot = a.chunk_rows + 4;
  const int arrays = 1 + K;  // a stage: the tree's ids, then the K weight rows
  int32_t* stages = smem;
  int32_t* cnt = stages + 2 * arrays * slot;
  int32_t* base = cnt + kLeafWarps * gm;
  uint16_t* pos = reinterpret_cast<uint16_t*>(base + gm + 1);
  float* acc = reinterpret_cast<float*>(base + gm + 1 + a.chunk_rows / 2);  // (gm, K)
  const int tile = gm * K;
  int32_t* warp_sums = reinterpret_cast<int32_t*>(acc + tile);  // kLeafWarps, then a flag
  int32_t* last_block = warp_sums + kLeafWarps;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) acc[i] = 0.0f;

  const int64_t row_begin = static_cast<int64_t>(part) * a.rows_per_range;
  const int64_t row_end = min64(a.n, row_begin + a.rows_per_range);
  const int64_t span = row_end > row_begin ? row_end - row_begin : 0;
  const int n_chunks = static_cast<int>((span + a.chunk_rows - 1) / a.chunk_rows);
  const int32_t* ids_t = a.ids + static_cast<int64_t>(t) * a.n;
  const float* w_t = a.w + static_cast<int64_t>(t) * a.w_tree_stride;
  auto weights_of = [&](int k, int64_t r0) {
    return reinterpret_cast<const int32_t*>(w_t + static_cast<int64_t>(k) * a.n + r0);
  };
  auto stage_chunk = [&](int c) {  // one commit group a chunk, empty past the last
    if (c < n_chunks) {
      int32_t* buf = stages + (c & 1) * arrays * slot;
      const int64_t r0 = row_begin + static_cast<int64_t>(c) * a.chunk_rows;
      const int rows = static_cast<int>(min64(a.chunk_rows, row_end - r0));
      stage_run(buf, ids_t + r0, rows);
      for (int k = 0; k < K; ++k) stage_run(buf + (1 + k) * slot, weights_of(k, r0), rows);
    }
    copy_commit();
  };
  stage_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    stage_chunk(c + 1);
    copy_wait<1>();  // chunk c has landed (groups complete in order)
    __syncthreads();
    const int32_t* buf = stages + (c & 1) * arrays * slot;
    const int64_t r0 = row_begin + static_cast<int64_t>(c) * a.chunk_rows;
    const int rows = static_cast<int>(min64(a.chunk_rows, row_end - r0));
    // Weight row k of the chunk starts at sw + woff[k].
    const float* sw = reinterpret_cast<const float*>(buf + slot);
    int woff[K];
#pragma unroll
    for (int k = 0; k < K; ++k) woff[k] = k * slot + stage_shift(weights_of(k, r0));
    const int32_t* sid = buf + stage_shift(ids_t + r0);
    place(sid, rows, m_lo, nodes, gm, cnt, base, pos, warp_sums);
    // 4. Each leaf's owner adds its bucket's rows to its running sums,
    //    checking as it goes that they come in row order. A bucket that
    //    does not (lanes of one step served out of lane order) is sorted
    //    in place, each row at most 31 places from its own, and added
    //    again from the range's sums.
    for (int m = threadIdx.x; m < nodes; m += blockDim.x) {
      float* s = acc + m * K;
      float run[K];
      auto add_row = [&](int r) {
#pragma unroll
        for (int k = 0; k < K; ++k) run[k] += sw[woff[k] + r];
      };
#pragma unroll
      for (int k = 0; k < K; ++k) run[k] = s[k];
      const int beg = base[m];
      const int end = base[m + 1];
      bool ordered = true;
      int prev = -1;
#pragma unroll 4
      for (int i = beg; i < end; ++i) {
        const int r = pos[i];
        ordered = ordered && r > prev;
        prev = r;
        add_row(r);
      }
      if (!ordered) {
#pragma unroll
        for (int k = 0; k < K; ++k) run[k] = s[k];
        for (int i = beg + 1; i < end; ++i) {
          const uint16_t v = pos[i];
          int j = i - 1;
          for (; j >= beg && pos[j] > v; --j) pos[j + 1] = pos[j];
          pos[j + 1] = v;
        }
        for (int i = beg; i < end; ++i) add_row(pos[i]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = run[k];
    }
    __syncthreads();  // the counters, buckets and the stage are free
  }
  __syncthreads();

  // The ranges in order. A tile cell i = m * K + k is out's
  // (t * M + m_lo + m) * K + k.
  auto out_index = [&](int i, int64_t* o) {
    if (i / K >= nodes) return false;
    *o = (static_cast<int64_t>(t) * a.max_nodes + m_lo) * K + i;
    return true;
  };
  int64_t o = 0;
  if (a.fold == kCluster) {
    // Every block of the cluster reaches both barriers, rows or none.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every range's tile is full
    const int share = (tile + a.n_parts - 1) / a.n_parts;
    const int hi = min(tile, (part + 1) * share);
    for (int i = part * share + threadIdx.x; i < hi; i += blockDim.x) {
      float v = *cluster.map_shared_rank(acc + i, 0);
      for (int r = 1; r < a.n_parts; ++r) v += *cluster.map_shared_rank(acc + i, r);
      if (out_index(i, &o)) a.out[o] = v;
    }
    cluster.sync();  // no block leaves while a peer still reads its tile
    return;
  }
  // kSlab: this range's tile, then the last block to arrive adds them all.
  const int64_t groups = static_cast<int64_t>(gridDim.y) * gridDim.z;
  const int64_t cell0 = static_cast<int64_t>(t) * gridDim.z + lg;
  float* mine = a.slab + (part * groups + cell0) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) mine[i] = acc[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *last_block = atomicAdd(a.arrivals + cell0, 1u) == static_cast<unsigned>(a.n_parts - 1);
  }
  __syncthreads();
  if (!*last_block) return;
  __threadfence();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    float v = __ldcg(a.slab + cell0 * tile + i);
    // The loads are independent: unrolled, eight are in flight at once.
#pragma unroll 8
    for (int r = 1; r < a.n_parts; ++r) v += __ldcg(a.slab + (r * groups + cell0) * tile + i);
    if (out_index(i, &o)) a.out[o] = v;
  }
  if (threadIdx.x == 0) a.arrivals[cell0] = 0u;  // every block has arrived: ready for reuse
}

size_t block_bytes(int k, int group_nodes, int chunk_rows) {
  const size_t words = 2 * static_cast<size_t>(1 + k) * (chunk_rows + 4) +
                       static_cast<size_t>(kLeafWarps) * group_nodes + group_nodes + 1 +
                       chunk_rows / 2 + static_cast<size_t>(group_nodes) * k +
                       kLeafWarps + 1;
  return 4 * words;
}

template <int K>
cudaError_t launch_leaf_sums(const LeafArgs& a, int leaf_groups, cudaStream_t stream) {
  const size_t smem = block_bytes(K, a.group_nodes, a.chunk_rows);
  cudaError_t err = raise_smem_cap(leaf_sums_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_parts, a.n_trees, leaf_groups);
  cfg.blockDim = dim3(kLeafThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.fold == kCluster ? a.n_parts : 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, leaf_sums_kernel<K>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// ids (T, n) int32; w (T, n_weights, n) float32 with tree stride
// w_tree_stride (0: one (n_weights, n) stack for every tree); out (T,
// max_nodes, n_weights) float32. n_parts row ranges of ceil(n / n_parts)
// rows; leaf_groups blocks split the leaves; chunk_rows a multiple of
// 512. fold 0: the ranges' blocks form one cluster (at most 8 ranges);
// fold 1: a slab a range, which needs slab (n_parts * T * leaf_groups *
// ceil(max_nodes / leaf_groups) * n_weights floats) and arrivals (T *
// leaf_groups unsigned ints, zero; the kernel leaves them zero).
extern "C" int ate_leaf_sums(const void* ids, int64_t n, int n_trees, const void* w,
                             int64_t w_tree_stride, int n_weights, int max_nodes, int n_parts,
                             int leaf_groups, int chunk_rows, int fold,
                             void* slab, void* arrivals, void* out, void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights || n_trees < 1 || n < 1 || n_parts < 1 ||
      max_nodes < 1 || leaf_groups < 1 || leaf_groups > max_nodes || chunk_rows < kLeafStep ||
      chunk_rows % kLeafStep != 0 || chunk_rows > kMaxChunkRows ||
      n_trees > 65535 || leaf_groups > 65535 ||
      (fold == kCluster && n_parts > kMaxClusterRanges) ||
      (fold == kSlab && (slab == nullptr || arrivals == nullptr)) ||
      (fold != kCluster && fold != kSlab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeafArgs a{};
  a.ids = static_cast<const int32_t*>(ids);
  a.w = static_cast<const float*>(w);
  a.n = n;
  a.w_tree_stride = w_tree_stride;
  a.rows_per_range = (n + n_parts - 1) / n_parts;
  a.n_trees = n_trees;
  a.max_nodes = max_nodes;
  a.n_parts = n_parts;
  a.group_nodes = (max_nodes + leaf_groups - 1) / leaf_groups;
  a.chunk_rows = chunk_rows;
  a.fold = fold;
  a.slab = static_cast<float*>(slab);
  a.arrivals = static_cast<unsigned*>(arrivals);
  a.out = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_weights) {
    case 1: err = launch_leaf_sums<1>(a, leaf_groups, s); break;
    case 2: err = launch_leaf_sums<2>(a, leaf_groups, s); break;
    case 3: err = launch_leaf_sums<3>(a, leaf_groups, s); break;
    case 4: err = launch_leaf_sums<4>(a, leaf_groups, s); break;
    case 5: err = launch_leaf_sums<5>(a, leaf_groups, s); break;
    case 6: err = launch_leaf_sums<6>(a, leaf_groups, s); break;
    case 7: err = launch_leaf_sums<7>(a, leaf_groups, s); break;
    case 8: err = launch_leaf_sums<8>(a, leaf_groups, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

extern "C" const char* ate_leaf_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
