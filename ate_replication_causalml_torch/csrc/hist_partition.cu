// Tree-batched weighted histogram, partition form: the same output as
// hist.cu (out[t, k, m, f, b] = sum_row w[t, k, row] [ids[t, row] == m]
// [codes[row, f] == b]), with the rows grouped by node first.
//
// Replaces ate_replication_causalml_tpu/ops/hist_pallas.py::
// _hist_kernel_batched_partition (partition=True on bin_histogram_pallas_batched
// and bin_histogram_pallas_batched_shared), both branches: pack=False
// (partition_accumulate) and pack=True (partition_accumulate_packed, with
// pack_words in place of the in-kernel pack matmul at hist_pallas.py:441).
// The growers launch it under the "auto" policy at and past the crossover
// width (K = 5 causal levels from width 16, K = 2 classifier levels from 32);
// under the packed policy (ATE_TPU_PREDICT_PACK=1 or a "+pack" mode) those
// widths take the packed pass.
//
// What bounds it on an H100: as for the dense kernel, the latency of the
// ordered adds (hist_common.cuh), not the bytes (the dense kernel's inputs
// and output, plus a (T, n) permutation written and read once); here each
// warp's chain is the rows of its own nodes. Two byte streams come close
// behind: partial slabs per row range, written and read again by a second
// pass (66 MB each way at K=2, M=128, 16 trees, 3 ranges), and the
// gathers, which move a 32-byte sector for every 4-byte value of a random
// row (per row and feature: a code, K weights and a node id; ~0.5 GB of
// L2 traffic a call at K=2). The passes below add the ranges without
// slabs, and the unpacked pass gathers only the code.
//
// Design. The TPU kernel regrouped rows with a one-hot permutation matmul
// in VMEM, so its FLOPs scale with rows instead of rows x nodes. On the card
// the regrouping is a stable counting sort, and each warp then reads only
// the rows of its own nodes.
//   1. partition_rows, one block per (row range, tree): each warp counts
//      the node ids of its own contiguous sixteenth of the range, an
//      exclusive prefix runs in (node, warp) order, then every row's
//      destination = its node's offset + its rank among earlier rows of
//      the same node (__match_any_sync ranks within a 32-row step). The sort is
//      stable, so a node's rows keep ascending row order. Writes perm
//      (T, n) and segment starts seg (T, n_parts, M + 1).
//   1b. partition_gather, for the unpacked pass: each sorted position's
//      node and K weights, gathered once into perm order (node_sorted,
//      w_sorted), so that the 21 feature blocks read them coalesced.
//   2. partition_accumulate (the unpacked pass), one block per (row range,
//      feature, tree) holding one (K, M, n_bins) tile (blocks of 2-4 features,
//      sharing each row's loads, ran slower). Warp r takes the contiguous nodes
//      whose segment midpoints lie in the r-th sixteenth of the range's rows
//      and walks their rows in full 32-lane steps across segment boundaries:
//      per lane, a code gathered through perm, and the node and weights at its
//      position. The step's adds run in registers (add_chained). With 2 to 8
//      row ranges the range blocks of one (feature, tree) form a thread-block
//      cluster: once every tile is full, block r adds the r-th share of the
//      cells over the cluster's tiles through distributed shared memory, range
//      0's value first, then range 1's, ..., and writes the sum: the second
//      pass's arithmetic, with no slab. One range writes its tile directly;
//      more than 8 (no path has them) keep one slab per range and the second
//      pass (hist_reduce). Each cell thus sums its rows in ascending row order
//      within each range, and the ranges in order, exactly as hist.cu does:
//      dense and partition give the same bits.
//   2'. partition_accumulate_packed (the packed pass), one block per (slot
//      group of a packed word, node group, tree). The codes come as (n, ceil(p/3)) int32
//      words of three 7-bit codes (ops/pack.py; built once per fit by
//      pack_words), split with shifts and masks: one code gather serves
//      three features (the TPU's 3x fewer permute MACs, on this card).
//      Three full (K, M, n_bins) tiles would take 3*K*M*n_bins*4 B (192 KB
//      at K=2, M=128: one block per SM, and K=5 would drop to 2 or 1
//      slots), so the nodes are split into G contiguous groups
//      (ops/hist.py::packed_node_groups) and a block holds three
//      (K, ceil(M/G), n_bins) tiles within a quarter of an SM's shared
//      memory: 3 slots at every (K, M) of the paths, 4 blocks of 16 warps
//      on an SM. The warps form 5 runs of 3: run r takes the contiguous
//      nodes whose segments start in the r-th fifth of the group's rows,
//      so its rows are one contiguous run of perm, walked in full 32-lane
//      steps across segment boundaries (a lane's node is ids[t, row]), and
//      its three warps add slot 0, 1 and 2 of each row (the row's word and
//      weights reach the second and third warp from L1). A block walks the
//      row ranges in turn and adds each range's tile into out in range
//      order: the second pass's sum without the partial slabs, which at
//      K=2, M=128 are 66 MB written and read again. A cell's rows still come in
//      ascending row order (a node's segment is, and lanes of one cell are
//      ranked by lane), over the same perm, segments and ranges, and the
//      ranges are added in the same order, so packed == unpacked == dense
//      bit for bit, for integer and float weights. K is a template
//      parameter: no per-lane array lives in local memory.
// The bf16 form (bf16=True on both entry points, hist_pallas.py:755, 842):
// the unpacked pass's weights are rounded in step 1b's gather into perm
// order, where the TPU kernel rounds its permuted weights (:499), and the
// packed pass rounds each weight as it loads it (hist_common.cuh).
#include <cooperative_groups.h>

#include "hist_common.cuh"
#include "smem_cap.cuh"

namespace cg = cooperative_groups;

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

// Step 1b, for the unpacked pass: each sorted position's node and weights
// in perm order, node_sorted (T, n) and w_sorted (T, K, n), gathered by
// row once here and read coalesced by every feature's block, which would
// otherwise gather a 32-byte sector per lane for each of them. Positions
// past a range's sorted rows are not written. The bf16 form stores each
// weight rounded (operand<kBf16>).
template <bool kBf16>
__global__ void partition_gather(const int32_t* __restrict__ ids, int64_t n, int n_trees,
                                 int n_parts, int max_nodes, int64_t rows_per_block,
                                 const int32_t* __restrict__ perm,
                                 const int32_t* __restrict__ seg, const float* __restrict__ w,
                                 int64_t w_tree_stride, int n_weights,
                                 int32_t* __restrict__ node_sorted, float* __restrict__ w_sorted) {
  const int64_t total = static_cast<int64_t>(n_trees) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t t = e / n;
    const int64_t pos = e - t * n;
    const int64_t part = pos / rows_per_block;
    const int32_t count = seg[(t * n_parts + part) * (max_nodes + 1) + max_nodes];
    if (pos - part * rows_per_block >= count) continue;
    const int64_t row = perm[e];
    node_sorted[e] = ids[t * n + row];
    const float* w_t = w + t * w_tree_stride;
    for (int k = 0; k < n_weights; ++k) {
      w_sorted[(t * n_weights + k) * n + pos] = operand<kBf16>(w_t[k * n + row]);
    }
  }
}

constexpr int kPackSlots = 3;  // codes per word (ops/pack.py PACK_SLOTS)
constexpr int kSlotBits = 7;   // PACK_RADIX = 2^7
constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
// Two 512-thread blocks an SM at least: up to 64 registers a thread, so
// ptxas need not spill to reach four.
constexpr int kAccumulateMinBlocks = 2;
// The unpacked pass: four 512-thread blocks an SM (32 registers a thread)
// where its tiles allow them (K=2 M <= 64, K=5 M <= 32); three from K=7,
// which spills at 32.
constexpr int kUnpackedMinBlocks = 4;
constexpr int kUnpackedMinBlocksWide = 3;
constexpr int kUnpackedWideK = 7;
// The packed pass's warps: 5 runs of nodes, 3 warps each (one per slot).
constexpr int kRuns = kWarps / kPackSlots;
// Most row ranges one cluster of the unpacked pass takes (the portable
// cluster size); more keep the partial slabs and the second pass.
constexpr int kMaxClusterRanges = 8;

// First node m in [lo, hi) whose segment starts at or after position q
// (hi if none): seg is non-decreasing.
__device__ __forceinline__ int first_node_from(const int32_t* __restrict__ seg_tp, int lo, int hi,
                                               int32_t q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_tp[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The unpacked pass's node runs. Warp r walks run r of kWarps runs of
// whole, contiguous nodes: the nodes whose segment midpoints lie in the
// r-th sixteenth of the range's rows, so a run's rows are its share give
// or take half a node at each end (splitting at segment starts instead
// gave some runs a whole extra node: 1.7x the rows at M=16). A node never
// spans two runs, so each cell keeps one writer.
// First node m in [0, max_nodes) with seg[m] + seg[m + 1] >= q2 (max_nodes if
// none): twice the midpoint is non-decreasing in m.
__device__ __forceinline__ int first_node_by_mid(const int32_t* __restrict__ seg_tp,
                                                 int max_nodes, int32_t q2) {
  int lo = 0, hi = max_nodes;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_tp[mid] + seg_tp[mid + 1] < q2) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The unpacked pass, one block per (row range, feature, tree). With
// 2..kMaxClusterRanges ranges (clustered), the range blocks of one
// (feature, tree) form one thread-block cluster: after its tile is full,
// block r sums the r-th share of the cells over the cluster's tiles
// (distributed shared memory) in range order, from range 0's value, and
// writes it to out. Otherwise each block writes its tile to the slab of
// its range (one range: out itself; more: the second pass adds them).
template <int K>
__global__ void __launch_bounds__(kThreads,
                                  K < kUnpackedWideK ? kUnpackedMinBlocks : kUnpackedMinBlocksWide)
    partition_accumulate(
    const int32_t* __restrict__ codes, int64_t n, int p, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ seg, const int32_t* __restrict__ node_sorted,
    const float* __restrict__ w_sorted, int n_trees, int n_parts, int max_nodes, int n_bins,
    int64_t rows_per_block, int clustered, float* __restrict__ out) {
  extern __shared__ float tile[];  // (K, max_nodes, n_bins)
  const int part = blockIdx.x;
  const int f = blockIdx.y;
  const int t = blockIdx.z;
  const int chan = max_nodes * n_bins;
  zero_tile(tile, K * chan);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* seg_tp = seg + (static_cast<int64_t>(t) * n_parts + part) * (max_nodes + 1);
  const int64_t range_first = static_cast<int64_t>(part) * rows_per_block;
  const int32_t* perm_tp = perm + static_cast<int64_t>(t) * n + range_first;
  const int32_t* node_tp = node_sorted + static_cast<int64_t>(t) * n + range_first;
  const float* ws_tp = w_sorted + static_cast<int64_t>(t) * K * n + range_first;
  const int32_t chunk2 = 2 * ((seg_tp[max_nodes] + kWarps - 1) / kWarps);
  const int32_t i0 = seg_tp[first_node_by_mid(seg_tp, max_nodes, warp * chunk2)];
  const int32_t i1 = seg_tp[warp + 1 == kWarps
                                ? max_nodes
                                : first_node_by_mid(seg_tp, max_nodes, (warp + 1) * chunk2)];
  // A step gathers one code per lane; the position's node and weights come
  // in perm order, coalesced.
  for (int32_t i = i0; i < i1; i += 32) {
    int cell = -1;
    const int32_t pos = i + lane;
    if (pos < i1) {
      const int code = codes[static_cast<int64_t>(perm_tp[pos]) * p + f];
      if (code >= 0 && code < n_bins) cell = node_tp[pos] * n_bins + code;
    }
    float wk[K];
    load_weights<K>(wk, ws_tp, n, pos, cell >= 0);
    add_chained<K>(tile, chan, cell, wk);
  }
  if (!clustered) {
    __syncthreads();
    write_tile(tile, n_trees, K, max_nodes, p, n_bins, part, f, t, 0, max_nodes, max_nodes, out);
    return;
  }
  // Every block of the cluster reaches both barriers, rows or none.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every range's tile is full
  // The tile's cells in out's order: (k, m) rows of n_bins contiguous
  // floats. Block `part` takes the part-th contiguous share.
  const int size = K * chan;
  const int share = (size + n_parts - 1) / n_parts;
  const int hi = (part + 1) * share < size ? (part + 1) * share : size;
  float* out_t = out + static_cast<int64_t>(t) * K * max_nodes * p * n_bins
                 + static_cast<int64_t>(f) * n_bins;
  for (int i = part * share + threadIdx.x; i < hi; i += blockDim.x) {
    const int km = i / n_bins;  // k * max_nodes + m
    float v = *cluster.map_shared_rank(tile + i, 0);
    for (int r = 1; r < n_parts; ++r) v += *cluster.map_shared_rank(tile + i, r);
    out_t[static_cast<int64_t>(km) * p * n_bins + (i - km * n_bins)] = v;
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

template <int K, bool kBf16>
__global__ void __launch_bounds__(kThreads, kAccumulateMinBlocks) partition_accumulate_packed(
    const int32_t* __restrict__ words, int64_t n, int p, int slots, int node_groups,
    int group_nodes, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ seg,
    const float* __restrict__ w, int64_t w_tree_stride, int n_trees, int n_parts, int max_nodes,
    int n_bins, int64_t rows_per_block, float* __restrict__ out) {
  extern __shared__ float tile[];  // (slots, K, group_nodes, n_bins)
  const int p3 = (p + kPackSlots - 1) / kPackSlots;
  const int slot_groups = (kPackSlots + slots - 1) / slots;
  const int per_word = slot_groups * node_groups;
  const int word = blockIdx.x / per_word;
  const int sg = (blockIdx.x - word * per_word) / node_groups;
  const int g = blockIdx.x - word * per_word - sg * node_groups;
  const int s0 = sg * slots;              // first slot of this block
  const int f0 = word * kPackSlots + s0;  // its feature
  int nf = slots < kPackSlots - s0 ? slots : kPackSlots - s0;
  if (nf > p - f0) nf = p - f0;
  if (nf <= 0) return;  // the last word's unused slots: block-uniform
  const int t = blockIdx.y;
  const int m_lo = g * group_nodes;
  const int m_hi = m_lo + group_nodes < max_nodes ? m_lo + group_nodes : max_nodes;
  const int chan = group_nodes * n_bins;
  const int tile_size = K * chan;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Warps 3r, 3r + 1 and 3r + 2 walk run r of the group's nodes and add
  // slot 0, 1 and 2 of each row's word: the row's perm entry, id, word
  // and weights are read by three warps, the second and third from L1.
  const int run = warp / kPackSlots;
  const int slot = warp % kPackSlots;
  const int32_t* ids_t = ids + static_cast<int64_t>(t) * n;
  const float* w_t = w + static_cast<int64_t>(t) * w_tree_stride;
  // The row ranges one after another, each from a zeroed tile, added into
  // out in range order: the second pass's sum, without the partial slabs.
  for (int part = 0; part < n_parts; ++part) {
    zero_tile(tile, nf * tile_size);
    __syncthreads();
    const int32_t* seg_tp = seg + (static_cast<int64_t>(t) * n_parts + part) * (max_nodes + 1);
    const int32_t* perm_tp = perm + static_cast<int64_t>(t) * n
                             + static_cast<int64_t>(part) * rows_per_block;
    // Run r holds the nodes whose segments start in the r-th fifth of the
    // group's rows: whole nodes, so its rows are one contiguous run of
    // perm, walked in full 32-lane steps across segment boundaries.
    const int32_t q_lo = seg_tp[m_lo];
    const int32_t chunk = (seg_tp[m_hi] - q_lo + kRuns - 1) / kRuns;
    int32_t i0 = 0, i1 = 0;
    if (run < kRuns && slot < nf) {  // warp-uniform
      const int a = first_node_from(seg_tp, m_lo, m_hi, q_lo + run * chunk);
      const int b = run + 1 == kRuns ? m_hi
                                     : first_node_from(seg_tp, m_lo, m_hi, q_lo + (run + 1) * chunk);
      i0 = seg_tp[a];
      i1 = seg_tp[b];
    }
    for (int32_t i = i0; i < i1; i += 32) {
      const bool live = i + lane < i1;
      int64_t row = 0;
      int local = 0;
      int code = n_bins;
      if (live) {
        row = perm_tp[i + lane];
        local = ids_t[row] - m_lo;  // the row's node, in [0, group_nodes)
        const uint32_t bits = static_cast<uint32_t>(words[row * p3 + word]);
        code = static_cast<int>((bits >> (kSlotBits * (s0 + slot))) & kSlotMask);
      }
      float wk[K];
      load_weights<K, kBf16>(wk, w_t, n, row, live);
      add_ordered<K>(tile + slot * tile_size, chan, code < n_bins ? local * n_bins + code : -1, wk);
    }
    __syncthreads();
    for (int s = 0; s < nf; ++s) {
      write_tile(tile + s * tile_size, n_trees, K, max_nodes, p, n_bins, 0, f0 + s, t, m_lo,
                 m_hi - m_lo, group_nodes, out, part > 0);
    }
    __syncthreads();  // the tile is zeroed for the next range
  }
}

// words[row, j] = c0 + 128 c1 + 128^2 c2 with c_s = codes[row, 3j + s] (0 past
// p): ops/pack.py's integer, in uint32 arithmetic (wraps as int32 does).
__global__ void pack_words(const int32_t* __restrict__ codes, int64_t n, int p,
                           int32_t* __restrict__ words) {
  const int p3 = (p + kPackSlots - 1) / kPackSlots;
  const int64_t total = n * p3;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t row = e / p3;
    const int j = static_cast<int>(e - row * p3);
    uint32_t word = 0;
    for (int s = 0; s < kPackSlots; ++s) {
      const int f = j * kPackSlots + s;
      if (f < p) word += static_cast<uint32_t>(codes[row * p + f]) << (kSlotBits * s);
    }
    words[e] = static_cast<int32_t>(word);
  }
}

// Step 1 for both accumulate passes, and step 1b for the unpacked one
// (node_sorted non-null; bf16: its weights rounded).
cudaError_t launch_partition_rows(const int32_t* ids, int64_t n, int n_trees, int n_parts,
                                  int max_nodes, int32_t* perm, int32_t* seg, const float* w,
                                  int64_t w_tree_stride, int n_weights, int bf16,
                                  int32_t* node_sorted, float* w_sorted, cudaStream_t s) {
  const size_t sort_smem =
      static_cast<size_t>(kWarps * max_nodes + max_nodes + 1) * sizeof(int32_t);
  cudaError_t err = raise_smem_cap(partition_rows, sort_smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = (n + n_parts - 1) / n_parts;
  partition_rows<<<dim3(n_parts, n_trees), kThreads, sort_smem, s>>>(
      ids, n, n_parts, max_nodes, rows_per_block, perm, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess || node_sorted == nullptr) return err;
  const int64_t want = (static_cast<int64_t>(n_trees) * n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (bf16) {
    partition_gather<true><<<blocks, 256, 0, s>>>(ids, n, n_trees, n_parts, max_nodes,
                                                   rows_per_block, perm, seg, w, w_tree_stride,
                                                   n_weights, node_sorted, w_sorted);
  } else {
    partition_gather<false><<<blocks, 256, 0, s>>>(ids, n, n_trees, n_parts, max_nodes,
                                                    rows_per_block, perm, seg, w, w_tree_stride,
                                                    n_weights, node_sorted, w_sorted);
  }
  return cudaGetLastError();
}

struct PartitionLaunch {
  const int32_t* codes;  // codes (n, p), or the packed words (n, ceil(p/3))
  int64_t n;
  int p;
  const int32_t* ids;
  const int32_t* perm;
  const int32_t* seg;
  const float* w;
  int64_t w_tree_stride;
  int n_trees, n_parts, max_nodes, n_bins;
  // The unpacked pass: node_sorted (T, n) and w_sorted (T, K, n) in perm order.
  const int32_t* node_sorted;
  const float* w_sorted;
  int clustered;
  int slots, node_groups;  // the packed pass
  int bf16;                // the packed pass's bf16 form
  float* out;
  cudaStream_t stream;
};

int64_t rows_per_block(const PartitionLaunch& a) { return (a.n + a.n_parts - 1) / a.n_parts; }

// The unpacked pass's launch: grid (ranges, features, trees), one
// cluster of all ranges when clustered; its shared memory allowed.
template <int K>
cudaError_t accumulate_config(const PartitionLaunch& a, cudaLaunchConfig_t* cfg,
                              cudaLaunchAttribute* cluster) {
  *cfg = {};
  cfg->gridDim = dim3(a.n_parts, a.p, a.n_trees);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(K) * a.max_nodes * a.n_bins * sizeof(float);
  cfg->stream = a.stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = a.clustered ? a.n_parts : 1;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg->attrs = cluster;
  cfg->numAttrs = 1;
  return raise_smem_cap(partition_accumulate<K>, cfg->dynamicSmemBytes);
}

template <int K>
cudaError_t launch_accumulate(const PartitionLaunch& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = accumulate_config<K>(a, &cfg, &cluster);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, partition_accumulate<K>, a.codes, a.n, a.p, a.perm, a.seg,
                           a.node_sorted, a.w_sorted, a.n_trees, a.n_parts, a.max_nodes, a.n_bins,
                           rows_per_block(a), a.clustered, a.out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int K>
cudaError_t max_active_clusters(const PartitionLaunch& a, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  const cudaError_t err = accumulate_config<K>(a, &cfg, &cluster);
  return err != cudaSuccess ? err
                            : cudaOccupancyMaxActiveClusters(count, partition_accumulate<K>, &cfg);
}

template <int K, bool kBf16>
cudaError_t launch_accumulate_packed_form(const PartitionLaunch& a) {
  const int group_nodes = (a.max_nodes + a.node_groups - 1) / a.node_groups;
  const size_t smem = static_cast<size_t>(a.slots) * K * group_nodes * a.n_bins * sizeof(float);
  cudaError_t err = raise_smem_cap(partition_accumulate_packed<K, kBf16>, smem);
  if (err != cudaSuccess) return err;
  const int p3 = (a.p + kPackSlots - 1) / kPackSlots;
  const int slot_groups = (kPackSlots + a.slots - 1) / a.slots;
  const dim3 grid(p3 * slot_groups * a.node_groups, a.n_trees);
  partition_accumulate_packed<K, kBf16><<<grid, kThreads, smem, a.stream>>>(
      a.codes, a.n, a.p, a.slots, a.node_groups, group_nodes, a.ids, a.perm, a.seg, a.w,
      a.w_tree_stride, a.n_trees, a.n_parts, a.max_nodes, a.n_bins, rows_per_block(a), a.out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_accumulate_packed(const PartitionLaunch& a) {
  return a.bf16 ? launch_accumulate_packed_form<K, true>(a)
                : launch_accumulate_packed_form<K, false>(a);
}

PartitionLaunch partition_launch(const void* codes, int64_t n, int p, const void* ids,
                                 const void* perm, const void* seg, const void* w,
                                 int64_t w_tree_stride, int n_trees, int max_nodes, int n_bins,
                                 int n_parts, void* out, void* stream) {
  PartitionLaunch a{};
  a.codes = static_cast<const int32_t*>(codes);
  a.n = n;
  a.p = p;
  a.ids = static_cast<const int32_t*>(ids);
  a.perm = static_cast<const int32_t*>(perm);
  a.seg = static_cast<const int32_t*>(seg);
  a.w = static_cast<const float*>(w);
  a.w_tree_stride = w_tree_stride;
  a.n_trees = n_trees;
  a.n_parts = n_parts;
  a.max_nodes = max_nodes;
  a.n_bins = n_bins;
  a.out = static_cast<float*>(out);
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

bool unpacked_args_ok(int n_weights, int clustered, int n_parts) {
  return n_weights >= 1 && n_weights <= kMaxWeights &&
         (!clustered || (n_parts >= 2 && n_parts <= kMaxClusterRanges));
}

}  // namespace

// Step 1: the stable sort of each (tree, row range)'s rows by node into
// perm (T, n) and the segment starts seg (T, n_parts, max_nodes + 1), which
// both accumulate passes read; with node_sorted (T, n) and w_sorted (T,
// n_weights, n), also each position's node and weights w (T, n_weights, n,
// tree stride w_tree_stride) in perm order, for the unpacked pass, rounded to
// bfloat16 under bf16. Null node_sorted writes neither (w and w_sorted are
// then not read).
extern "C" int ate_partition_sort(const void* ids, int64_t n, int n_trees, int max_nodes,
                                  int n_parts, const void* w, int64_t w_tree_stride,
                                  int n_weights, int bf16, void* perm, void* seg,
                                  void* node_sorted, void* w_sorted, void* stream) {
  return static_cast<int>(launch_partition_rows(
      static_cast<const int32_t*>(ids), n, n_trees, n_parts, max_nodes,
      static_cast<int32_t*>(perm), static_cast<int32_t*>(seg), static_cast<const float*>(w),
      w_tree_stride, n_weights, bf16, static_cast<int32_t*>(node_sorted),
      static_cast<float*>(w_sorted), static_cast<cudaStream_t>(stream)));
}

// Step 2, the unpacked pass over perm, seg, node_sorted and w_sorted from
// ate_partition_sort, one feature per block: clustered (2..8 ranges) sums
// the ranges in a cluster, else each range writes its slab of partial
// (more than one range) and the second pass adds them into out.
extern "C" int ate_hist_partition(const void* codes, int64_t n, int p, int n_trees,
                                  int n_weights, int max_nodes, int n_bins, int n_parts,
                                  int clustered, const void* perm, const void* seg,
                                  const void* node_sorted, const void* w_sorted, void* partial,
                                  void* out, void* stream) {
  if (!unpacked_args_ok(n_weights, clustered, n_parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool slabs = n_parts > 1 && !clustered;
  PartitionLaunch a = partition_launch(codes, n, p, nullptr, perm, seg, nullptr, 0, n_trees,
                                       max_nodes, n_bins, n_parts, slabs ? partial : out, stream);
  a.node_sorted = static_cast<const int32_t*>(node_sorted);
  a.w_sorted = static_cast<const float*>(w_sorted);
  a.clustered = clustered;
  cudaError_t err = ATE_WITH_K(n_weights, launch_accumulate, a);
  if (err != cudaSuccess || !slabs) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  return static_cast<int>(launch_reduce(static_cast<const float*>(partial), n_parts, size,
                                        static_cast<float*>(out), a.stream));
}

// How many clusters of the unpacked pass's launch the card holds at once
// (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int ate_hist_partition_clusters(int p, int n_trees, int n_weights, int max_nodes,
                                           int n_bins, int n_parts, int clustered, void* count) {
  if (!unpacked_args_ok(n_weights, clustered, n_parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartitionLaunch a = partition_launch(nullptr, 0, p, nullptr, nullptr, nullptr, nullptr, 0,
                                       n_trees, max_nodes, n_bins, n_parts, nullptr, nullptr);
  a.clustered = clustered;
  return static_cast<int>(ATE_WITH_K(n_weights, max_active_clusters, a, static_cast<int*>(count)));
}

// The packed pass over perm and seg from ate_partition_sort: words (n,
// ceil(p/3)) int32 from ate_pack_codes; slots of a word per block in
// [1, 3]; node_groups blocks split the nodes of a word; bf16: the bf16
// form. Its blocks add their row ranges themselves.
extern "C" int ate_hist_partition_packed(const void* words, int64_t n, int p, const void* ids,
                                         const void* w, int64_t w_tree_stride, int n_trees,
                                         int n_weights, int max_nodes, int n_bins, int n_parts,
                                         int slots, int node_groups, int bf16, const void* perm,
                                         const void* seg, void* out, void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights || slots < 1 || slots > kPackSlots ||
      node_groups < 1 || node_groups > max_nodes || n_bins > (1 << kSlotBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartitionLaunch a = partition_launch(words, n, p, ids, perm, seg, w, w_tree_stride, n_trees,
                                       max_nodes, n_bins, n_parts, out, stream);
  a.slots = slots;
  a.node_groups = node_groups;
  a.bf16 = bf16;
  return static_cast<int>(ATE_WITH_K(n_weights, launch_accumulate_packed, a));
}

extern "C" int ate_pack_codes(const void* codes, int64_t n, int p, void* words, void* stream) {
  const int64_t total = n * ((p + kPackSlots - 1) / kPackSlots);
  const int64_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  pack_words<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<int32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_hist_partition_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
