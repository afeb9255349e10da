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
//   2'. partition_accumulate_packed (the packed pass), one block per (row
//      range, slot group of a packed word, tree). The codes come as
//      (n, ceil(p/3)) int32 words of three 7-bit codes (ops/pack.py; built
//      once per fit by pack_words). A row's word is gathered once and split
//      with shifts and masks, its weights loaded once, and each slot adds to
//      its own feature's (K, M, n_bins) tile: up to 3x fewer code gathers and
//      weight loads than one block per feature (the TPU's 3x fewer permute
//      MACs, on this card). Three tiles take 3*K*M*n_bins*4 B, so a block
//      takes as many slots as fit its shared memory (the wrapper passes
//      slots: 3 at K=2 up to M=128, 2 at K=5 M=64, 1 at K=5 M=128) and the
//      grid's second axis is ceil(p/3) * ceil(3/slots). Each tile is walked
//      exactly as step 2 walks its feature (same perm, same segments, same
//      lane order, same ranges and second pass), so packed == unpacked bit
//      for bit, for integer and float weights.
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

constexpr int kPackSlots = 3;  // codes per word (ops/pack.py PACK_SLOTS)
constexpr int kSlotBits = 7;   // PACK_RADIX = 2^7
constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;

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

__global__ void __launch_bounds__(kThreads) partition_accumulate_packed(
    const int32_t* __restrict__ words, int64_t n, int p, int slots,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ seg,
    const float* __restrict__ w, int64_t w_tree_stride, int n_trees, int n_parts,
    int n_weights, int max_nodes, int n_bins, int64_t rows_per_block, float* __restrict__ out) {
  extern __shared__ float tile[];  // (slots, n_weights, max_nodes, n_bins)
  const int p3 = (p + kPackSlots - 1) / kPackSlots;
  const int groups = (kPackSlots + slots - 1) / slots;  // blocks per word
  const int word = blockIdx.y / groups;
  const int s0 = (blockIdx.y % groups) * slots;         // first slot of this block
  const int f0 = word * kPackSlots + s0;                // its feature
  int nf = slots < kPackSlots - s0 ? slots : kPackSlots - s0;
  if (nf > p - f0) nf = p - f0;
  if (nf <= 0) return;  // the last word's unused slots: block-uniform
  const int part = blockIdx.x;
  const int t = blockIdx.z;
  const int chan = max_nodes * n_bins;
  const int tile_size = n_weights * chan;
  zero_tile(tile, nf * tile_size);
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
      uint32_t bits = 0;
      if (i + lane < s1) {
        row = perm_tp[i + lane];
        bits = static_cast<uint32_t>(words[row * p3 + word]) >> (kSlotBits * s0);
        r.cell = 0;  // a live row: load its weights
      }
      load_weights(r, w_t, n, row, n_weights);
      const bool live = r.cell >= 0;
      for (int s = 0; s < nf; ++s) {
        const int code = static_cast<int>((bits >> (kSlotBits * s)) & kSlotMask);
        r.cell = live && code < n_bins ? m * n_bins + code : -1;
        add_in_lane_order(tile + s * tile_size, chan, n_weights, r);
      }
    }
  }
  __syncthreads();
  for (int s = 0; s < nf; ++s) {
    write_tile(tile + s * tile_size, n_trees, n_weights, max_nodes, p, n_bins, part, f0 + s, t,
               out);
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

// Step 1 for both accumulate passes.
cudaError_t launch_partition_rows(const int32_t* ids, int64_t n, int n_trees, int n_parts,
                                  int max_nodes, int64_t rows_per_block, int32_t* perm,
                                  int32_t* seg, cudaStream_t s) {
  const size_t sort_smem =
      static_cast<size_t>(kWarps * max_nodes + max_nodes + 1) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      partition_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sort_smem));
  if (err != cudaSuccess) return err;
  partition_rows<<<dim3(n_parts, n_trees), kThreads, sort_smem, s>>>(
      ids, n, n_parts, max_nodes, rows_per_block, perm, seg);
  return cudaGetLastError();
}

// The second pass over the row ranges (none when there is one range).
cudaError_t finish(cudaError_t err, const void* partial, int n_parts, int n_trees, int n_weights,
                   int max_nodes, int p, int n_bins, void* out, cudaStream_t s) {
  if (err != cudaSuccess || n_parts == 1) return err;
  const int64_t size = static_cast<int64_t>(n_trees) * n_weights * max_nodes * p * n_bins;
  return launch_reduce(static_cast<const float*>(partial), n_parts, size,
                       static_cast<float*>(out), s);
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
  cudaError_t err = launch_partition_rows(static_cast<const int32_t*>(ids), n, n_trees, n_parts,
                                          max_nodes, rows_per_block,
                                          static_cast<int32_t*>(perm), static_cast<int32_t*>(seg), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_weights) * max_nodes * n_bins * sizeof(float);
  err = cudaFuncSetAttribute(partition_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_accumulate<<<dim3(n_parts, p, n_trees), kThreads, smem, s>>>(
      static_cast<const int32_t*>(codes), n, p, static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(seg), static_cast<const float*>(w), w_tree_stride, n_trees,
      n_parts, n_weights, max_nodes, n_bins, rows_per_block,
      static_cast<float*>(n_parts > 1 ? partial : out));
  return static_cast<int>(finish(cudaGetLastError(), partial, n_parts, n_trees, n_weights,
                                 max_nodes, p, n_bins, out, s));
}

// The packed pass: words (n, ceil(p/3)) int32 from ate_pack_codes; slots of a
// word per block in [1, 3].
extern "C" int ate_hist_partition_packed(const void* words, int64_t n, int p, const void* ids,
                                         const void* w, int64_t w_tree_stride, int n_trees,
                                         int n_weights, int max_nodes, int n_bins, int n_parts,
                                         int slots, void* perm, void* seg, void* partial,
                                         void* out, void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights || slots < 1 || slots > kPackSlots ||
      n_bins > (1 << kSlotBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows_per_block = (n + n_parts - 1) / n_parts;
  cudaError_t err = launch_partition_rows(static_cast<const int32_t*>(ids), n, n_trees, n_parts,
                                          max_nodes, rows_per_block,
                                          static_cast<int32_t*>(perm), static_cast<int32_t*>(seg), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(slots) * n_weights * max_nodes * n_bins * sizeof(float);
  err = cudaFuncSetAttribute(partition_accumulate_packed,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int p3 = (p + kPackSlots - 1) / kPackSlots;
  const int groups = (kPackSlots + slots - 1) / slots;
  partition_accumulate_packed<<<dim3(n_parts, p3 * groups, n_trees), kThreads, smem, s>>>(
      static_cast<const int32_t*>(words), n, p, slots, static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(seg), static_cast<const float*>(w), w_tree_stride, n_trees,
      n_parts, n_weights, max_nodes, n_bins, rows_per_block,
      static_cast<float*>(n_parts > 1 ? partial : out));
  return static_cast<int>(finish(cudaGetLastError(), partial, n_parts, n_trees, n_weights,
                                 max_nodes, p, n_bins, out, s));
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
