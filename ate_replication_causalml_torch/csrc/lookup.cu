// Per-tree K-channel leaf lookup.
//
//   out[t, k, row] = table[t, k, ids[t, row]],   0 for an id outside [0, L)
//
// Replaces ate_replication_causalml_tpu/ops/tree_pallas.py::_lookup_kernel
// (entry table_lookup). The forest grower records every training row's
// leaf value with it (K = 1, L = 2^depth = 512 at depth 9). The TPU
// kernel avoided a per-row gather (serialized there) with a one-hot
// contraction on the MXU; on the card a gather is the natural form.
//
// What bounds it on an H100: the bytes, 4 B of id read and 4 * K B of
// values written per (tree, row); the tables (2 KB per tree and channel)
// stay in cache.
//
// Design: one thread per (tree, row), rows of one tree on consecutive
// threads so the id reads and the value writes coalesce. A copy of a
// table entry: exact.
//
// Two fused passes replace the lookup and the per-level route launches
// around it (ate_replication_causalml_tpu/ops/tree_pallas.py::_lookup_kernel
// and ::_route_kernel, which the JAX package calls once per level and
// once per lookup):
//
// traverse — every (tree, row) from the root to its leaf through all
// depth levels in one launch (each level the route contract of
// route.cu: node = 2 * node + (code > thr), a code of 0 for a feature
// outside [0, p)), then either the leaf id (T, n) or the K-channel
// payload out[t, k, row] = table[t, leaf, k] of a (T, L, K) table in its
// stored layout (0 for a leaf outside [0, L)). Bound: the bytes of the
// output, the split tables and the payload (each once) and the codes;
// but every level of every (tree, row) is a dependent table lookup and
// code read, so on the card the lookups' rate decides: read from global
// memory, each lane's code lies in its own 128-byte line (32 L1
// wavefronts a warp a level, 10-40x the bound). Design: block (x, y) =
// (tile of 1,024 rows, group of trees); the tile's codes are staged once
// in shared memory as bytes, with a zero column that features outside
// [0, p) point to (a block whose codes leave [0, 255] reads them from
// global memory instead); for each tree of the group its live split
// entries are staged in heap order (level a's first 2^a entries at
// 2^a - 1), one {feature, threshold} pair a node (4 KB for the 511 nodes
// at depth 9), and its payload (5 KB at K = 5, L = 256); each thread
// walks 4 rows (i, i + 256, ...) through the levels as 4 independent
// chains, two shared-memory reads a level, and writes coalesced. Larger
// tables, payloads or codes are read from global memory. Groups are
// sized so the launch has about 8 blocks an SM of the card
// (ate_traverse): one tree a block for a 32-tree chunk, 21 for 2,000
// trees on an H100's 132 SMs.
// Staging keeps 4 loads in flight a thread (16-byte loads for the codes).
//
// leaf_record — the classifier/regressor grower's chunk end: from the
// leaf sums (T, L, 2) [count, sum], leaf_value[t, l] = count > 0 ?
// base[t] + sum / max(count, 1e-12) : mu[t] (models/forest.py, the same
// float32 operations in the same order; the division IEEE-rounded, as
// nvcc compiles it without --use_fast_math), and every training row's
// value train_vals[t, row] = leaf_value[t, node[t, row]] (0 outside
// [0, L)), in one launch. Bound: the node ids read and the values
// written. Design: one block per (row tile, tree) computes the tree's L
// leaf values into shared memory (the first tile also writes them out),
// then looks its rows up with 16-byte loads and stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_common.cuh"
#include "smem_cap.cuh"

namespace {

__global__ void lookup_kernel(const float* __restrict__ table, int n_chan, int n_slots,
                              const int32_t* __restrict__ ids, int64_t n,
                              float* __restrict__ out) {
  const int t = blockIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int id = ids[static_cast<int64_t>(t) * n + row];
  const bool ok = id >= 0 && id < n_slots;
  for (int k = 0; k < n_chan; ++k) {
    const int64_t tk = static_cast<int64_t>(t) * n_chan + k;
    out[tk * n + row] = ok ? table[tk * n_slots + id] : 0.0f;
  }
}


constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
// traverse: a block's row tile, and its shared-memory budgets: the live
// split entries as {feature, threshold} pairs up to 40 KB (depth <= 12),
// the payload up to 16 KB, the tile's codes as bytes up to 40 columns;
// anything larger is read from global memory.
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kMaxTableBytes = 40 * 1024;
constexpr int kMaxPayloadBytes = 16 * 1024;
constexpr int kMaxCodeColumns = 40;
// Global loads a thread keeps in flight while staging.
constexpr int kStageLoads = 4;
// Blocks a traverse launch aims at for each SM of the card. Past 8 an SM
// a block walks several trees over its tile, staging the tile's codes once.
constexpr int kTraverseBlocksPerSM = 8;
// leaf_record stages its leaf values up to this many leaves (48 KB).
constexpr int kMaxRecordLeaves = 12 * 1024;

// A node's {feature, threshold}, the feature mapped to p (the codes
// tile's zero column) when it lies outside [0, p): a code of 0.
__device__ __forceinline__ int2 split_entry(const int32_t* __restrict__ feat,
                                            const int32_t* __restrict__ thr, int64_t i, int p) {
  const int f = __ldg(feat + i);
  return make_int2(f >= 0 && f < p ? f : p, __ldg(thr + i));
}

// kPayload: write table[t, leaf, k] (float, (T, K, n)); else the leaf id
// (int32, (T, n)). Block (x, y) = (row tile, group of trees_per_block
// trees); thread i takes the tile's rows i, i + 256, i + 512, i + 768.
template <bool kPayload>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const int32_t* __restrict__ codes, int64_t n, int p,
                const int32_t* __restrict__ feat, const int32_t* __restrict__ thr, int n_trees,
                int depth, int width, const float* __restrict__ table, int n_slots, int n_chan,
                int trees_per_block, int stage_tables, int stage_payload, int stage_codes,
                void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t tab = static_cast<int64_t>(depth) * width;
  const int live = (1 << depth) - 1;  // the nodes the levels read, in heap order
  const int64_t pay = static_cast<int64_t>(n_slots) * n_chan;
  int2* s_tab = reinterpret_cast<int2*>(smem);
  float* s_pay = reinterpret_cast<float*>(smem + (stage_tables ? 8 * live : 0));
  uint8_t* s_codes = smem + (stage_tables ? 8 * live : 0) + (kPayload && stage_payload ? 4 * pay : 0);
  const int cols = p + 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int rows = static_cast<int>(n - row0 < kTileRows ? n - row0 : kTileRows);
  // The tile's codes as bytes, row-major with a zero column p, and zeros
  // past the last row (the lanes there walk them and write nothing),
  // unless a code lies outside [0, 255] (then the whole block reads
  // global codes).
  bool tile_codes = false;
  if (stage_codes) {
    bool wide = false;
    const int32_t* src = codes + row0 * p;
    const int total = rows * p;
    int done = 0;  // elements staged 16 bytes at a time
    if (aligned(src, 16)) {
      // Element 4q = r * p + c walked in steps of 4 x blockDim.x without a
      // division per element; kStageLoads loads in flight a thread.
      const int4* src4 = reinterpret_cast<const int4*>(src);
      const int total4 = total / 4;
      const int stride = 4 * blockDim.x;
      const int step_r = stride / p, step_c = stride % p;
      int r = 4 * threadIdx.x / p, c = 4 * threadIdx.x % p;
      for (int q0 = 0; q0 < total4; q0 += kStageLoads * blockDim.x) {
        int4 v[kStageLoads];
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          const int q = q0 + u * blockDim.x + threadIdx.x;
          v[u] = q < total4 ? src4[q] : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          if (q0 + u * blockDim.x + threadIdx.x < total4) {
            const int e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
            int rr = r, cc = c;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              wide |= e[m] < 0 || e[m] > 255;
              s_codes[rr * cols + cc] = static_cast<uint8_t>(e[m]);
              if (++cc == p) {
                cc = 0;
                ++rr;
              }
            }
          }
          r += step_r;
          c += step_c;
          if (c >= p) {
            c -= p;
            ++r;
          }
        }
      }
      done = 4 * total4;
    }
    for (int i = done + threadIdx.x; i < total; i += blockDim.x) {
      const int v = src[i];
      wide |= v < 0 || v > 255;
      s_codes[(i / p) * cols + i % p] = static_cast<uint8_t>(v);
    }
    for (int q = threadIdx.x; q < rows; q += blockDim.x) s_codes[q * cols + p] = 0;
    for (int i = rows * cols + threadIdx.x; i < kTileRows * cols; i += blockDim.x) s_codes[i] = 0;
    tile_codes = !__syncthreads_or(wide);
  }
  const int t_begin = blockIdx.y * trees_per_block;
  const int t_end = t_begin + trees_per_block < n_trees ? t_begin + trees_per_block : n_trees;
  for (int t = t_begin; t < t_end; ++t) {
    const int32_t* f_g = feat + t * tab;
    const int32_t* b_g = thr + t * tab;
    const float* payload = kPayload ? table + t * pay : nullptr;
    if (stage_tables || (kPayload && stage_payload)) {
      __syncthreads();  // the previous tree's tables are no longer read
      if (stage_tables) {
        // Heap entry i is level a = floor(log2(i + 1)), node i + 1 - 2^a;
        // kStageLoads entries in flight a thread.
        for (int i0 = 0; i0 < live; i0 += kStageLoads * blockDim.x) {
          int2 e[kStageLoads];
#pragma unroll
          for (int u = 0; u < kStageLoads; ++u) {
            const int i = i0 + u * blockDim.x + threadIdx.x;
            const int a = 31 - __clz(i + 1);
            e[u] = i < live ? split_entry(f_g, b_g, a * width + (i + 1 - (1 << a)), p)
                            : make_int2(0, 0);
          }
#pragma unroll
          for (int u = 0; u < kStageLoads; ++u) {
            const int i = i0 + u * blockDim.x + threadIdx.x;
            if (i < live) s_tab[i] = e[u];
          }
        }
      }
      if (kPayload && stage_payload) {
        for (int i = threadIdx.x; i < pay; i += blockDim.x) s_pay[i] = __ldg(payload + i);
        payload = s_pay;
      }
      __syncthreads();
    }
    int node[kRowsPerThread] = {0, 0, 0, 0};
    for (int a = 0; a < depth; ++a) {
      const int64_t level = static_cast<int64_t>(a) * width;
      const int heap = (1 << a) - 1;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = threadIdx.x + j * kThreads;
        const int2 e = stage_tables ? s_tab[heap + node[j]] : split_entry(f_g, b_g, level + node[j], p);
        int code;
        if (tile_codes) {
          code = s_codes[r * cols + e.x];
        } else {
          code = e.x < p && r < rows ? __ldg(codes + (row0 + r) * p + e.x) : 0;
        }
        node[j] = 2 * node[j] + (code > e.y ? 1 : 0);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = threadIdx.x + j * kThreads;
      if (r >= rows) continue;
      const int64_t row = row0 + r;
      if (!kPayload) {
        static_cast<int32_t*>(out)[static_cast<int64_t>(t) * n + row] = node[j];
      } else {
        float* o = static_cast<float*>(out) + static_cast<int64_t>(t) * n_chan * n + row;
        const float* leaf = payload + node[j] * n_chan;
        const bool in_range = node[j] < n_slots;
        for (int k = 0; k < n_chan; ++k) o[k * n] = in_range ? leaf[k] : 0.0f;
      }
    }
  }
}

// A leaf's value from its [count, sum] at s (channel stride s_chan):
// torch.where(count > 0, base + sum / torch.clamp(count, min=1e-12), mu)
// in float32, the division IEEE-rounded; a NaN count stays NaN in the
// clamp and takes mu.
__device__ __forceinline__ float leaf_value_of(const float* s, int64_t s_chan, float base,
                                               float mu) {
  const float c = s[0];
  const float cc = c < 1e-12f ? 1e-12f : c;
  return c > 0.0f ? base + s[s_chan] / cc : mu;
}

__global__ void __launch_bounds__(kThreads)
leaf_record_kernel(const float* __restrict__ sums, int64_t s_tree, int64_t s_leaf,
                   int64_t s_chan, const float* __restrict__ base,
                   const float* __restrict__ mu, int n_leaves,
                   const int32_t* __restrict__ node, int64_t n, int staged, int vec,
                   float* __restrict__ leaf_value, float* __restrict__ train_vals) {
  extern __shared__ float s_val[];
  const int t = blockIdx.y;
  const float b = base[t], m = mu[t];
  const bool first = blockIdx.x == 0;
  float* lv = leaf_value + static_cast<int64_t>(t) * n_leaves;
  if (staged || first) {  // uniform over the block
    for (int l = threadIdx.x; l < n_leaves; l += blockDim.x) {
      const float v = leaf_value_of(sums + t * s_tree + l * s_leaf, s_chan, b, m);
      if (staged) s_val[l] = v;
      if (first) lv[l] = v;
    }
  }
  __syncthreads();
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kRowsPerThread;
  if (row0 >= n) return;
  const int64_t at = static_cast<int64_t>(t) * n + row0;
  const int rows = static_cast<int>(n - row0 < kRowsPerThread ? n - row0 : kRowsPerThread);
  int id[kRowsPerThread];
  if (vec) {
    const int4 a = *reinterpret_cast<const int4*>(node + at);
    id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) id[j] = j < rows ? node[at + j] : -1;
  }
  float v[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (id[j] < 0 || id[j] >= n_leaves) {
      v[j] = 0.0f;
    } else if (staged) {
      v[j] = s_val[id[j]];
    } else {
      v[j] = leaf_value_of(sums + t * s_tree + id[j] * s_leaf, s_chan, b, m);
    }
  }
  if (vec) {
    *reinterpret_cast<float4*>(train_vals + at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      if (j < rows) train_vals[at + j] = v[j];
  }
}

}  // namespace

extern "C" int ate_lookup(const void* table, int n_trees, int n_chan, int n_slots,
                          const void* ids, int64_t n, void* out, void* stream) {
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads), n_trees);
  lookup_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n_chan, n_slots, static_cast<const int32_t*>(ids),
      n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kPayload>
int launch_traverse(dim3 grid, size_t smem, cudaStream_t s, const int32_t* codes, int64_t n, int p,
                    const int32_t* feat, const int32_t* thr, int n_trees, int depth, int width,
                    const float* table, int n_slots, int n_chan, int trees_per_block,
                    int stage_tables, int stage_payload, int stage_codes, void* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = raise_smem_cap(traverse_kernel<kPayload>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traverse_kernel<kPayload><<<grid, kThreads, smem, s>>>(
      codes, n, p, feat, thr, n_trees, depth, width, table, n_slots, n_chan, trees_per_block,
      stage_tables, stage_payload, stage_codes, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ate_traverse(const void* codes, int64_t n, int p, const void* feat,
                            const void* thr, int n_trees, int depth, int width,
                            const void* table, int n_slots, int n_chan, void* out,
                            void* stream) {
  // Trees a block walks over its tile: one while the tiles and trees give
  // at most kTraverseBlocksPerSM blocks an SM, more past it, and enough to
  // keep the tree groups within the grid's 65,535.
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>(kTraverseBlocksPerSM) * sms;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  int64_t per_block = (static_cast<int64_t>(n_trees) * tiles + blocks - 1) / blocks;
  per_block = per_block > (n_trees + 65534) / 65535 ? per_block : (n_trees + 65534) / 65535;
  const int trees_per_block = static_cast<int>(per_block > 1 ? per_block : 1);
  const int64_t tab_bytes = 8 * ((int64_t{1} << depth) - 1);
  const int64_t pay_bytes = 4 * static_cast<int64_t>(n_slots) * n_chan;
  const int stage_tables = tab_bytes <= kMaxTableBytes;
  const int stage_payload = table != nullptr && pay_bytes <= kMaxPayloadBytes;
  const int stage_codes = p >= 1 && p + 1 <= kMaxCodeColumns;
  const size_t smem = (stage_tables ? tab_bytes : 0) + (stage_payload ? pay_bytes : 0) +
                      (stage_codes ? static_cast<int64_t>(kTileRows) * (p + 1) : 0);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((n_trees + trees_per_block - 1) / trees_per_block));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(codes);
  const int32_t* f = static_cast<const int32_t*>(feat);
  const int32_t* b = static_cast<const int32_t*>(thr);
  if (table != nullptr) {
    return launch_traverse<true>(grid, smem, s, c, n, p, f, b, n_trees, depth, width,
                                 static_cast<const float*>(table), n_slots, n_chan,
                                 trees_per_block, stage_tables, stage_payload, stage_codes, out);
  }
  return launch_traverse<false>(grid, smem, s, c, n, p, f, b, n_trees, depth, width, nullptr, 0,
                                0, trees_per_block, stage_tables, 0, stage_codes, out);
}

extern "C" int ate_leaf_record(const void* sums, int64_t s_tree, int64_t s_leaf, int64_t s_chan,
                               const void* base, const void* mu, int n_trees, int n_leaves,
                               const void* node, int64_t n, void* leaf_value, void* train_vals,
                               void* stream) {
  const int rows_per_block = kThreads * kRowsPerThread;
  const unsigned tiles = static_cast<unsigned>(n > 0 ? (n + rows_per_block - 1) / rows_per_block : 1);
  const dim3 grid(tiles, n_trees);
  const int staged = n_leaves <= kMaxRecordLeaves;
  const size_t smem = staged ? sizeof(float) * n_leaves : 0;
  const int vec = n % kRowsPerThread == 0 && aligned(node, 16) && aligned(train_vals, 16);
  leaf_record_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), s_tree, s_leaf, s_chan, static_cast<const float*>(base),
      static_cast<const float*>(mu), n_leaves, static_cast<const int32_t*>(node), n, staged, vec,
      static_cast<float*>(leaf_value), static_cast<float*>(train_vals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
