// Coordinate descent down a warm-started LASSO / elastic-net path, for a
// batch of standardized Gram systems (B fits):
//
//   for each lambda l of fit b, starting from the previous lambda's beta:
//     repeat sweeps until max_j G_jj * dbeta_j^2 < thresh or max_sweeps:
//       for j = 0 .. p-1:
//         gj   = c_j - G_j . beta + G_jj * beta_j
//         bj   = sign(gj) * max(|gj| - lam * alpha * pf_j, 0)
//                / (G_jj + lam * (1 - alpha) * pf_j)
//         beta_j = bj
//     betas[b, l, :] = beta; sweeps[b, l] = the sweeps taken
//
// This is not a port of a TPU kernel: it replaces the XLA program the
// JAX package builds from ate_replication_causalml_tpu/ops/lasso.py:95
// _cd_sweeps (a lax.fori_loop over the coordinates inside a
// lax.while_loop of sweeps) under the lax.scan over the lambda path
// (:175) and the vmap over the CV folds (:375). In eager PyTorch that
// program is about 15 launches per coordinate update and a host read per
// sweep.
//
// What bounds it on an H100: neither bytes nor operations. A sweep is p
// coordinate updates, each depending on the one before (beta_j enters
// the next dot product), so a fit is a chain of sum(sweeps) * p updates,
// each a p-long dot product, a warp reduction and a scalar update. The
// device time is that chain's latency; the byte and flop counts are tiny
// (the Gram matrix is read once per sweep from shared memory or L2).
//
// Design: one block of one warp per fit, so the fits run side by side on
// separate SMs and no block-wide barrier enters the chain. beta, c, pf
// and diag(G) live in shared memory; the Gram matrix too where it fits
// (p <= 224 in float32: the three small rows' p = 21, 22), else its rows
// are read from global memory, where they stay in L2 (Belloni's p = 462:
// 854 KB a fit). For p <= 512 each lane holds its share of the current
// Gram row in registers and loads the next row's during this update, so
// the row read is off the dependent chain; past 512 the row is read
// inside the dot product. Lane l takes the dot product's terms k = l,
// l + 32, ... as a chain of fused multiply-adds, and a butterfly of
// shuffles sums the 32 partials: a fixed order, and every lane holds the same sum, so two
// launches give the same bits. The update is the reference's expression
// in its order, each operation rounded on its own (no contraction), NaN
// propagating as jnp.maximum and jnp.sign do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
// Shared memory a fit may take for a staged Gram matrix (of 227 KB).
constexpr size_t kMaxStagedBytes = 200 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// jnp.maximum: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// A vector of p values rounded up to 4, so each array starts 16-byte aligned.
__host__ __device__ inline size_t padded(int p) {
  return (static_cast<size_t>(p) + 3) & ~static_cast<size_t>(3);
}

// Row j of the Gram matrix as lane `lane` holds it: dst[i] = row[lane + 32 i]
// (0 past p).
template <typename T, int kPer>
__device__ __forceinline__ void load_row(const T* row, int p, int lane, T (&dst)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + i * kWarp;
    dst[i] = k < p ? row[k] : T(0);
  }
}

// kPer > 0: each lane keeps its kPer entries of the current row in
// registers and loads the next row's while it finishes this one (rows do
// not depend on beta), so the Gram read's latency (L2 when unstaged) is
// off the chain; p <= 32 kPer. kPer == 0: the row is read inside the dot
// product (p > 512). The two forms do the same arithmetic in the same order.
template <typename T, bool kStaged, int kPer>
__global__ void __launch_bounds__(kWarp)
    cd_path_kernel(const T* __restrict__ gram, const T* __restrict__ xty,
                   const T* __restrict__ pf, const T* __restrict__ lams,
                   const T* __restrict__ beta0, int p, int n_lam, T alpha, T one_minus_alpha,
                   T thresh, int max_sweeps, T* __restrict__ betas,
                   int32_t* __restrict__ sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* beta = reinterpret_cast<T*>(smem_raw);
  T* cs = beta + padded(p);
  T* pfs = cs + padded(p);
  T* diag = pfs + padded(p);
  T* gs = diag + padded(p);
  const int fit = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t pp = static_cast<size_t>(p) * p;
  const T* g_fit = gram + static_cast<size_t>(fit) * pp;
  for (int k = lane; k < p; k += kWarp) {
    const size_t at = static_cast<size_t>(fit) * p + k;
    beta[k] = beta0 == nullptr ? T(0) : beta0[at];
    cs[k] = xty[at];
    pfs[k] = pf[at];
    diag[k] = g_fit[static_cast<size_t>(k) * p + k];
  }
  if (kStaged) {
    for (size_t k = lane; k < pp; k += kWarp) gs[k] = g_fit[k];
  }
  __syncwarp();
  const T* g = kStaged ? gs : g_fit;
  constexpr int kRegs = kPer > 0 ? kPer : 1;
  T cur[kRegs];
  if constexpr (kPer > 0) load_row(g, p, lane, cur);

  for (int l = 0; l < n_lam; ++l) {
    const size_t out_at = static_cast<size_t>(fit) * n_lam + l;
    const T lam = lams[out_at];
    const T lam_ridge = mul_rn(lam, one_minus_alpha);
    const T lam_l1 = mul_rn(lam, alpha);
    T dlx = static_cast<T>(INFINITY);
    int it = 0;
    while (dlx >= thresh && it < max_sweeps) {
      dlx = T(0);
      for (int j = 0; j < p; ++j) {
        // Lane l sums the terms k = l, l + 32, ... in order; the shuffle
        // butterfly leaves the same total in every lane.
        T s = T(0);
        if constexpr (kPer > 0) {
          T nxt[kRegs];
          load_row(g + static_cast<size_t>(j + 1 < p ? j + 1 : 0) * p, p, lane, nxt);
#pragma unroll
          for (int i = 0; i < kRegs; ++i) {
            const int k = lane + i * kWarp;
            if (k < p) s = fma(cur[i], beta[k], s);
          }
#pragma unroll
          for (int i = 0; i < kRegs; ++i) cur[i] = nxt[i];
        } else {
          const T* row = g + static_cast<size_t>(j) * p;
#pragma unroll 8
          for (int k = lane; k < p; k += kWarp) s = fma(row[k], beta[k], s);
        }
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
        const T gjj = diag[j];
        const T b_old = beta[j];
        const T pfj = pfs[j];
        const T gj = add_rn(sub_rn(cs[j], s), mul_rn(gjj, b_old));
        const T m = nan_max(sub_rn(fabs(gj), mul_rn(lam_l1, pfj)), T(0));
        // jnp.sign(gj) * m: copysign for m >= 0 or NaN, signed zeros included.
        const T bj = div_rn(copysign(m, gj), add_rn(gjj, mul_rn(lam_ridge, pfj)));
        const T d = sub_rn(bj, b_old);
        dlx = nan_max(dlx, mul_rn(gjj, mul_rn(d, d)));
        __syncwarp();
        if (lane == 0) beta[j] = bj;
        __syncwarp();
      }
      ++it;
    }
    for (int k = lane; k < p; k += kWarp) betas[out_at * p + k] = beta[k];
    if (lane == 0) sweeps[out_at] = it;
  }
}

template <typename T, bool kStaged>
using Kernel = decltype(&cd_path_kernel<T, kStaged, 0>);

// The instantiation for p: the smallest kPer with 32 kPer >= p, up to 16
// (p <= 512); past that, the loop form.
template <typename T, bool kStaged>
Kernel<T, kStaged> pick(int p) {
  if (p > 16 * kWarp) return cd_path_kernel<T, kStaged, 0>;
  if (p <= kWarp) return cd_path_kernel<T, kStaged, 1>;
  if (p <= 2 * kWarp) return cd_path_kernel<T, kStaged, 2>;
  if (p <= 4 * kWarp) return cd_path_kernel<T, kStaged, 4>;
  if (p <= 8 * kWarp) return cd_path_kernel<T, kStaged, 8>;
  return cd_path_kernel<T, kStaged, 16>;
}

template <typename T>
int launch(const void* gram, const void* xty, const void* pf, const void* lams,
           const void* beta0, int n_fits, int p, int n_lam, double alpha,
           double one_minus_alpha, double thresh, int max_sweeps, void* betas, void* sweeps,
           cudaStream_t stream) {
  const size_t vec_bytes = 4 * padded(p) * sizeof(T);
  const size_t gram_bytes = static_cast<size_t>(p) * p * sizeof(T);
  const bool staged = vec_bytes + gram_bytes <= kMaxStagedBytes;
  const size_t smem = vec_bytes + (staged ? gram_bytes : 0);
  auto kernel = staged ? pick<T, true>(p) : pick<T, false>(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_fits, kWarp, smem, stream>>>(
      static_cast<const T*>(gram), static_cast<const T*>(xty), static_cast<const T*>(pf),
      static_cast<const T*>(lams), static_cast<const T*>(beta0), p, n_lam,
      static_cast<T>(alpha), static_cast<T>(one_minus_alpha), static_cast<T>(thresh),
      max_sweeps, static_cast<T*>(betas), static_cast<int32_t*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alpha, 1 - alpha (computed by the caller in double, as the reference's
// Python float) and thresh are rounded to the working type here, as the
// reference's weakly typed scalars are.
extern "C" int ate_cd_path(const void* gram, const void* xty, const void* pf, const void* lams,
                           const void* beta0, int n_fits, int p, int n_lam, double alpha,
                           double one_minus_alpha, double thresh, int max_sweeps,
                           int is_double, void* betas, void* sweeps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(gram, xty, pf, lams, beta0, n_fits, p, n_lam, alpha,
                              one_minus_alpha, thresh, max_sweeps, betas, sweeps, s)
             : launch<float>(gram, xty, pf, lams, beta0, n_fits, p, n_lam, alpha,
                             one_minus_alpha, thresh, max_sweeps, betas, sweeps, s);
}

extern "C" const char* ate_lasso_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
