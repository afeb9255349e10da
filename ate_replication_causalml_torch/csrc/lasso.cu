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
// What bounds it on an H100: neither bytes nor operations. Each update
// depends on the one before, so a fit is a chain of sum(sweeps) * p
// updates, and the device time is that chain's latency. The recurrence
// itself needs, per update, only the newest coordinate's term, the
// update's subtract and add, the soft threshold's subtract and max, the
// copysign and the division: about 11 dependent steps at any p.
//
// Design: one block of one warp per fit (the fits run side by side on
// separate SMs; no block barrier), and delayed-term summation. Updates
// are numbered t = 0, 1, ... along the one Gauss-Seidel sequence that
// runs on across sweeps and lambdas (coordinate j_t = t mod p). The sum
// G_j . beta of update t is taken as
//
//   s_t = R_t + G_{j, j_{t-d}} beta_{j_{t-d}} + ... + G_{j, j_{t-1}} beta_{j_{t-1}}
//
// (the tail added by fused multiply-adds in that order, oldest first),
// where R_t sums every other term k (j itself included, at its old
// value): lane l takes k = l, l + 32, ... as a chain of fused
// multiply-adds and a butterfly of shuffles sums the 32 partials, so
// every lane holds the same bits. R_t reads only coefficients that are
// final once update t-d-1 is done, so it is computed d updates ahead as
// software-pipelined work of the same warp: at update u the warp loads
// R_{u+d}'s Gram terms, sums R_{u+d-1}'s, takes one butterfly step of
// each of five others, and adds the tails that have become known; only
// the last term of s_u waits on beta_{u-1}. R does not depend on lambda
// and beta does not change between a lambda's last update and the next
// one's first, so the values computed ahead stay valid across sweeps and
// lambdas. For p <= d the window would hold j itself: those fits take a
// window of the other p - 1 coordinates, one update after another
// (cd_path_small_kernel).
//
// Every lane computes b_j itself from registers: the last d coefficients
// in a window of registers, and update j's inputs (c_j, lam alpha pf_j,
// beta_j's old value shuffled from its owner lane, G_jj beta_j, the
// divisor's reciprocal taken once per lambda) prepared one update ahead.
// beta_k lives with the lane that sums its term (k % 32): in a register
// for R, and in shared memory for the old values read ahead, so no warp
// barrier sits between updates. The float division is the reciprocal in
// double times the numerator, rounded to float: div_rn bit for bit (see
// Div), without div_rn's slow-path branch on the chain. The Gram matrix
// lives in shared memory where it fits (p <= 224 in float32: the three
// small rows' p = 21, 22); else its rows stream through a ring in shared
// memory, each copied by cp.async kAhead updates before R reads it
// (Belloni's p = 462: 854 KB a fit, in L2). Lane l copies and reads only
// its own elements of a row, so the copy's wait_group is the only
// synchronisation. The d coefficients of row j that the tail takes
// (G_{j, j-1} ... G_{j, j-d}) sit in a band in shared memory, read by
// every lane. The update is the reference's expression in its order,
// each operation rounded on its own (no contraction), NaN propagating as
// jnp.maximum and jnp.sign do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "smem_cap.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// d, the updates by which R runs ahead. R_t's loads take one update (age
// 0, update t - d), its fused multiply-adds the next (age 1), its
// butterfly one step an update for five more (ages kShfl .. kShfl + 4);
// then its tail catches up on the kCatch terms known by then, and one
// term joins each update until the last, on the chain (age d).
constexpr int kDelay = 8;
constexpr int kShfl = 2;
constexpr int kCatch = kShfl + 4;
static_assert(kDelay >= kCatch + 1, "the tail must catch up before R_t's update");
// Unstaged Gram rows: cp.async groups in flight, and the ring's slots
// (a slot is refilled two updates after its row was read).
constexpr int kAhead = 8;
constexpr int kRing = kAhead + 2;
// Shared memory a fit may take for a staged Gram matrix with its vectors,
// and the most a block can have (of the SM's 228 KB).
constexpr size_t kMaxStagedBytes = 200 * 1024;
constexpr size_t kMaxSmemBytes = 227 * 1024;
// The widest R a lane sums (kPer terms of 32): p <= 2048.
constexpr int kMaxPer = 64;

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

// A vector of n values rounded up to 4, so each array starts 16-byte aligned.
__host__ __device__ inline size_t padded(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

// What update j reads besides the sums, one 16-byte-aligned record.
template <typename T>
struct alignas(16) Coord {
  T c, pf, gjj, g1;  // c_j, pf_j, G_jj, G_{j, j-1 mod p}
};

// Four values read as one 16-byte-aligned piece (two for double).
template <typename T>
struct alignas(16) Quad {
  T v[4];
};
static_assert(kDelay % 4 == 0, "a band row is read in pieces of four");

// The coordinate-update expression, the reference's operations in order:
// gj = c_j - s + G_jj beta_j (the product given), soft threshold, divide.
template <typename T>
__device__ __forceinline__ T coord_update(const Coord<T>& q, T s, T gbo, T lam_l1, T lam_ridge) {
  const T gj = add_rn(sub_rn(q.c, s), gbo);
  const T m = nan_max(sub_rn(fabs(gj), mul_rn(lam_l1, q.pf)), T(0));
  // jnp.sign(gj) * m: copysign for m >= 0 or NaN, signed zeros included.
  return div_rn(copysign(m, gj), add_rn(q.gjj, mul_rn(lam_ridge, q.pf)));
}

// num / den rounded to nearest even, as div_rn, with den's part taken
// once per lambda (prep). float: num times den's reciprocal rounded to
// nearest in double, then rounded to float. That is div_rn bit for bit:
// the reciprocal and the product err by less than 2^-51 relative, while
// a quotient of two floats lies more than 2^-49 relative from every
// float rounding boundary (a midpoint between two floats, 25 significant
// bits: were x = a/b within it, a - mu b, a nonzero multiple of
// 2^min(ea, eb + e - 24), would be smaller than its least value), so both
// round the same way; zeros, infinities and NaN come out as div_rn's.
// It takes no branch, where div_rn's expansion ends in a slow-path check
// on the chain. double: div_rn itself.
template <typename T>
struct Div;
template <>
struct Div<float> {
  using Prep = double;
  static __device__ __forceinline__ double prep(float den) {
    return __drcp_rn(static_cast<double>(den));
  }
  static __device__ __forceinline__ float apply(float num, double rcp) {
    return __double2float_rn(__dmul_rn(static_cast<double>(num), rcp));
  }
};
template <>
struct Div<double> {
  using Prep = double;
  static __device__ __forceinline__ double prep(double den) { return den; }
  static __device__ __forceinline__ double apply(double num, double den) {
    return __ddiv_rn(num, den);
  }
};

// Keep x computed before this point: the compiler may not move its
// computation past here.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void pin(double& x) { asm volatile("" : "+d"(x)); }

// Copy one T from src + kOff to dst + kOff (element offsets) if `on`.
template <int kOff, typename T>
__device__ __forceinline__ void cp_async(unsigned dst, const T* src, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0+%3], [%1+%3], %4;\n}\n" ::"r"(dst),
      "l"(src), "r"(static_cast<int>(on)), "n"(kOff * sizeof(T)), "n"(sizeof(T))
      : "memory");
}

// f(std::integral_constant<int, I>) for I = kFrom .. kTo - 1.
template <int kFrom, int kTo, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (kFrom < kTo) {
    f(std::integral_constant<int, kFrom>{});
    static_for<kFrom + 1, kTo>(f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One fit's state: the shared arrays and the registers carried from
// update to update. Every member function is inlined into the kernel, so
// the arrays below live in registers (static indices only).
template <typename T, bool kStaged, int kPer>
struct Fit {
  using Mask = std::conditional_t<(kPer > 32), uint64_t, uint32_t>;

  const Coord<T>* coord;  // (p,)
  typename Div<T>::Prep* dv;  // (p,) Div<T>::prep(G_jj + lam (1 - alpha) pf_j), per lambda
  T* beta;                // (32 kPer) beta[k], written and read by lane k % 32 only
  const T* band;          // (p, kDelay): band[j kDelay + i - 1] = G_{j, j-i mod p}
  T* gram;                // staged: (p, p); else the ring, kRing rows of pv
  const T* g_fit;         // the fit's Gram matrix in global memory
  int p, pv, lane;
  Mask valid;             // bit i: lane + 32 i < p
  int rs, fs, jf;         // ring: slot read, slot filled, coordinate fetched
  T acc[kDelay - 1];      // acc[s]: the sum of update u + s, as far as it goes
  T bw[kCatch + 1];       // bw[i] = beta_{u-i} (i >= 1)
  T own[kPer];            // beta_k of this lane's terms k = lane + 32 i, as now
  T gl[kPer];             // R_{u+d-1}'s Gram terms, loaded at update u - 1 ...
  Mask kl;                // ... and the ones it keeps
  // Update u's inputs, prepared at update u - 1: its record, beta_j's old
  // value, G_jj beta_j, lam alpha pf_j and its divisor's Div<T>::prep.
  Coord<T> cur;
  T bo, gbo, thr;
  typename Div<T>::Prep dvc;
  T lam_l1, lam_ridge, dlx;

  __device__ __forceinline__ int wrap(int k) const { return k >= p ? k - p : k; }

  // Bits i of the lane's terms k = lane + 32 i that lie in R_t's window
  // [jr - kDelay, jr - 1] (mod p): at most one in each of its two pieces,
  // [max(jr - kDelay, 0), jr - 1] and, when it wraps, [jr - kDelay + p, p - 1].
  // Selects, not branches: the update stays one basic block.
  __device__ __forceinline__ Mask window_bits(int jr) const {
    constexpr int kBits = static_cast<int>(8 * sizeof(Mask));
    const int lo = jr - kDelay;
    const int a1 = lo > 0 ? lo : 0;
    const int k1 = a1 + ((lane - a1) & (kWarp - 1));
    const int a2 = lo + p;
    const int k2 = a2 + ((lane - a2) & (kWarp - 1));
    const Mask b1 = k1 <= jr - 1 ? Mask(1) << ((k1 >> 5) & (kBits - 1)) : Mask(0);
    const Mask b2 = lo < 0 && k2 < p ? Mask(1) << ((k2 >> 5) & (kBits - 1)) : Mask(0);
    return b1 | b2;
  }

  // Update j's record, beta_j's old value (from its owner lane, which
  // alone reads it in shared memory) and G_jj times it.
  __device__ __forceinline__ void load_next(int j, Coord<T>& q, T& b_old, T& g_b_old) const {
    q = coord[j];
    const T own = beta[(j & ~(kWarp - 1)) + lane];  // beta is padded to 32 kPer
    b_old = __shfl_sync(kFull, own, j & (kWarp - 1));
    g_b_old = mul_rn(q.gjj, b_old);
  }

  // A new lambda: every coordinate's divisor, once, and update u's
  // lambda-dependent inputs (coordinate j) again.
  __device__ __forceinline__ void set_lambda(T lam, T alpha, T one_minus_alpha, int j) {
    lam_ridge = mul_rn(lam, one_minus_alpha);
    lam_l1 = mul_rn(lam, alpha);
    __syncwarp();
    for (int k = lane; k < p; k += kWarp) {
      dv[k] = Div<T>::prep(add_rn(coord[k].gjj, mul_rn(lam_ridge, coord[k].pf)));
    }
    __syncwarp();
    thr = mul_rn(lam_l1, cur.pf);
    dvc = dv[j];
  }

  // Copy row jf of the Gram matrix into ring slot fs (unstaged only).
  __device__ __forceinline__ void fetch() {
    if constexpr (!kStaged) {
      const T* src = g_fit + static_cast<size_t>(jf) * p + lane;
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(gram + static_cast<size_t>(fs) * pv + lane));
      static_for<0, kPer>([&](auto i) {
        cp_async<decltype(i)::value * kWarp>(dst, src, valid & (Mask(1) << decltype(i)::value));
      });
      cp_async_commit();
      fs = fs + 1 == kRing ? 0 : fs + 1;
      jf = wrap(jf + 1);
    }
  }

  // Update u (coordinate j). kDry: the d updates before the first, which
  // set nothing (beta_j keeps its value) and only fill the pipeline. The
  // work off the chain sits between the chain's start and its division,
  // so that the compiler schedules it in the division's basic block.
  template <bool kDry>
  __device__ __forceinline__ void step(int j) {
    // The chain up to the division: the newest term, then the update. Its
    // inputs were all ready when the last update ended.
    T num = T(0);
    if constexpr (!kDry) {
      const T gj = add_rn(sub_rn(cur.c, fma(cur.g1, bw[1], acc[0])), gbo);
      // jnp.sign(gj) * m: copysign for m >= 0 or NaN, signed zeros included.
      num = copysign(nan_max(sub_rn(fabs(gj), thr), T(0)), gj);
    }
    // Update u + 1's inputs. Pinned here: left to be computed where they
    // are used, after this update's division, they would join the chain.
    Coord<T> nxt;
    T bo_n, gbo_n;
    load_next(wrap(j + 1), nxt, bo_n, gbo_n);
    T thr_n = mul_rn(lam_l1, nxt.pf);
    typename Div<T>::Prep dv_n = dv[wrap(j + 1)];
    pin(bo_n);
    pin(gbo_n);
    pin(thr_n);
    pin(dv_n);
    // One butterfly step of each of the five R values kShfl .. kShfl + 4
    // updates old (slot s = kDelay - age).
#pragma unroll
    for (int st = 0; st < 5; ++st) {
      const int s = kDelay - kShfl - st;
      acc[s] = acc[s] + __shfl_xor_sync(kFull, acc[s], (kWarp / 2) >> st);
    }
    // R_{u+d-1}: this lane's kept terms, in order: the Gram terms loaded at
    // the last update, and beta as now (the last update's coordinate is in
    // R_{u+d-1}'s window, so every term it keeps has its value of then).
    T part = T(0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (kl & (Mask(1) << i)) part = fma(gl[i], own[i], part);
    }
    // R_{u+d}'s loads: no guard needed (the rows are padded to 32 kPer).
    const int jr = wrap(j + kDelay);
    const T* row;
    if constexpr (kStaged) {
      row = gram + static_cast<size_t>(jr) * p;
    } else {
      fetch();
      cp_async_wait<kAhead>();
      row = gram + static_cast<size_t>(rs) * pv;
      rs = rs + 1 == kRing ? 0 : rs + 1;
    }
    const Mask keep = valid & ~window_bits(jr);
#pragma unroll
    for (int i = 0; i < kPer; ++i) gl[i] = row[lane + i * kWarp];
    // The R just summed catches up on its tail: beta_{t-d} .. beta_{u-1}
    // (its band row read in 16-byte pieces).
    {
      constexpr int s = kDelay - kCatch;
      Quad<T> b[kDelay / 4];
#pragma unroll
      for (int q = 0; q < kDelay / 4; ++q) {
        b[q] = reinterpret_cast<const Quad<T>*>(band + static_cast<size_t>(wrap(j + s)) * kDelay)[q];
      }
#pragma unroll
      for (int i = kDelay; i > s; --i) acc[s] = fma(b[(i - 1) / 4].v[(i - 1) % 4], bw[i - s], acc[s]);
    }
    // The others between take beta_{u-1}.
#pragma unroll
    for (int s = 1; s < kDelay - kCatch; ++s) {
      acc[s] = fma(band[static_cast<size_t>(wrap(j + s)) * kDelay + s], bw[1], acc[s]);
    }
    // The division (in float32 without a branch; in float64 div_rn, whose
    // slow-path check ends the update's basic block).
    T bj = bo;
    if constexpr (!kDry) {
      bj = Div<T>::apply(num, dvc);
      const T d = sub_rn(bj, bo);
      dlx = nan_max(dlx, mul_rn(cur.gjj, mul_rn(d, d)));
      // beta_j to its owner lane: in shared memory for the old values
      // read ahead, and in the register of its term.
      const bool mine = lane == (j & (kWarp - 1));
      if (mine) beta[j] = bj;
      const Mask hot = mine ? Mask(1) << (j >> 5) : Mask(0);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (hot & (Mask(1) << i)) own[i] = bj;
      }
    }
#pragma unroll
    for (int s = 0; s + 2 < kDelay; ++s) acc[s] = acc[s + 1];
    acc[kDelay - 2] = part;
    kl = keep;
#pragma unroll
    for (int i = kCatch; i > 1; --i) bw[i] = bw[i - 1];
    bw[1] = bj;
    cur = nxt;
    bo = bo_n;
    gbo = gbo_n;
    thr = thr_n;
    dvc = dv_n;
  }
};

// p > kDelay. kPer: the terms of R a lane sums (32 kPer >= p).
template <typename T, bool kStaged, int kPer>
__global__ void __launch_bounds__(kWarp)
    cd_path_kernel(const T* __restrict__ gram, const T* __restrict__ xty,
                   const T* __restrict__ pf, const T* __restrict__ lams,
                   const T* __restrict__ beta0, int p, int n_lam, T alpha, T one_minus_alpha,
                   T thresh, int max_sweeps, T* __restrict__ betas,
                   int32_t* __restrict__ sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Layout (smem_bytes): coord (p), dv (p), beta (32 kPer), band (p kDelay), then
  // the staged Gram matrix or the ring, and 32 kPer values of slack that
  // a lane's unguarded loads past the last row may read.
  constexpr int kWidth = kPer * kWarp;
  const int pv = static_cast<int>(padded(p));
  Coord<T>* coord = reinterpret_cast<Coord<T>*>(smem_raw);
  auto* dv = reinterpret_cast<typename Div<T>::Prep*>(coord + p);
  T* beta = reinterpret_cast<T*>(dv + padded(p));
  T* band = beta + kWidth;
  T* gs = band + padded(static_cast<size_t>(p) * kDelay);
  const int fit = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t pp = static_cast<size_t>(p) * p;
  const T* g_fit = gram + static_cast<size_t>(fit) * pp;
  for (int k = lane; k < kWidth; k += kWarp) {
    const size_t at = static_cast<size_t>(fit) * p + k;
    beta[k] = k >= p || beta0 == nullptr ? T(0) : beta0[at];
    if (k >= p) continue;
    const size_t row = static_cast<size_t>(k) * p;
    coord[k] = Coord<T>{xty[at], pf[at], g_fit[row + k], g_fit[row + (k == 0 ? p - 1 : k - 1)]};
  }
  T* slack = gs + (kStaged ? pp : static_cast<size_t>(kRing) * pv);
  for (int k = lane; k < kWidth; k += kWarp) slack[k] = T(0);
  for (int e = lane; e < p * kDelay; e += kWarp) {
    const int j = e / kDelay;
    const int k = j - (e - j * kDelay) - 1;
    band[e] = g_fit[static_cast<size_t>(j) * p + (k < 0 ? k + p : k)];
  }
  if constexpr (kStaged) {
    for (size_t k = lane; k < pp; k += kWarp) gs[k] = g_fit[k];
  }
  __syncwarp();

  constexpr int kUnroll = kPer <= 2 ? kDelay : 1;
  Fit<T, kStaged, kPer> f;
  f.coord = coord;
  f.dv = dv;
  f.beta = beta;
  f.band = band;
  f.gram = gs;
  f.g_fit = g_fit;
  f.p = p;
  f.pv = pv;
  f.lane = lane;
  f.valid = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (lane + i * kWarp < p) f.valid |= decltype(f.valid)(1) << i;
  }
#pragma unroll
  for (int s = 0; s + 1 < kDelay; ++s) f.acc[s] = T(0);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    f.gl[i] = T(0);
    f.own[i] = beta[lane + i * kWarp];
  }
  f.kl = 0;
#pragma unroll
  for (int i = 0; i <= kCatch; ++i) f.bw[i] = T(0);
  f.lam_l1 = f.lam_ridge = f.dlx = T(0);
  // The ring starts with the rows of R_0 .. R_{kAhead-1}.
  f.rs = 0;
  f.fs = 0;
  f.jf = 0;
  if constexpr (!kStaged) {
#pragma unroll 1
    for (int a = 0; a < kAhead; ++a) f.fetch();
  }
  // The kDelay updates before the first (coordinates p - kDelay .. p - 1)
  // start R_0 .. R_{kDelay-1} and fill the window with beta0.
  f.load_next(p - kDelay, f.cur, f.bo, f.gbo);
  f.thr = T(0);
  f.dvc = typename Div<T>::Prep(0);
#pragma unroll
  for (int u = 0; u < kDelay; ++u) f.template step<true>(p - kDelay + u);

  for (int l = 0; l < n_lam; ++l) {
    const size_t out_at = static_cast<size_t>(fit) * n_lam + l;
    const T lam = lams[out_at];
    f.set_lambda(lam, alpha, one_minus_alpha, 0);   // a lambda starts at coordinate 0
    f.dlx = static_cast<T>(INFINITY);
    int it = 0;
    // Every lane holds the same dlx; the vote makes the loop's condition
    // warp-uniform for the compiler too.
    while (__all_sync(kFull, f.dlx >= thresh) && it < max_sweeps) {
      f.dlx = T(0);
      // Unrolled by kDelay (not for the wider R, whose body is long), the
      // registers carried from update to update are renamed, not moved.
#pragma unroll(kUnroll)
      for (int j = 0; j < p; ++j) f.template step<false>(j);
      ++it;
    }
    for (int k = lane; k < p; k += kWarp) betas[out_at * p + k] = beta[k];
    if (lane == 0) sweeps[out_at] = it;
  }
  if constexpr (!kStaged) cp_async_wait<0>();
}

// p <= kDelay: the window holds the other p - 1 coordinates (d = p - 1),
// so R_t is the one term G_jj beta_j^old; the updates run one after
// another, with beta in shared memory read by every lane.
template <typename T>
__global__ void __launch_bounds__(kWarp)
    cd_path_small_kernel(const T* __restrict__ gram, const T* __restrict__ xty,
                         const T* __restrict__ pf, const T* __restrict__ lams,
                         const T* __restrict__ beta0, int p, int n_lam, T alpha,
                         T one_minus_alpha, T thresh, int max_sweeps, T* __restrict__ betas,
                         int32_t* __restrict__ sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Coord<T>* coord = reinterpret_cast<Coord<T>*>(smem_raw);
  T* beta = reinterpret_cast<T*>(coord + p);
  T* gs = beta + padded(p);
  const int fit = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t pp = static_cast<size_t>(p) * p;
  const T* g_fit = gram + static_cast<size_t>(fit) * pp;
  for (int k = lane; k < p; k += kWarp) {
    const size_t at = static_cast<size_t>(fit) * p + k;
    beta[k] = beta0 == nullptr ? T(0) : beta0[at];
    coord[k] = Coord<T>{xty[at], pf[at], g_fit[static_cast<size_t>(k) * p + k], T(0)};
  }
  for (size_t k = lane; k < pp; k += kWarp) gs[k] = g_fit[k];
  __syncwarp();
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
        const T* row = gs + static_cast<size_t>(j) * p;
        const Coord<T> q = coord[j];
        const T b_old = beta[j];
        T s = lane == j ? fma(row[j], b_old, T(0)) : T(0);
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) s = s + __shfl_xor_sync(kFull, s, off);
        for (int i = p - 1; i > 0; --i) {
          const int k = j - i < 0 ? j - i + p : j - i;
          s = fma(row[k], beta[k], s);
        }
        const T bj = coord_update(q, s, mul_rn(q.gjj, b_old), lam_l1, lam_ridge);
        const T d = sub_rn(bj, b_old);
        dlx = nan_max(dlx, mul_rn(q.gjj, mul_rn(d, d)));
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

template <typename T>
using Kernel = decltype(&cd_path_small_kernel<T>);

// Whether the Gram matrix at p is staged: the matrix and four vectors fit
// in 200 KB (p <= 224 in float32).
template <typename T>
bool staged_at(int p) {
  return 4 * padded(p) * sizeof(T) + static_cast<size_t>(p) * p * sizeof(T) <= kMaxStagedBytes;
}

// The instantiation's kPer at p: the smallest power of two with
// 32 kPer >= p; the staged ones take p <= 224 in float32 (kPer <= 8), the
// ring ones p > 157 (float64) or 224 (float32).
inline int per_at(int p) {
  int per = 1;
  while (per * kWarp < p) per *= 2;
  return per;
}

// Shared memory of a launch at p.
template <typename T>
size_t smem_bytes(int p) {
  const size_t sz = sizeof(T);
  const size_t gram = static_cast<size_t>(p) * p * sz;
  if (p <= kDelay) return p * sizeof(Coord<T>) + padded(p) * sz + gram;
  const size_t width = static_cast<size_t>(per_at(p)) * kWarp;
  return p * sizeof(Coord<T>) + padded(p) * sizeof(typename Div<T>::Prep) + width * sz +
         padded(static_cast<size_t>(p) * kDelay) * sz +
         (staged_at<T>(p) ? gram : kRing * padded(p) * sz) + width * sz;
}

template <typename T>
Kernel<T> pick(int p) {
  if (p <= kDelay) return cd_path_small_kernel<T>;
  const int per = per_at(p);
  if (staged_at<T>(p)) {
    if (per <= 1) return cd_path_kernel<T, true, 1>;
    if (per <= 2) return cd_path_kernel<T, true, 2>;
    if (per <= 4) return cd_path_kernel<T, true, 4>;
    return cd_path_kernel<T, true, 8>;
  }
  if (per <= 8) return cd_path_kernel<T, false, 8>;
  if (per <= 16) return cd_path_kernel<T, false, 16>;
  if (per <= 32) return cd_path_kernel<T, false, 32>;
  return cd_path_kernel<T, false, kMaxPer>;
}

template <typename T>
int max_p() {
  int p = kMaxPer * kWarp;
  while (smem_bytes<T>(p) > kMaxSmemBytes) --p;
  return p;
}

template <typename T>
int launch(const void* gram, const void* xty, const void* pf, const void* lams,
           const void* beta0, int n_fits, int p, int n_lam, double alpha,
           double one_minus_alpha, double thresh, int max_sweeps, void* betas, void* sweeps,
           cudaStream_t stream) {
  static const int kMaxP = max_p<T>();
  if (p > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(p);
  auto kernel = pick<T>(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem_cap(kernel, smem);
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

// The delay d, and the largest p a launch takes.
extern "C" int ate_cd_delay() { return kDelay; }
extern "C" int ate_cd_max_p(int is_double) {
  return is_double ? max_p<double>() : max_p<float>();
}

namespace {

// Div<float> against div_rn on n pairs: counts the pairs whose results
// differ in their bits (two NaN agree).
__global__ void div_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 long long n, unsigned long long* __restrict__ bad) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float want = __fdiv_rn(a[i], b[i]);
    const float got = Div<float>::apply(a[i], Div<float>::prep(b[i]));
    if (__float_as_uint(got) != __float_as_uint(want) && !(got != got && want != want)) {
      atomicAdd(bad, 1ull);
    }
  }
}

}  // namespace

// The check behind the kernel's float division (tests only).
extern "C" int ate_cd_div_check(const void* a, const void* b, long long n, void* bad,
                                void* stream) {
  div_check_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n,
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ate_lasso_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
