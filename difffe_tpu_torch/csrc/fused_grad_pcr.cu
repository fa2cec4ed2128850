// The fused 1D kappa-recovery grad step by parallel cyclic reduction
// (kernels K5a and K5b).
//
// Replaces the Pallas TPU kernels of
// difffe_tpu/ops/pallas/fused_grad_kernel.py: _fused_step_kernel behind
// _fused_pallas (K5a, one scalar log kappa per scenario) and
// _general_step_kernel behind _general_pallas (K5b, per-element kappa).
// Per scenario, in one launch:
//
//   assemble the Dirichlet-eliminated bands (a, b, c) and right-hand side r
//     K5a: b = m + kappa d0, a = kappa a0, c = kappa c0,
//          r = (mg + p F) - kappa t0, kappa = exp(log kappa)
//     K5b: from the element values, element row i coupling nodes (i, i+1)
//   ceil(log2 n) PCR sweeps, keeping each sweep's (alpha, gamma), u = r / b
//   loss = sum_i (u - u_data)_i^2
//   lambda: the same sweeps replayed on scale (u - u_data) (the factors
//     depend on the matrix only), lambda = r' / b
//   K5a: dlog kappa = kappa * -sum_i lambda_i (t0 + a0 u_{i-1} + d0 u_i
//                                              + c0 u_{i+1})
//   K5b: dkappa_e = -(1/h)(p lambda_e - p lambda_{e+1})(w_e - w_{e+1}),
//        w = mg + p u
//
// with the arithmetic of the plain PyTorch version in
// difffe_tpu_torch/ops/kernels/fused_grad_kernel.py, each operation in its
// order and rounded on its own (fused_step_common.cuh).  Both routes below
// share the row assembly and these operations, so every row value (u,
// lambda, K5b's gradient) has the same bits on both; the per-scenario sums
// (the loss, K5a's contraction) take another order on each, so those two
// agree to rounding, each held to the plain version by the rule of
// chip_smoke.py's phase 7.  The wrapper's k5_plan picks the route.
//
// Warp route (fused_pcr_warp_kernel, n <= kWarpMaxRows = 128): one warp a
// scenario, as K2's warp route (tridiag_pcr.cu).  Row i sits in lane
// i % 32, slot i / 32 (K = ceil(n / 32) slots, a template parameter); a,
// b, c, r, u and every sweep's (alpha, gamma) stay in registers (10
// factors a lane at n = 31: the sweeps are unrolled, so the factor arrays
// are indexed at compile time).  A neighbour at distance s < 32 is a
// __shfl_sync, the row across the lane boundary the neighbour slot's; a
// distance of 32 M is slot k -+ M of the same lane; past the ends a row
// reads the fill (b = 1, a = c = r = 0), so rows i >= n never reach a row
// below n.  No shared memory, no workspace, no barrier.  A sum is a
// butterfly over the lanes (five shuffles): a row-order chain, one shuffle
// and a select a row, made K5a 1.44x slower on an H100 (PERF.md).  A zero
// dividend (a row whose a or c is 0, as rows i < s and i >= n - s are in
// every sweep) is kept out of the IEEE division, whose slow path the whole
// warp would otherwise run (quot0: the same bits, 1.36-1.45x).  At n = 31 a
// scenario makes ~62 warp-wide shuffles (8 a forward sweep, 2 a replayed
// one, 2 for the neighbours, 10 for K5a's sums) and 12 divisions a row.
//
// Block route (fused_pcr_kernel, the first design; n up to one block's
// 8192 rows): a thread block holds `spb` whole scenarios, spb * n rows, in
// shared memory (arrays a, b, c, r); each thread owns R rows and keeps
// their values in registers across the sweeps; the TPU's row padding
// becomes guarded neighbour reads by the row's index in its scenario.  The
// sweeps' factors, 2 ceil(log2 n) values a row (1.2 KB a scenario at n =
// 31 in float32), follow in shared memory, or in a global workspace
// (rows[sweep][row] per block) when they do not fit there.  Two block
// barriers a sweep; one thread a scenario runs each sum in row order,
// (((0 + x_0) + x_1) + ...).
//
// Both read the operands in the caller's layout: (B, n) row-major planes,
// element rows (B, n - 1), each with its own batch stride (0 for a load
// shared by every scenario), so a scenario's loads are contiguous; the
// streamed F and u_data may be stored as bf16 (K5b).
//
// Bound: the step must read log kappa (or the element values), F and
// u_data and write the loss and gradient once: about (2n + 3) values a
// scenario for K5a, (3n + 1) for K5b.  It does ~16 operations per row and
// sweep forward, 4 in the replay and ~15 around them: ~0.6 operations per
// byte at n = 31, far below the card's balance point, so bytes bound it.
// The block route also moves ~12 shared-memory values a row and sweep,
// ~10x the device-memory traffic at n = 31 (K2's finding); the warp route
// moves them by shuffles, so its cost is the shuffles and the divisions.

#include "fused_step_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 8 * kThreads;
constexpr int kWarpThreads = 128;     // 4 scenarios a block
constexpr int kWarpMaxSlots = 4;
constexpr int kWarpMaxRows = 32 * kWarpMaxSlots;
constexpr unsigned kFull = 0xffffffffu;

// Row i's bands and right-hand side of scenario g from the caller's planes
// (a stays 0 on row 0).
template <typename T, typename TF, bool kGeneral>
__device__ __forceinline__ void assemble_row(
    const T* __restrict__ kap, long long sK, const TF* __restrict__ F,
    long long sF, const T* __restrict__ cols, long long g, int i, int n,
    T inv_h, T& a, T& b, T& c, T& r) {
  const T zero = T(0);
  const T m = cols[i], p = cols[n + i];
  if (!kGeneral) {
    const T kappa = expo(kap[g * sK]);
    const T mg = cols[5 * n + i], t0 = cols[6 * n + i];
    b = add(m, mul(kappa, cols[2 * n + i]));
    a = mul(kappa, cols[3 * n + i]);
    c = mul(kappa, cols[4 * n + i]);
    r = sub(add(mg, mul(p, load<T>(F, g * sF + i))), mul(kappa, t0));
  } else {
    const T* cp = cols + n;
    const T* cmg = cols + 2 * n;
    const T* ke_row = kap + g * sK;
    const T ke = i < n - 1 ? ke_row[i] : zero;
    const T ke_prev = i > 0 ? ke_row[i - 1] : zero;
    const T p_next = i < n - 1 ? cp[i + 1] : zero;
    const T mg_next = i < n - 1 ? cmg[i + 1] : zero;
    const T mg_prev = i > 0 ? cmg[i - 1] : zero;
    const T mg = cmg[i];
    b = add(m, mul(mul(p, add(ke_prev, ke)), inv_h));
    c = mul(mul(mul(-ke, inv_h), p), p_next);
    a = i > 0 ? mul(mul(mul(-ke_prev, inv_h), cp[i - 1]), p) : zero;
    const T kmg = mul(sub(sub(mul(add(ke_prev, ke), mg), mul(ke, mg_next)),
                          mul(ke_prev, mg_prev)),
                      inv_h);
    r = add(mg, mul(p, sub(load<T>(F, g * sF + i), kmg)));
  }
}

// K5a's contraction term of row i: lambda_i (t0 + a0 u_{i-1} + d0 u_i +
// c0 u_{i+1}).
template <typename T>
__device__ __forceinline__ T k5a_term(const T* __restrict__ cols, int n,
                                      int i, T lam, T u_im1, T u, T u_ip1) {
  const T t = add(add(add(cols[6 * n + i], mul(cols[3 * n + i], u_im1)),
                      mul(cols[2 * n + i], u)),
                  mul(cols[4 * n + i], u_ip1));
  return mul(lam, t);
}

// K5b's gradient of element i from (p lambda, w) of rows i and i + 1.
template <typename T>
__device__ __forceinline__ T k5b_grad(T neg_inv_h, T pl, T pl_next, T w,
                                      T w_next) {
  return mul(mul(neg_inv_h, sub(pl, pl_next)), sub(w, w_next));
}

// ---------------------------------------------------------------------------
// Block route (the first design)
// ---------------------------------------------------------------------------

template <typename T, typename TF, typename TU, bool kGeneral, int R>
__global__ void __launch_bounds__(kThreads)
fused_pcr_kernel(const T* __restrict__ kap, long long sK,
                 const TF* __restrict__ F, long long sF,
                 const TU* __restrict__ ud, long long sU,
                 const T* __restrict__ cols, T* __restrict__ loss,
                 T* __restrict__ grad, T* __restrict__ ws, int B, int n,
                 int spb, int steps, T inv_h, T scale) {
  extern __shared__ unsigned char smem_raw[];
  const int rows = spb * n;
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + rows;
  T* sc = sb + rows;
  T* sr = sc + rows;
  T* fac = ws == nullptr
               ? sr + rows
               : ws + static_cast<long long>(blockIdx.x) * 2 * steps * rows;
  const long long s0 = static_cast<long long>(blockIdx.x) * spb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < spb ? static_cast<int>(left) : spb;
  const int live = nsc * n;
  const T* cp = cols + n;      // p
  const T zero = T(0);

  T a[R], b[R], c[R], r[R], u[R];
  int row[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    row[k] = 0;
    a[k] = c[k] = r[k] = u[k] = zero;
    b[k] = T(1);
    if (j < live) {
      const int s = j / n;
      const int i = j - s * n;
      row[k] = i;
      assemble_row<T, TF, kGeneral>(kap, sK, F, sF, cols, s0 + s, i, n,
                                    inv_h, a[k], b[k], c[k], r[k]);
      sa[j] = a[k];
      sb[j] = b[k];
      sc[j] = c[k];
      sr[j] = r[k];
    }
  }
  __syncthreads();

  // forward sweeps, keeping (alpha, gamma) of each
  for (int st = 0, s = 1; st < steps; ++st, s <<= 1) {
    T* fa = fac + static_cast<long long>(2 * st) * rows;
    T* fg = fa + rows;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < live) {
        const int i = row[k];
        T b_up = T(1), a_up = zero, c_up = zero, r_up = zero;
        T b_dn = T(1), a_dn = zero, c_dn = zero, r_dn = zero;
        if (i >= s) {
          b_up = sb[j - s];
          a_up = sa[j - s];
          c_up = sc[j - s];
          r_up = sr[j - s];
        }
        if (i + s < n) {
          b_dn = sb[j + s];
          a_dn = sa[j + s];
          c_dn = sc[j + s];
          r_dn = sr[j + s];
        }
        const T alpha = quot(-a[k], b_up);
        const T gamma = quot(-c[k], b_dn);
        fa[j] = alpha;
        fg[j] = gamma;
        b[k] = add(add(b[k], mul(alpha, c_up)), mul(gamma, a_dn));
        r[k] = add(add(r[k], mul(alpha, r_up)), mul(gamma, r_dn));
        a[k] = mul(alpha, a_up);
        c[k] = mul(gamma, c_dn);
      }
    }
    __syncthreads();  // every read of this sweep is done
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < live) {
        sa[j] = a[k];
        sb[j] = b[k];
        sc[j] = c[k];
        sr[j] = r[k];
      }
    }
    __syncthreads();
  }

  // u, the loss terms (sa), u for the neighbours (sc), scale (u - u_data)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < live) {
      const long long g = s0 + j / n;
      u[k] = quot(r[k], b[k]);
      const T d = sub(u[k], load<T>(ud, g * sU + row[k]));
      sa[j] = mul(d, d);
      sc[j] = u[k];
      r[k] = mul(scale, d);
      sr[j] = r[k];
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nsc) {
    const T* terms = sa + threadIdx.x * n;
    T acc = zero;
    for (int i = 0; i < n; ++i) acc = add(acc, terms[i]);
    loss[s0 + threadIdx.x] = acc;
  }

  // the adjoint: the forward sweeps replayed on scale (u - u_data)
  for (int st = 0, s = 1; st < steps; ++st, s <<= 1) {
    const T* fa = fac + static_cast<long long>(2 * st) * rows;
    const T* fg = fa + rows;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < live) {
        const int i = row[k];
        const T up = i >= s ? sr[j - s] : zero;
        const T dn = i + s < n ? sr[j + s] : zero;
        r[k] = add(add(r[k], mul(fa[j], up)), mul(fg[j], dn));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < live) sr[j] = r[k];
    }
    __syncthreads();
  }

  // the kappa contraction (every loss-sum read of sa is done: the replay
  // passed at least one barrier)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < live) {
      const int i = row[k];
      const T lam = quot(r[k], b[k]);
      if (!kGeneral) {
        const T u_im1 = i > 0 ? sc[j - 1] : zero;
        const T u_ip1 = i < n - 1 ? sc[j + 1] : zero;
        sb[j] = k5a_term(cols, n, i, lam, u_im1, u[k], u_ip1);
      } else {
        const T p = cp[i];
        sb[j] = add(cols[2 * n + i], mul(p, u[k]));  // w
        sa[j] = mul(p, lam);                          // p lambda
      }
    }
  }
  __syncthreads();
  if (!kGeneral) {
    if (static_cast<int>(threadIdx.x) < nsc) {
      const long long g = s0 + threadIdx.x;
      const T* terms = sb + threadIdx.x * n;
      T acc = zero;
      for (int i = 0; i < n; ++i) acc = add(acc, terms[i]);
      grad[g] = mul(expo(kap[g * sK]), -acc);
    }
  } else {
    const T neg_inv_h = -inv_h;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      const int i = row[k];
      if (j < live && i < n - 1) {
        const long long g = s0 + j / n;
        grad[g * (n - 1) + i] =
            k5b_grad(neg_inv_h, sa[j], sa[j + 1], sb[j], sb[j + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Warp route
// ---------------------------------------------------------------------------

// x / b rounded as quot, with a zero dividend kept out of the division:
// IEEE gives 0 / b = x * b (the sign of x times b's) for every finite
// nonzero b, and the division's slow path need not run for it.
template <typename T>
__device__ __forceinline__ T quot0(T x, T b) {
  const bool z = x == T(0) && b != T(0) && isfinite(b);
  const T q = quot(z ? T(1) : x, b);
  return z ? mul(x, b) : q;
}

// One row's four band values.
template <typename T>
struct Row {
  T a, b, c, r;
};

template <typename T>
__device__ __forceinline__ Row<T> fill_row() {
  return Row<T>{T(0), T(1), T(0), T(0)};
}

template <typename T>
__device__ __forceinline__ Row<T> shfl_row(const Row<T>& x, int src) {
  return Row<T>{__shfl_sync(kFull, x.a, src), __shfl_sync(kFull, x.b, src),
                __shfl_sync(kFull, x.c, src), __shfl_sync(kFull, x.r, src)};
}

// One PCR update of row x from its neighbours up (i - s) and dn (i + s),
// the block route's operations; the sweep's factors go to (alpha, gamma).
template <typename T>
__device__ __forceinline__ Row<T> pcr_update(const Row<T>& x,
                                             const Row<T>& up,
                                             const Row<T>& dn, T& alpha,
                                             T& gamma) {
  alpha = quot0(-x.a, up.b);
  gamma = quot0(-x.c, dn.b);
  return Row<T>{mul(alpha, up.a),
                add(add(x.b, mul(alpha, up.c)), mul(gamma, dn.a)),
                mul(gamma, dn.c),
                add(add(x.r, mul(alpha, up.r)), mul(gamma, dn.r))};
}

// One forward sweep at a stride s < 32 over the K slots: the neighbours are
// shuffles, the rows across the lane boundary the neighbour slot's.
template <typename T, int K>
__device__ __forceinline__ void warp_sweep_shfl(Row<T> (&x)[K],
                                                T (&fa)[K], T (&fg)[K],
                                                int lane, int n, int s) {
  const int src_up = (lane - s) & 31, src_dn = (lane + s) & 31;
  const bool wrap_up = lane < s, wrap_dn = lane + s >= 32;
  // t_prev: slot k-1 shuffled up; d_cur, d_next: slots k and k+1 shuffled
  // down (old values)
  Row<T> t_prev = fill_row<T>();
  Row<T> d_cur = shfl_row(x[0], src_dn);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Row<T> t_cur = shfl_row(x[k], src_up);
    const Row<T> d_next =
        k + 1 < K ? shfl_row(x[k + 1], src_dn) : fill_row<T>();
    const Row<T> up = wrap_up ? t_prev : t_cur;
    Row<T> dn = wrap_dn ? d_next : d_cur;
    if (32 * k + lane + s >= n) dn = fill_row<T>();
    x[k] = pcr_update(x[k], up, dn, fa[k], fg[k]);
    t_prev = t_cur;
    d_cur = d_next;
  }
}

// One forward sweep at the stride 32 M: the neighbours are slots k -+ M of
// the same lane, updated in place along each chain k0, k0 + M, ... with
// the previous slot's old value kept.
template <typename T, int K, int M>
__device__ __forceinline__ void warp_sweep_slots(Row<T> (&x)[K],
                                                 T (&fa)[K], T (&fg)[K],
                                                 int lane, int n) {
#pragma unroll
  for (int k0 = 0; k0 < M && k0 < K; ++k0) {
    Row<T> prev = fill_row<T>();   // old value of slot k - M
#pragma unroll
    for (int k = k0; k < K; k += M) {
      const Row<T> old = x[k];
      Row<T> dn = k + M < K ? x[k + M] : fill_row<T>();
      if (32 * (k + M) + lane >= n) dn = fill_row<T>();
      x[k] = pcr_update(old, prev, dn, fa[k], fg[k]);
      prev = old;
    }
  }
}

// The replay of a sweep at a stride s < 32 on r, the block route's
// operations.
template <typename T, int K>
__device__ __forceinline__ void warp_replay_shfl(T (&r)[K],
                                                 const T (&fa)[K],
                                                 const T (&fg)[K], int lane,
                                                 int n, int s) {
  const int src_up = (lane - s) & 31, src_dn = (lane + s) & 31;
  const bool wrap_up = lane < s, wrap_dn = lane + s >= 32;
  T t_prev = T(0);
  T d_cur = __shfl_sync(kFull, r[0], src_dn);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T t_cur = __shfl_sync(kFull, r[k], src_up);
    const T d_next = k + 1 < K ? __shfl_sync(kFull, r[k + 1], src_dn) : T(0);
    const T up = wrap_up ? t_prev : t_cur;
    T dn = wrap_dn ? d_next : d_cur;
    if (32 * k + lane + s >= n) dn = T(0);
    r[k] = add(add(r[k], mul(fa[k], up)), mul(fg[k], dn));
    t_prev = t_cur;
    d_cur = d_next;
  }
}

// The replay of a sweep at the stride 32 M.
template <typename T, int K, int M>
__device__ __forceinline__ void warp_replay_slots(T (&r)[K],
                                                  const T (&fa)[K],
                                                  const T (&fg)[K], int lane,
                                                  int n) {
#pragma unroll
  for (int k0 = 0; k0 < M && k0 < K; ++k0) {
    T prev = T(0);
#pragma unroll
    for (int k = k0; k < K; k += M) {
      const T old = r[k];
      T dn = k + M < K ? r[k + M] : T(0);
      if (32 * (k + M) + lane >= n) dn = T(0);
      r[k] = add(add(old, mul(fa[k], prev)), mul(fg[k], dn));
      prev = old;
    }
  }
}

// v at rows i - 1 (lo) and i + 1 (hi) of each slot's row i (0 past the
// slots; the caller guards the ends of the system).
template <typename T, int K>
__device__ __forceinline__ void warp_neighbours(const T (&v)[K], int lane,
                                                T (&lo)[K], T (&hi)[K]) {
  T up[K], dn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    up[k] = __shfl_sync(kFull, v[k], (lane + 31) & 31);
    dn[k] = __shfl_sync(kFull, v[k], (lane + 1) & 31);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lo[k] = lane == 0 ? (k > 0 ? up[k - 1] : T(0)) : up[k];
    hi[k] = lane == 31 ? (k + 1 < K ? dn[k + 1] : T(0)) : dn[k];
  }
}

// v at row i + 1 of each slot's row i (0 past the slots).
template <typename T, int K>
__device__ __forceinline__ void warp_next(const T (&v)[K], int lane,
                                          T (&hi)[K]) {
  T dn[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    dn[k] = __shfl_sync(kFull, v[k], (lane + 1) & 31);
#pragma unroll
  for (int k = 0; k < K; ++k)
    hi[k] = lane == 31 ? (k + 1 < K ? dn[k + 1] : T(0)) : dn[k];
}

// The warp's sums s1 = sum t1 and, with kTwo, s2 = sum t2 over the rows
// i < n (s1 on lane 0, s2 on lane 1 at least): each lane adds its slots
// in order, then a butterfly over the lanes, five shuffles a sum.
template <typename T, int K, bool kTwo>
__device__ __forceinline__ void warp_sums(const T (&t1)[K],
                                          const T (&t2)[K], int lane, int n,
                                          T& s1, T& s2) {
  T acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (32 * k + lane < n) {
      acc1 = add(acc1, t1[k]);
      if (kTwo) acc2 = add(acc2, t2[k]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc1 = add(acc1, __shfl_xor_sync(kFull, acc1, o));
    if (kTwo) acc2 = add(acc2, __shfl_xor_sync(kFull, acc2, o));
  }
  s1 = acc1;
  s2 = acc2;
}

template <typename T, typename TF, typename TU, bool kGeneral, int K>
__global__ void __launch_bounds__(kWarpThreads)
fused_pcr_warp_kernel(const T* __restrict__ kap, long long sK,
                      const TF* __restrict__ F, long long sF,
                      const TU* __restrict__ ud, long long sU,
                      const T* __restrict__ cols, T* __restrict__ loss,
                      T* __restrict__ grad, int B, int n, int steps,
                      T inv_h, T scale) {
  constexpr int S = K == 1 ? 5 : K == 2 ? 6 : 7;   // sweeps at 32 K rows
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) *
                          (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (g >= B) return;   // the whole warp: shuffles stay within live warps
  const T zero = T(0);

  Row<T> x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    x[k] = fill_row<T>();
    if (i < n)
      assemble_row<T, TF, kGeneral>(kap, sK, F, sF, cols, g, i, n, inv_h,
                                    x[k].a, x[k].b, x[k].c, x[k].r);
  }

  // forward sweeps, keeping (alpha, gamma) of each in registers: strides
  // 1..16 by shuffles, then 32 and 64 by slot moves
  T fa[S][K], fg[S][K];
#pragma unroll
  for (int st = 0; st < 5; ++st)
    if (st < steps) warp_sweep_shfl<T, K>(x, fa[st], fg[st], lane, n, 1 << st);
  if constexpr (K > 1) {
    if (steps > 5) warp_sweep_slots<T, K, 1>(x, fa[5], fg[5], lane, n);
  }
  if constexpr (K > 2) {
    if (steps > 6) warp_sweep_slots<T, K, 2>(x, fa[6], fg[6], lane, n);
  }

  // u, the loss terms, scale (u - u_data)
  T u[K], t1[K], r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    u[k] = t1[k] = r[k] = zero;
    if (i < n) {
      u[k] = quot0(x[k].r, x[k].b);
      const T d = sub(u[k], load<T>(ud, g * sU + i));
      t1[k] = mul(d, d);
      r[k] = mul(scale, d);
    }
  }

  // the adjoint: the forward sweeps replayed on scale (u - u_data)
#pragma unroll
  for (int st = 0; st < 5; ++st)
    if (st < steps) warp_replay_shfl<T, K>(r, fa[st], fg[st], lane, n, 1 << st);
  if constexpr (K > 1) {
    if (steps > 5) warp_replay_slots<T, K, 1>(r, fa[5], fg[5], lane, n);
  }
  if constexpr (K > 2) {
    if (steps > 6) warp_replay_slots<T, K, 2>(r, fa[6], fg[6], lane, n);
  }

  T lam[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    lam[k] = 32 * k + lane < n ? quot0(r[k], x[k].b) : zero;

  T s1, s2;
  if (!kGeneral) {
    T lo[K], hi[K], t2[K];
    warp_neighbours<T, K>(u, lane, lo, hi);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      t2[k] = zero;
      if (i < n)
        t2[k] = k5a_term(cols, n, i, lam[k], i > 0 ? lo[k] : zero, u[k],
                         i < n - 1 ? hi[k] : zero);
    }
    warp_sums<T, K, true>(t1, t2, lane, n, s1, s2);
    if (lane == 1) grad[g] = mul(expo(kap[g * sK]), -s2);
  } else {
    T w[K], pl[K], w_next[K], pl_next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      w[k] = pl[k] = zero;
      if (i < n) {
        const T p = cols[n + i];
        w[k] = add(cols[2 * n + i], mul(p, u[k]));
        pl[k] = mul(p, lam[k]);
      }
    }
    warp_next<T, K>(w, lane, w_next);
    warp_next<T, K>(pl, lane, pl_next);
    const T neg_inv_h = -inv_h;
    T* grow = grad + g * (n - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * k + lane;
      if (i < n - 1)
        grow[i] = k5b_grad(neg_inv_h, pl[k], pl_next[k], w[k], w_next[k]);
    }
    warp_sums<T, K, false>(t1, t1, lane, n, s1, s2);
  }
  if (lane == 0) loss[g] = s1;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

size_t array_bytes(int itemsize, long long rows, int steps, bool factors) {
  return static_cast<size_t>(itemsize) * rows * (factors ? 4 + 2 * steps : 4);
}

int sweeps(int n) {
  int steps = 1;
  while ((1LL << steps) < n) ++steps;
  return steps;
}

// The operands of a launch, as typed pointers.
template <typename T, typename TF, typename TU>
struct Args {
  const T* kap;
  long long sK;
  const TF* F;
  long long sF;
  const TU* ud;
  long long sU;
  const T* cols;
  T* loss;
  T* grad;
};

template <typename T, typename TF, typename TU, bool kGeneral>
int launch_block(const Args<T, TF, TU>& x, void* ws, int B, int n, int spb,
                 int steps, double inv_h, double scale,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(spb) * n;
  if (n < 2 || spb < 1 || rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t smem = array_bytes(sizeof(T), rows, steps, ws == nullptr);
  if (smem > static_cast<size_t>(smem_optin_bytes()))
    return cudaErrorInvalidValue;
  const int blocks = (B + spb - 1) / spb;
  T* w_ = static_cast<T*>(ws);
  if (rows <= kThreads) {
    const int threads = static_cast<int>((rows + 31) / 32 * 32);
    return launch_with_smem(fused_pcr_kernel<T, TF, TU, kGeneral, 1>, blocks,
                            threads, smem, stream, x.kap, x.sK, x.F, x.sF,
                            x.ud, x.sU, x.cols, x.loss, x.grad, w_, B, n,
                            spb, steps, T(inv_h), T(scale));
  }
  const int threads = static_cast<int>(((rows + 7) / 8 + 31) / 32 * 32);
  return launch_with_smem(fused_pcr_kernel<T, TF, TU, kGeneral, 8>, blocks,
                          threads, smem, stream, x.kap, x.sK, x.F, x.sF, x.ud,
                          x.sU, x.cols, x.loss, x.grad, w_, B, n, spb, steps,
                          T(inv_h), T(scale));
}

template <typename T, typename TF, typename TU, bool kGeneral, int K>
int launch_warp_k(const Args<T, TF, TU>& x, int B, int n, double inv_h,
                  double scale, cudaStream_t stream) {
  constexpr int per_block = kWarpThreads / 32;
  const int blocks = static_cast<int>((static_cast<long long>(B) +
                                       per_block - 1) / per_block);
  fused_pcr_warp_kernel<T, TF, TU, kGeneral, K>
      <<<blocks, kWarpThreads, 0, stream>>>(
          x.kap, x.sK, x.F, x.sF, x.ud, x.sU, x.cols, x.loss, x.grad, B, n,
          sweeps(n), T(inv_h), T(scale));
  return cudaGetLastError();
}

template <typename T, typename TF, typename TU, bool kGeneral>
int launch_warp(const Args<T, TF, TU>& x, int B, int n, double inv_h,
                double scale, cudaStream_t stream) {
  if (n < 2 || n > kWarpMaxRows || B < 1) return cudaErrorInvalidValue;
  switch ((n + 31) / 32) {
    case 1:
      return launch_warp_k<T, TF, TU, kGeneral, 1>(x, B, n, inv_h, scale,
                                                   stream);
    case 2:
      return launch_warp_k<T, TF, TU, kGeneral, 2>(x, B, n, inv_h, scale,
                                                   stream);
    case 3:
      return launch_warp_k<T, TF, TU, kGeneral, 3>(x, B, n, inv_h, scale,
                                                   stream);
    default:
      return launch_warp_k<T, TF, TU, kGeneral, kWarpMaxSlots>(
          x, B, n, inv_h, scale, stream);
  }
}

template <typename T, typename TF, typename TU, bool kGeneral>
int launch_t(bool warp, const void* kap, long long sK, const void* F,
             long long sF, const void* ud, long long sU, const void* cols,
             void* loss, void* grad, void* ws, int B, int n, int spb,
             int steps, double inv_h, double scale, cudaStream_t stream) {
  const Args<T, TF, TU> x{static_cast<const T*>(kap), sK,
                          static_cast<const TF*>(F), sF,
                          static_cast<const TU*>(ud), sU,
                          static_cast<const T*>(cols), static_cast<T*>(loss),
                          static_cast<T*>(grad)};
  if (warp) return launch_warp<T, TF, TU, kGeneral>(x, B, n, inv_h, scale,
                                                    stream);
  return launch_block<T, TF, TU, kGeneral>(x, ws, B, n, spb, steps, inv_h,
                                           scale, stream);
}

template <typename T>
int launch(bool warp, int general, const void* kap, long long sK,
           const void* F, long long sF, int f_code, const void* ud,
           long long sU, int u_code, const void* cols, void* loss, void* grad,
           void* ws, int B, int n, int spb, int steps, double inv_h,
           double scale, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (f_code == 0 && u_code == 0) {
    if (general)
      return launch_t<T, T, T, true>(warp, kap, sK, F, sF, ud, sU, cols,
                                     loss, grad, ws, B, n, spb, steps, inv_h,
                                     scale, st);
    return launch_t<T, T, T, false>(warp, kap, sK, F, sF, ud, sU, cols, loss,
                                    grad, ws, B, n, spb, steps, inv_h, scale,
                                    st);
  }
  if (!general) return cudaErrorInvalidValue;
  if (f_code == 0 && u_code == 1)
    return launch_t<T, T, bf16, true>(warp, kap, sK, F, sF, ud, sU, cols,
                                      loss, grad, ws, B, n, spb, steps, inv_h,
                                      scale, st);
  if (f_code == 1 && u_code == 1)
    return launch_t<T, bf16, bf16, true>(warp, kap, sK, F, sF, ud, sU, cols,
                                         loss, grad, ws, B, n, spb, steps,
                                         inv_h, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Elements of the global factor workspace a launch of `spb` scenarios a
// block needs on the block route: 0 when the factors fit shared memory
// beside the four band arrays, -1 when the band arrays alone do not fit
// one block.
extern "C" long long difffe_fused_pcr_workspace(int B, int n, int spb,
                                                int is_double) {
  const long long rows = static_cast<long long>(spb) * n;
  const int itemsize = is_double ? 8 : 4;
  const int steps = sweeps(n);
  const size_t cap = static_cast<size_t>(smem_optin_bytes());
  if (rows > kMaxRows || array_bytes(itemsize, rows, steps, false) > cap)
    return -1;
  if (array_bytes(itemsize, rows, steps, true) <= cap) return 0;
  return static_cast<long long>((B + spb - 1) / spb) * 2 * steps * rows;
}

// One fused grad step for B scenarios of n nodes on the block route.
// `general` = 0: K5a, kap is log kappa (B,) with batch stride sK, cols the
// (8, n) unit-kappa block (m, p, d0, a0, c0, mg, t0, rhs0), grad (B,).
// `general` = 1: K5b, kap the element values (B, n - 1) rows with batch
// stride sK, cols the (3, n) block (m, p, mg), grad (B, n - 1) contiguous.
// F and u_data are (B, n) rows with unit stride along n and batch strides
// sF, sU (0: shared), stored as the compute type (code 0) or bf16 (code 1,
// K5b only).  loss (B,).  float32, or float64 when `is_double`; `ws` the
// factor workspace (null when difffe_fused_pcr_workspace gives 0).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape or storage the kernel does not take.
extern "C" int difffe_fused_pcr(int general, const void* kap, long long sK,
                                const void* F, long long sF, int f_code,
                                const void* ud, long long sU, int u_code,
                                const void* cols, void* loss, void* grad,
                                void* ws, int B, int n, int spb, int steps,
                                double inv_h, double scale, int is_double,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(false, general, kap, sK, F, sF, f_code, ud, sU,
                          u_code, cols, loss, grad, ws, B, n, spb, steps,
                          inv_h, scale, s);
  return launch<float>(false, general, kap, sK, F, sF, f_code, ud, sU,
                       u_code, cols, loss, grad, ws, B, n, spb, steps, inv_h,
                       scale, s);
}

// The same step on the warp route, one warp a scenario, for 2 <= n <=
// kWarpMaxRows (128; the wrapper's K5_WARP_MAX_ROWS): the operands as
// difffe_fused_pcr's, no workspace.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or storage it does not
// take.
extern "C" int difffe_fused_pcr_warp(int general, const void* kap,
                                     long long sK, const void* F,
                                     long long sF, int f_code,
                                     const void* ud, long long sU,
                                     int u_code, const void* cols,
                                     void* loss, void* grad, int B, int n,
                                     double inv_h, double scale,
                                     int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(true, general, kap, sK, F, sF, f_code, ud, sU,
                          u_code, cols, loss, grad, nullptr, B, n, 0, 0,
                          inv_h, scale, s);
  return launch<float>(true, general, kap, sK, F, sF, f_code, ud, sU, u_code,
                       cols, loss, grad, nullptr, B, n, 0, 0, inv_h, scale,
                       s);
}
