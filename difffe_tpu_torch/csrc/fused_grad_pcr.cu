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
// order and rounded on its own (fused_step_common.cuh); the per-scenario
// sums run in row order.
//
// Design: kernel K2's (tridiag_pcr.cu).  A thread block holds `spb` whole
// scenarios, spb * n rows, in shared memory (arrays a, b, c, r); each
// thread owns R rows and keeps their values in registers across the
// sweeps; the TPU's row padding becomes guarded neighbour reads by the
// row's index in its scenario.  The sweeps' factors, 2 ceil(log2 n) values
// a row (1.2 KB a scenario at n = 31 in float32), follow in shared memory,
// or in a global workspace (rows[sweep][row] per block) when they do not
// fit there.  Operands stay in the caller's layout: (B, n) row-major
// planes, element rows (B, n - 1), each with its own batch stride (0 for a
// load shared by every scenario), so a block's loads are contiguous; the
// streamed F and u_data may be stored as bf16 (K5b).  One block holds at
// most 8192 rows, and its four arrays must fit shared memory.
//
// Bound: the step must read log kappa (or the element values), F and
// u_data and write the loss and gradient once: about (2n + 3) values a
// scenario for K5a, (3n + 1) for K5b.  It does ~16 operations per row and
// sweep forward, 4 in the replay and ~15 around them: ~0.6 operations per
// byte at n = 31, far below the card's balance point, so bytes bound it.
// Each sweep also moves ~12 shared-memory values a row, which at n = 31 is
// ~10x the device-memory traffic (K2's finding).

#include "fused_step_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 8 * kThreads;

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
  const T* cm = cols;          // m
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
      const long long g = s0 + s;
      row[k] = i;
      const T m = cm[i], p = cp[i];
      if (!kGeneral) {
        const T kappa = expo(kap[g * sK]);
        const T mg = cols[5 * n + i], t0 = cols[6 * n + i];
        b[k] = add(m, mul(kappa, cols[2 * n + i]));
        a[k] = mul(kappa, cols[3 * n + i]);
        c[k] = mul(kappa, cols[4 * n + i]);
        r[k] = sub(add(mg, mul(p, load<T>(F, g * sF + i))), mul(kappa, t0));
      } else {
        const T* cmg = cols + 2 * n;
        const T* ke_row = kap + g * sK;
        const T ke = i < n - 1 ? ke_row[i] : zero;
        const T ke_prev = i > 0 ? ke_row[i - 1] : zero;
        const T p_next = i < n - 1 ? cp[i + 1] : zero;
        const T mg_next = i < n - 1 ? cmg[i + 1] : zero;
        const T mg_prev = i > 0 ? cmg[i - 1] : zero;
        const T mg = cmg[i];
        b[k] = add(m, mul(mul(p, add(ke_prev, ke)), inv_h));
        c[k] = mul(mul(mul(-ke, inv_h), p), p_next);
        if (i > 0) a[k] = mul(mul(mul(-ke_prev, inv_h), cp[i - 1]), p);
        const T kmg = mul(sub(sub(mul(add(ke_prev, ke), mg), mul(ke, mg_next)),
                              mul(ke_prev, mg_prev)),
                          inv_h);
        r[k] = add(mg, mul(p, sub(load<T>(F, g * sF + i), kmg)));
      }
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
        const T t = add(add(add(cols[6 * n + i], mul(cols[3 * n + i], u_im1)),
                            mul(cols[2 * n + i], u[k])),
                        mul(cols[4 * n + i], u_ip1));
        sb[j] = mul(lam, t);
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
        grad[g * (n - 1) + i] = mul(mul(neg_inv_h, sub(sa[j], sa[j + 1])),
                                    sub(sb[j], sb[j + 1]));
      }
    }
  }
}

size_t array_bytes(int itemsize, long long rows, int steps, bool factors) {
  return static_cast<size_t>(itemsize) * rows * (factors ? 4 + 2 * steps : 4);
}

template <typename T, typename TF, typename TU, bool kGeneral>
int launch_t(const void* kap, long long sK, const void* F, long long sF,
             const void* ud, long long sU, const void* cols, void* loss,
             void* grad, void* ws, int B, int n, int spb, int steps,
             double inv_h, double scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(spb) * n;
  if (n < 2 || spb < 1 || rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t smem = array_bytes(sizeof(T), rows, steps, ws == nullptr);
  if (smem > static_cast<size_t>(smem_optin_bytes()))
    return cudaErrorInvalidValue;
  const int blocks = (B + spb - 1) / spb;
  const T* k_ = static_cast<const T*>(kap);
  const TF* F_ = static_cast<const TF*>(F);
  const TU* u_ = static_cast<const TU*>(ud);
  const T* c_ = static_cast<const T*>(cols);
  T* l_ = static_cast<T*>(loss);
  T* g_ = static_cast<T*>(grad);
  T* w_ = static_cast<T*>(ws);
  if (rows <= kThreads) {
    const int threads = static_cast<int>((rows + 31) / 32 * 32);
    return launch_with_smem(fused_pcr_kernel<T, TF, TU, kGeneral, 1>, blocks,
                            threads, smem, stream, k_, sK, F_, sF, u_, sU, c_,
                            l_, g_, w_, B, n, spb, steps, T(inv_h), T(scale));
  }
  const int threads = static_cast<int>(((rows + 7) / 8 + 31) / 32 * 32);
  return launch_with_smem(fused_pcr_kernel<T, TF, TU, kGeneral, 8>, blocks,
                          threads, smem, stream, k_, sK, F_, sF, u_, sU, c_,
                          l_, g_, w_, B, n, spb, steps, T(inv_h), T(scale));
}

template <typename T>
int launch(int general, const void* kap, long long sK, const void* F,
           long long sF, int f_code, const void* ud, long long sU,
           int u_code, const void* cols, void* loss, void* grad, void* ws,
           int B, int n, int spb, int steps, double inv_h, double scale,
           cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (f_code == 0 && u_code == 0) {
    if (general)
      return launch_t<T, T, T, true>(kap, sK, F, sF, ud, sU, cols, loss,
                                     grad, ws, B, n, spb, steps, inv_h, scale,
                                     st);
    return launch_t<T, T, T, false>(kap, sK, F, sF, ud, sU, cols, loss, grad,
                                    ws, B, n, spb, steps, inv_h, scale, st);
  }
  if (!general) return cudaErrorInvalidValue;
  if (f_code == 0 && u_code == 1)
    return launch_t<T, T, bf16, true>(kap, sK, F, sF, ud, sU, cols, loss,
                                      grad, ws, B, n, spb, steps, inv_h,
                                      scale, st);
  if (f_code == 1 && u_code == 1)
    return launch_t<T, bf16, bf16, true>(kap, sK, F, sF, ud, sU, cols, loss,
                                         grad, ws, B, n, spb, steps, inv_h,
                                         scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Elements of the global factor workspace a launch of `spb` scenarios a
// block needs: 0 when the factors fit shared memory beside the four band
// arrays, -1 when the band arrays alone do not fit one block.
extern "C" long long difffe_fused_pcr_workspace(int B, int n, int spb,
                                                int is_double) {
  const long long rows = static_cast<long long>(spb) * n;
  const int itemsize = is_double ? 8 : 4;
  int steps = 1;
  while ((1LL << steps) < n) ++steps;
  const size_t cap = static_cast<size_t>(smem_optin_bytes());
  if (rows > kMaxRows || array_bytes(itemsize, rows, steps, false) > cap)
    return -1;
  if (array_bytes(itemsize, rows, steps, true) <= cap) return 0;
  return static_cast<long long>((B + spb - 1) / spb) * 2 * steps * rows;
}

// One fused grad step for B scenarios of n nodes.  `general` = 0: K5a, kap
// is log kappa (B,) with batch stride sK, cols the (8, n) unit-kappa block
// (m, p, d0, a0, c0, mg, t0, rhs0), grad (B,).  `general` = 1: K5b, kap the
// element values (B, n - 1) rows with batch stride sK, cols the (3, n)
// block (m, p, mg), grad (B, n - 1) contiguous.  F and u_data are (B, n)
// rows with unit stride along n and batch strides sF, sU (0: shared),
// stored as the compute type (code 0) or bf16 (code 1, K5b only).  loss
// (B,).  float32, or float64 when `is_double`; `ws` the factor workspace
// (null when difffe_fused_pcr_workspace gives 0).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or storage the kernel does not take.
extern "C" int difffe_fused_pcr(int general, const void* kap, long long sK,
                                const void* F, long long sF, int f_code,
                                const void* ud, long long sU, int u_code,
                                const void* cols, void* loss, void* grad,
                                void* ws, int B, int n, int spb, int steps,
                                double inv_h, double scale, int is_double,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(general, kap, sK, F, sF, f_code, ud, sU, u_code,
                          cols, loss, grad, ws, B, n, spb, steps, inv_h,
                          scale, s);
  return launch<float>(general, kap, sK, F, sF, f_code, ud, sU, u_code, cols,
                       loss, grad, ws, B, n, spb, steps, inv_h, scale, s);
}
