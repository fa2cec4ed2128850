// The fused per-element-kappa 1D grad step by Thomas elimination (kernel
// K6).
//
// Replaces the Pallas TPU kernel of
// difffe_tpu/ops/pallas/fused_grad_thomas_kernel.py: _fused_thomas_kernel
// behind _thomas_pallas.  Per scenario, with element row i coupling nodes
// (i, i+1) and the Dirichlet rows eliminated:
//
//   factor once:  bi_0 = 1 / d_0;  cp_{i-1} = a_i bi_{i-1};
//                 bi_i = 1 / (d_i - a_i cp_{i-1})
//   solve T u = r by forward and back substitution on those factors
//   loss = sum_i (u - u_data)_i^2
//   solve T lambda = scale (u - u_data) on the same factors
//   dkappa_e = -(1/h)(p lambda_e - p lambda_{e+1})(w_e - w_{e+1}),
//   w = mg + p u
//
// with the arithmetic of the plain PyTorch version in
// difffe_tpu_torch/ops/kernels/fused_grad_thomas_kernel.py, each operation
// in its order and rounded on its own (fused_step_common.cuh), so the
// kernel gives that version's bits.
//
// Design.  One scenario per thread: Thomas is O(n) work per scenario
// against PCR's O(n log n), and the batch gives the parallelism.  The
// TPU packed scenarios as (N, 8, B/8) so that each row step filled a
// native tile; here a warp's 32 threads step through one row together.
// A block of `tb` scenarios first stages its tiles of kappa (B, n - 1),
// F and u_data (B, n), read as the caller holds them with coalesced loads,
// into shared memory transposed to [row][thread] (pitch tb + 1, so neither
// the transposing writes nor the row reads conflict on banks); a shared F
// (batch stride 0) is read in place.  The factors cp and bi and the u and
// lambda rows (~4n values a scenario, which a runtime n keeps out of
// registers) sit beside them in the same layout.  When 7n (tb + 1) values
// do not fit the block's shared memory for tb >= 32, the factors and
// rows live in a global workspace [row][scenario] (loads coalesce across
// the warp) and the inputs are read in place: n has no limit.  The
// gradient tile is written back through shared memory, coalesced.
//
// Bound: the step must read kappa, F and u_data and write the loss and the
// gradient once, (3n + 1) values a scenario with a streamed F; it does ~25
// operations a row (two divisions among them), ~1.6 operations per byte in
// float32, below the card's balance point: bytes bound it.

#include "fused_step_common.cuh"

namespace {

constexpr int kMaxBlock = 128;
constexpr int kStaged = 7;  // kappa, u_data, F, cp, bi, u, lambda rows

template <typename T, typename TF, typename TU, bool kShared>
__global__ void __launch_bounds__(kMaxBlock)
thomas_kernel(const T* __restrict__ ke, long long sK,
              const TF* __restrict__ F, long long sF,
              const TU* __restrict__ ud, long long sU,
              const T* __restrict__ cols, T* __restrict__ loss,
              T* __restrict__ grad, T* __restrict__ ws, int B, int n,
              T inv_h, T scale) {
  extern __shared__ unsigned char smem_raw[];
  const int tb = blockDim.x, t = threadIdx.x, ne = n - 1;
  const long long s0 = static_cast<long long>(blockIdx.x) * tb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < tb ? static_cast<int>(left) : tb;
  const long long g = s0 + t;
  // [row][column] arrays: shared memory (column = thread) or the global
  // workspace (column = scenario)
  const long long pitch =
      kShared ? tb + 1 : static_cast<long long>(gridDim.x) * tb;
  const long long col = kShared ? t : g;
  const long long plane = static_cast<long long>(n) * pitch;
  T* base = kShared ? reinterpret_cast<T*>(smem_raw) : ws;
  T* CP = base;
  T* BI = CP + plane;
  T* U = BI + plane;
  T* Z = U + plane;
  T* KE = Z + plane;  // staged tiles (kShared only)
  T* UD = KE + plane;
  T* FT = UD + plane;

  if (kShared) {
    for (int k = t; k < nsc * ne; k += tb) {
      const int s = k / ne, i = k - s * ne;
      KE[i * pitch + s] = ke[(s0 + s) * sK + i];
    }
    for (int k = t; k < nsc * n; k += tb) {
      const int s = k / n, i = k - s * n;
      UD[i * pitch + s] = load<T>(ud, (s0 + s) * sU + i);
      if (sF != 0) FT[i * pitch + s] = load<T>(F, (s0 + s) * sF + i);
    }
    __syncthreads();
  }

  const T zero = T(0), one = T(1), neg_inv_h = -inv_h;
  const T* cm = cols;
  const T* cp = cols + n;
  const T* cmg = cols + 2 * n;
  auto kap = [&](int i) -> T {
    if (i >= ne) return zero;  // node row n - 1 carries no element
    return kShared ? KE[i * pitch + t] : ke[g * sK + i];
  };
  auto obs = [&](int i) -> T {
    return kShared ? UD[i * pitch + t] : load<T>(ud, g * sU + i);
  };
  auto load_f = [&](int i) -> T {
    if (sF == 0) return load<T>(F, i);
    return kShared ? FT[i * pitch + t] : load<T>(F, g * sF + i);
  };
  auto a_row = [&](int i) -> T {  // a_i = e_{i-1} = -kappa_{i-1}/h p_{i-1} p_i
    return mul(kap(i - 1), mul(mul(neg_inv_h, cp[i - 1]), cp[i]));
  };
  auto at = [&](T* arr, int i) -> T& { return arr[i * pitch + col]; };

  if (t < nsc) {
    // the factorization, with the forward substitution of T u = r
    T bi = quot(one, add(cm[0], mul(mul(cp[0], kap(0)), inv_h)));
    T k_prev = zero, y = zero;
    for (int i = 0; i < n; ++i) {
      const T k_i = kap(i);
      const T mg_next = i < n - 1 ? cmg[i + 1] : zero;
      const T mg_prev = i > 0 ? cmg[i - 1] : zero;
      const T kmg = mul(sub(sub(mul(add(k_prev, k_i), cmg[i]),
                                mul(k_i, mg_next)),
                            mul(k_prev, mg_prev)),
                        inv_h);
      const T r = add(cmg[i], mul(cp[i], sub(load_f(i), kmg)));
      if (i == 0) {
        y = mul(r, bi);
      } else {
        const T a = a_row(i);
        const T d = add(cm[i], mul(mul(cp[i], add(k_prev, k_i)), inv_h));
        const T c = mul(a, bi);
        at(CP, i - 1) = c;
        bi = quot(one, sub(d, mul(a, c)));
        y = mul(sub(r, mul(a, y)), bi);
      }
      at(BI, i) = bi;
      at(U, i) = y;
      k_prev = k_i;
    }
    for (int i = n - 2; i >= 0; --i)
      at(U, i) = sub(at(U, i), mul(at(CP, i), at(U, i + 1)));

    // the loss, with the forward substitution of
    // T lambda = scale (u - u_data)
    T acc = zero, z = zero;
    for (int i = 0; i < n; ++i) {
      const T d = sub(at(U, i), obs(i));
      acc = add(acc, mul(d, d));
      const T rhs = mul(scale, d);
      z = i == 0 ? mul(rhs, at(BI, 0))
                 : mul(sub(rhs, mul(a_row(i), z)), at(BI, i));
      at(Z, i) = z;
    }
    loss[g] = acc;

    // the back substitution of lambda, with the gradient of element e
    T lam_n = at(Z, n - 1), u_n = at(U, n - 1);
    for (int e = n - 2; e >= 0; --e) {
      const T lam_e = sub(at(Z, e), mul(at(CP, e), lam_n));
      const T u_e = at(U, e);
      const T pl = sub(mul(cp[e], lam_e), mul(cp[e + 1], lam_n));
      const T w = sub(add(cmg[e], mul(cp[e], u_e)),
                      add(cmg[e + 1], mul(cp[e + 1], u_n)));
      const T ge = mul(mul(neg_inv_h, pl), w);
      if (kShared)
        KE[e * pitch + t] = ge;  // this thread's kappa column is spent
      else
        grad[g * ne + e] = ge;
      lam_n = lam_e;
      u_n = u_e;
    }
  }

  if (kShared) {
    __syncthreads();
    for (int k = t; k < nsc * ne; k += tb) {
      const int s = k / ne, e = k - s * ne;
      grad[(s0 + s) * ne + e] = KE[e * pitch + s];
    }
  }
}

// Scenarios a block holds and whether its rows fit shared memory.
struct Plan {
  int tb;
  bool shared;
};

Plan plan(int n, int block_lanes, int itemsize) {
  const int cap = block_lanes < kMaxBlock ? block_lanes : kMaxBlock;
  const long long budget = smem_optin_bytes();
  for (int tb = cap;; tb /= 2) {
    const long long bytes =
        static_cast<long long>(kStaged) * n * (tb + 1) * itemsize;
    if (bytes <= budget) return {tb, true};
    if (tb <= 32) return {cap, false};
  }
}

size_t smem_bytes(const Plan& p, int n, int itemsize) {
  return p.shared ? static_cast<size_t>(kStaged) * n * (p.tb + 1) * itemsize
                  : 0;
}

template <typename T, typename TF, typename TU>
int launch_t(const void* ke, long long sK, const void* F, long long sF,
             const void* ud, long long sU, const void* cols, void* loss,
             void* grad, void* ws, int B, int n, int block_lanes,
             double inv_h, double scale, cudaStream_t stream) {
  if (n < 2 || B < 1 || block_lanes < 1) return cudaErrorInvalidValue;
  const Plan p = plan(n, block_lanes, sizeof(T));
  if (!p.shared && ws == nullptr) return cudaErrorInvalidValue;
  const int blocks = (B + p.tb - 1) / p.tb;
  const size_t smem = smem_bytes(p, n, sizeof(T));
  auto args = [&](auto kernel) {
    return launch_with_smem(
        kernel, blocks, p.tb, smem, stream, static_cast<const T*>(ke), sK,
        static_cast<const TF*>(F), sF, static_cast<const TU*>(ud), sU,
        static_cast<const T*>(cols), static_cast<T*>(loss),
        static_cast<T*>(grad), static_cast<T*>(ws), B, n, T(inv_h),
        T(scale));
  };
  if (p.shared) return args(thomas_kernel<T, TF, TU, true>);
  return args(thomas_kernel<T, TF, TU, false>);
}

template <typename T>
int launch(const void* ke, long long sK, const void* F, long long sF,
           int f_code, const void* ud, long long sU, int u_code,
           const void* cols, void* loss, void* grad, void* ws, int B, int n,
           int block_lanes, double inv_h, double scale, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (f_code == 0 && u_code == 0)
    return launch_t<T, T, T>(ke, sK, F, sF, ud, sU, cols, loss, grad, ws, B,
                             n, block_lanes, inv_h, scale, st);
  if (f_code == 0 && u_code == 1)
    return launch_t<T, T, bf16>(ke, sK, F, sF, ud, sU, cols, loss, grad, ws,
                                B, n, block_lanes, inv_h, scale, st);
  if (f_code == 1 && u_code == 1)
    return launch_t<T, bf16, bf16>(ke, sK, F, sF, ud, sU, cols, loss, grad,
                                   ws, B, n, block_lanes, inv_h, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Elements of the global workspace a launch needs: 0 when the rows fit
// shared memory, else the four [row][scenario] arrays cp, bi, u, lambda.
extern "C" long long difffe_thomas_workspace(int B, int n, int block_lanes,
                                             int is_double) {
  if (n < 2 || B < 1 || block_lanes < 1) return 0;
  const Plan p = plan(n, block_lanes, is_double ? 8 : 4);
  if (p.shared) return 0;
  const long long blocks = (B + p.tb - 1) / p.tb;
  return 4LL * n * blocks * p.tb;
}

// One fused per-element-kappa grad step for B scenarios of n nodes: ke the
// element values (B, n - 1) rows with batch stride sK; F and u_data (B, n)
// rows with unit stride along n and batch strides sF, sU (0: shared),
// stored as the compute type (code 0) or bf16 (code 1); cols the (3, n)
// block (m, p, m g).  Writes loss (B,) and grad (B, n - 1), contiguous.
// float32, or float64 when `is_double`; `ws` the workspace when
// difffe_thomas_workspace is nonzero.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int difffe_fused_thomas(const void* ke, long long sK,
                                   const void* F, long long sF, int f_code,
                                   const void* ud, long long sU, int u_code,
                                   const void* cols, void* loss, void* grad,
                                   void* ws, int B, int n, int block_lanes,
                                   double inv_h, double scale, int is_double,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(ke, sK, F, sF, f_code, ud, sU, u_code, cols, loss,
                          grad, ws, B, n, block_lanes, inv_h, scale, s);
  return launch<float>(ke, sK, F, sF, f_code, ud, sU, u_code, cols, loss,
                       grad, ws, B, n, block_lanes, inv_h, scale, s);
}
