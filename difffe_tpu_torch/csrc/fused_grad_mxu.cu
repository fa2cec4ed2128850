// The scalar-kappa 1D grad step as dense products with W = A~^-1 (kernel
// K7).
//
// Replaces the Pallas TPU kernel of
// difffe_tpu/ops/pallas/fused_grad_mxu_kernel.py: the bodies _mxu_body,
// _mxu_body_v2 and _mxu_body_v3 behind _mxu_pallas.  Per scenario, with
// kappa = exp(log kappa), the (8, n) unit-kappa block (m, p, d0, a0, c0,
// mg, t0, rhs0) and W the inverse of the unit-kappa eliminated system:
//
//   version 1: x = (m + p / kappa)((mg + p F) - kappa t0);  u = W x
//              lambda = W ((m + p / kappa)(u - u_data))
//              dlog kappa = (scale kappa) * -sum_i lambda_i (t0 + a0 u_{i-1}
//                                                + d0 u_i + c0 u_{i+1})
//   version 2: x = rhs0 + (1 / kappa) p F;  u = W x;  lambda as above;
//              dlog kappa = -scale * sum_i lambda_i p_i F_i
//   version 3: version 2, each solve followed by `refine` passes
//              u += W (y - T1 u),  T1 u = (m + d0) u + a0 u_{i-1} + c0 u_{i+1},
//              the residual y - T1 u formed in double and rounded once
//   loss = sum_i (u - u_data)_i^2
//
// The elementwise work is the plain PyTorch version's
// (difffe_tpu_torch/ops/kernels/fused_grad_mxu_kernel.py), each operation
// in its order and rounded on its own; each product with W is a running
// sum of fused multiply-adds in column order, full float32 (or float64):
// the TPU's DEFAULT/HIGHEST matrix-unit precision has no counterpart.
//
// Design.  The TPU ran the products on its matrix unit over (N, lanes)
// planes.  Here one thread owns one scenario: a block of `tb` scenarios
// stages W (n^2 values, 3.8 KB at n = 31 in float32, 74 KB at n = 136)
// and its tiles of u_data and F, read as the caller holds them, (B, n)
// row-major, with coalesced loads, into shared memory transposed to
// [row][thread] (pitch tb + 1: no bank conflicts); a shared F (batch
// stride 0) is read in place.  The x, u and residual rows sit beside them
// in the same layout.  Each product then reads W[i][j], the same address
// for every thread (a broadcast), and x[j] of its own column.  tb is the
// largest power of two up to 128 whose arrays fit the block's shared
// memory.
//
// Bound: the step must read log kappa, u_data and a streamed F and write
// the loss and gradient: (2n + 3) values a scenario, 260 B at n = 31 in
// float32.  It does 2 n^2 multiply-adds a product, two products (v1, v2)
// or 2 (1 + refine) (v3), ~4.2 k operations a scenario at n = 31 for v2:
// ~16 operations per byte, below the card's float32 balance point (~20),
// so bytes bound v2 and operations bound v3 with bf16 storage.  In practice
// the two shared-memory loads of each multiply-add set the pace; tensor
// core products (TF32 mma) with v3's refinement are the natural redesign.

#include "fused_step_common.cuh"

namespace {

constexpr int kMaxBlock = 128;
constexpr int kRows = 5;  // u_data, F, x, u, residual rows per thread

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
template <typename T>
__device__ __forceinline__ double wide(T x) {
  return static_cast<double>(x);
}

template <typename T, typename TF, typename TU>
__global__ void __launch_bounds__(kMaxBlock)
mxu_kernel(const T* __restrict__ lk, long long sL, const TF* __restrict__ F,
           long long sF, const TU* __restrict__ ud, long long sU,
           const T* __restrict__ cols, const T* __restrict__ Wg,
           T* __restrict__ loss, T* __restrict__ grad, int B, int n,
           int version, int refine, T scale) {
  extern __shared__ unsigned char smem_raw[];
  const int tb = blockDim.x, t = threadIdx.x, P = tb + 1;
  const long long s0 = static_cast<long long>(blockIdx.x) * tb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < tb ? static_cast<int>(left) : tb;
  const long long g = s0 + t;
  T* W = reinterpret_cast<T*>(smem_raw);
  T* UD = W + n * n;
  T* FT = UD + n * P;
  T* X = FT + n * P;
  T* U = X + n * P;
  T* R = U + n * P;

  for (int k = t; k < n * n; k += tb) W[k] = Wg[k];
  for (int k = t; k < nsc * n; k += tb) {
    const int s = k / n, i = k - s * n;
    UD[i * P + s] = load<T>(ud, (s0 + s) * sU + i);
    if (sF != 0) FT[i * P + s] = load<T>(F, (s0 + s) * sF + i);
  }
  __syncthreads();
  if (t >= nsc) return;

  const T zero = T(0), one = T(1);
  const T *cm = cols, *cp = cols + n, *cd0 = cols + 2 * n,
          *ca0 = cols + 3 * n, *cc0 = cols + 4 * n, *cmg = cols + 5 * n,
          *ct0 = cols + 6 * n, *crhs0 = cols + 7 * n;
  auto f = [&](int i) -> T {
    return sF == 0 ? load<T>(F, i) : FT[i * P + t];
  };
  // (W v)_i, a running fused multiply-add over the columns
  auto wrow = [&](int i, const T* v) -> T {
    const T* w = W + i * n;
    T acc = zero;
    for (int j = 0; j < n; ++j) acc = fmadd(w[j], v[j * P + t], acc);
    return acc;
  };
  auto nb = [&](const T* v, int i) -> T {  // v_i, 0 outside the rows
    return i < 0 || i >= n ? zero : v[i * P + t];
  };
  // out = W y, then `passes` residual refinements (v3)
  auto solve = [&](const T* y, T* out, int passes) {
    for (int i = 0; i < n; ++i) out[i * P + t] = wrow(i, y);
    for (int it = 0; it < passes; ++it) {
      for (int i = 0; i < n; ++i) {
        const double t1 = add(
            add(mul(wide(add(cm[i], cd0[i])), wide(out[i * P + t])),
                mul(wide(ca0[i]), wide(nb(out, i - 1)))),
            mul(wide(cc0[i]), wide(nb(out, i + 1))));
        R[i * P + t] = static_cast<T>(sub(wide(y[i * P + t]), t1));
      }
      for (int i = 0; i < n; ++i)
        out[i * P + t] = add(out[i * P + t], wrow(i, R));
    }
  };

  const T kappa = expo(lk[g * sL]);
  const T kinv = quot(one, kappa);
  for (int i = 0; i < n; ++i) {
    if (version == 1) {
      const T r = sub(add(cmg[i], mul(cp[i], f(i))), mul(kappa, ct0[i]));
      X[i * P + t] = mul(add(cm[i], mul(cp[i], kinv)), r);
    } else {
      X[i * P + t] = add(crhs0[i], mul(kinv, mul(cp[i], f(i))));
    }
  }
  const int passes = version == 3 ? refine : 0;
  solve(X, U, passes);
  T acc = zero;
  for (int i = 0; i < n; ++i) {
    const T d = sub(U[i * P + t], UD[i * P + t]);
    acc = add(acc, mul(d, d));
    X[i * P + t] = mul(add(cm[i], mul(cp[i], kinv)), d);
  }
  loss[g] = acc;

  T gacc = zero;
  if (version == 1) {
    // lambda row by row against the four-term contraction of u
    for (int i = 0; i < n; ++i) {
      const T term = add(add(add(ct0[i], mul(ca0[i], nb(U, i - 1))),
                             mul(cd0[i], U[i * P + t])),
                         mul(cc0[i], nb(U, i + 1)));
      gacc = add(gacc, mul(wrow(i, X), term));
    }
    grad[g] = mul(mul(scale, kappa), -gacc);
    return;
  }
  solve(X, U, passes);  // lambda
  for (int i = 0; i < n; ++i)
    gacc = add(gacc, mul(U[i * P + t], mul(cp[i], f(i))));
  grad[g] = mul(-scale, gacc);
}

size_t smem_bytes(int n, int tb, int itemsize) {
  const size_t w = static_cast<size_t>(n) * n;
  return static_cast<size_t>(itemsize) *
         (w + static_cast<size_t>(kRows) * n * (tb + 1));
}

template <typename T, typename TF, typename TU>
int launch_t(const void* lk, long long sL, const void* F, long long sF,
             const void* ud, long long sU, const void* cols, const void* W,
             void* loss, void* grad, int B, int n, int block_lanes,
             int version, int refine, double scale, cudaStream_t stream) {
  if (n < 1 || B < 1 || block_lanes < 1 || version < 1 || version > 3 ||
      refine < 0)
    return cudaErrorInvalidValue;
  const size_t cap = static_cast<size_t>(smem_optin_bytes());
  int tb = block_lanes < kMaxBlock ? block_lanes : kMaxBlock;
  while (tb > 1 && smem_bytes(n, tb, sizeof(T)) > cap) tb /= 2;
  const size_t smem = smem_bytes(n, tb, sizeof(T));
  if (smem > cap) return cudaErrorInvalidValue;
  const int blocks = (B + tb - 1) / tb;
  return launch_with_smem(
      mxu_kernel<T, TF, TU>, blocks, tb, smem, stream,
      static_cast<const T*>(lk), sL, static_cast<const TF*>(F), sF,
      static_cast<const TU*>(ud), sU, static_cast<const T*>(cols),
      static_cast<const T*>(W), static_cast<T*>(loss), static_cast<T*>(grad),
      B, n, version, refine, T(scale));
}

template <typename T>
int launch(const void* lk, long long sL, const void* F, long long sF,
           int f_code, const void* ud, long long sU, int u_code,
           const void* cols, const void* W, void* loss, void* grad, int B,
           int n, int block_lanes, int version, int refine, double scale,
           cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (f_code == 0 && u_code == 0)
    return launch_t<T, T, T>(lk, sL, F, sF, ud, sU, cols, W, loss, grad, B,
                             n, block_lanes, version, refine, scale, st);
  if (f_code == 0 && u_code == 1)
    return launch_t<T, T, bf16>(lk, sL, F, sF, ud, sU, cols, W, loss, grad,
                                B, n, block_lanes, version, refine, scale,
                                st);
  if (f_code == 1 && u_code == 1)
    return launch_t<T, bf16, bf16>(lk, sL, F, sF, ud, sU, cols, W, loss,
                                   grad, B, n, block_lanes, version, refine,
                                   scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One fused scalar-kappa grad step for B scenarios of n nodes: lk the log
// kappa (B,) with stride sL; F and u_data (B, n) rows with unit stride
// along n and batch strides sF, sU (0: shared), stored as the compute type
// (code 0) or bf16 (code 1); cols the (8, n) unit-kappa block; W (n, n)
// row-major.  Writes loss (B,) and grad (B,).  float32, or float64 when
// `is_double`.  `block_lanes` caps the scenarios a block holds.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int difffe_fused_mxu(const void* lk, long long sL, const void* F,
                                long long sF, int f_code, const void* ud,
                                long long sU, int u_code, const void* cols,
                                const void* W, void* loss, void* grad, int B,
                                int n, int block_lanes, int version,
                                int refine, double scale, int is_double,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(lk, sL, F, sF, f_code, ud, sU, u_code, cols, W,
                          loss, grad, B, n, block_lanes, version, refine,
                          scale, s);
  return launch<float>(lk, sL, F, sF, f_code, ud, sU, u_code, cols, W, loss,
                       grad, B, n, block_lanes, version, refine, scale, s);
}
