// Batched symmetric tridiagonal solve by parallel cyclic reduction (kernel
// K2).
//
// Replaces the Pallas TPU kernels of
// difffe_tpu/ops/pallas/tridiag_kernel.py: _pcr_block_kernel behind
// _pcr_pallas_padded (K2a, batch layout) and _pcr_block_kernel_T behind
// _pcr_pallas_T (K2b, transposed layout).  Both compute u = T^-1 F for B
// independent systems a_i u_{i-1} + b_i u_i + c_i u_{i+1} = r_i with
// a_i = e_{i-1}, b_i = d_i, c_i = e_i, by ceil(log2 n) PCR sweeps
//
//   alpha = -a_i / b_{i-s},  gamma = -c_i / b_{i+s}
//   a_i' = alpha a_{i-s},  c_i' = gamma c_{i+s}
//   b_i' = b_i + alpha c_{i-s} + gamma a_{i+s}
//   r_i' = r_i + alpha r_{i-s} + gamma r_{i+s}
//
// (neighbours outside 0..n-1 read b = 1 and a = c = r = 0), then u = r / b:
// the same arithmetic, in the same order, as the plain PyTorch version in
// difffe_tpu_torch/ops/tridiag.py, with every product, sum and quotient
// rounded on its own (the _rn intrinsics: no fused multiply-add), as
// PyTorch's elementwise ops round them.  So the kernel gives the plain
// version's bits; a contracted form differed from it by ~3x the plain f32
// error on the ill-conditioned FEM bands at n = 257.
//
// Design.  A thread block holds `spb` whole scenarios, spb * n rows, in
// shared memory: four arrays a, b, c, r of spb * n values.  Each thread owns
// R rows (j = threadIdx.x + k * blockDim.x) and keeps their a, b, c, r in
// registers across the sweeps; the shared arrays mirror them for the
// neighbours' reads.  A sweep reads eight neighbour values from shared
// memory, updates the registers, and after a barrier writes them back.  The
// TPU padded n to 8 or 128 and B to its block, and masked its circular rolls
// with `where`; here nothing is padded: a row's neighbours are guarded by
// its index i in its scenario, so Dirichlet rows (b = 1, a = c = 0) and the
// ends decouple exactly.  Rows are read straight from the (B, n) bands,
// each band with its own batch stride (0 for a band shared by every
// scenario), so a block's loads are contiguous along its rows; offsets are
// 64-bit.  One kernel serves both TPU layouts: `layout` and `block_b` only
// set spb, the launch shape (ops/kernels/tridiag_kernel.py).  One block
// holds at most 8192 rows (R <= 8 with 1024 threads) and 4 * rows values
// must fit its shared memory: n <= 8192 in float32 and n <= 7264 in float64
// on an H100.
//
// Bound.  The function must read d, e, F and write u once: (4n - 1) B
// values.  PCR does ~16 operations per row and sweep, ceil(log2 n) sweeps,
// so at n = 129 (8 sweeps) float32 it does ~0.13 operations per byte,
// far below the card's balance point: the function is bound by bytes.  This
// kernel moves each of those bytes once, but every sweep also reads eight
// and writes four shared-memory values per row, which at n = 129 is ~25x the
// device-memory traffic, so in practice it is bound by shared memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxR = 8;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float quot(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double quot(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
pcr_kernel(const T* __restrict__ d, long long sd, const T* __restrict__ e,
           long long se, const T* __restrict__ F, long long sF,
           T* __restrict__ u, int B, int n, int spb, int steps) {
  extern __shared__ unsigned char smem_raw[];
  const int rows = spb * n;
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + rows;
  T* sc = sb + rows;
  T* sr = sc + rows;
  const long long s0 = static_cast<long long>(blockIdx.x) * spb;
  const long long left = static_cast<long long>(B) - s0;
  const int live = (left < spb ? static_cast<int>(left) : spb) * n;

  T a[R], b[R], c[R], r[R];
  int row[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    row[k] = 0;
    a[k] = c[k] = r[k] = T(0);
    b[k] = T(1);
    if (j < live) {
      const int s = j / n;
      const int i = j - s * n;
      const long long sc_ = s0 + s;
      row[k] = i;
      b[k] = d[sc_ * sd + i];
      r[k] = F[sc_ * sF + i];
      if (i > 0) a[k] = e[sc_ * se + i - 1];
      if (i < n - 1) c[k] = e[sc_ * se + i];
      sa[j] = a[k];
      sb[j] = b[k];
      sc[j] = c[k];
      sr[j] = r[k];
    }
  }
  __syncthreads();

  for (int st = 0, s = 1; st < steps; ++st, s <<= 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < live) {
        const int i = row[k];
        T b_up = T(1), a_up = T(0), c_up = T(0), r_up = T(0);
        T b_dn = T(1), a_dn = T(0), c_dn = T(0), r_dn = T(0);
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
        a[k] = mul(alpha, a_up);
        c[k] = mul(gamma, c_dn);
        b[k] = add(add(b[k], mul(alpha, c_up)), mul(gamma, a_dn));
        r[k] = add(add(r[k], mul(alpha, r_up)), mul(gamma, r_dn));
      }
    }
    if (st + 1 == steps) break;  // the last sweep's values stay in registers
    __syncthreads();             // every read of this sweep is done
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

#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < live) {
      const int s = j / n;
      u[(s0 + s) * n + row[k]] = quot(r[k], b[k]);
    }
  }
}

int optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename T, int R>
int launch_r(const void* d, long long sd, const void* e, long long se,
             const void* F, long long sF, void* u, int B, int n, int spb,
             int steps, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pcr_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (B + spb - 1) / spb;
  pcr_kernel<T, R><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(d), sd, static_cast<const T*>(e), se,
      static_cast<const T*>(F), sF, static_cast<T*>(u), B, n, spb, steps);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* d, long long sd, const void* e, long long se,
           const void* F, long long sF, void* u, int B, int n, int spb,
           cudaStream_t stream) {
  const long long rows = static_cast<long long>(spb) * n;
  const size_t smem = 4 * sizeof(T) * static_cast<size_t>(rows);
  if (n < 1 || spb < 1 || rows > static_cast<long long>(kMaxR) * kThreads ||
      smem > static_cast<size_t>(optin_bytes()))
    return cudaErrorInvalidValue;
  int steps = 0;
  while ((1LL << steps) < n) ++steps;
  int R = 1;
  while (R * kThreads < rows) R <<= 1;
  const int per = static_cast<int>((rows + R - 1) / R);
  const int threads = ((per + 31) / 32) * 32;
  switch (R) {
    case 1:
      return launch_r<T, 1>(d, sd, e, se, F, sF, u, B, n, spb, steps,
                            threads, smem, stream);
    case 2:
      return launch_r<T, 2>(d, sd, e, se, F, sF, u, B, n, spb, steps,
                            threads, smem, stream);
    case 4:
      return launch_r<T, 4>(d, sd, e, se, F, sF, u, B, n, spb, steps,
                            threads, smem, stream);
    default:
      return launch_r<T, kMaxR>(d, sd, e, se, F, sF, u, B, n, spb, steps,
                                threads, smem, stream);
  }
}

}  // namespace

// The most rows (spb * n) one block can hold for values of `itemsize`
// bytes (4 or 8): 0 when the device cannot be queried.
extern "C" int difffe_tridiag_pcr_max_rows(int itemsize) {
  const long long by_smem = optin_bytes() / (4LL * itemsize);
  const long long by_threads = static_cast<long long>(kMaxR) * kThreads;
  return static_cast<int>(by_smem < by_threads ? by_smem : by_threads);
}

// u (B, n), contiguous, = T^-1 F for the bands d (B, n), e (B, n-1) and
// F (B, n), each row-major with unit stride along n and its own batch
// stride (sd, se, sF: elements between scenarios, 0 for a band shared by
// all).  float32, or float64 when `is_double` is nonzero.  `spb` scenarios
// share a block.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue when spb * n rows do not fit a block.
extern "C" int difffe_tridiag_pcr(const void* d, long long sd, const void* e,
                                  long long se, const void* F, long long sF,
                                  void* u, int B, int n, int spb,
                                  int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(d, sd, e, se, F, sF, u, B, n, spb, s);
  return launch<float>(d, sd, e, se, F, sF, u, B, n, spb, s);
}
