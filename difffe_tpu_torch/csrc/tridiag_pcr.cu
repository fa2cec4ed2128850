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
// Two routes (the wrapper's k2_plan picks one; both give the same bits).
// On an H100 at n = 129 the warp route leads from B = 2048 systems on (1.37x
// at 65 536) and trails below: with fewer than ~16 warps an SM its five
// slots a lane are latency-bound, where the block route has a thread a row.
//
// Warp route (pcr_warp_kernel, n <= kWarpMaxRows = 256): one warp a
// scenario, no shared memory and no block barrier.  The rows sit in
// registers, striped: row j in lane j % 32, slot j / 32 (K = ceil(n / 32)
// slots, a template parameter).  A sweep's shift by s < 32 is one
// __shfl_sync a value and slot, the row across the lane boundary taking
// the neighbour's previous (or next) slot; a shift by a multiple of 32 is
// a register move.  Slots are updated in place, in an order that keeps
// each neighbour's old value at hand (one slot of shuffled values rolled
// along for s < 32, a chain k, k + s/32, ... for s >= 32).  A neighbour
// past the ends reads the fill values (b = 1, a = c = r = 0), so rows
// j >= n never reach a row below n.  The sweeps at s = 1..16 are one loop
// with s a run-time value (one copy of the code, for the instruction
// cache); s = 32, 64 and 128 are compile-time slot moves.  Each scenario's
// rows are read coalesced, 32 consecutive values a slot.
//
// Block route (pcr_kernel, the first design; n up to 8192): a thread block
// holds `spb` whole scenarios, spb * n rows, in shared memory: four arrays
// a, b, c, r of spb * n values.  Each thread owns R rows (j = threadIdx.x +
// k * blockDim.x) and keeps their a, b, c, r in registers across the
// sweeps; the shared arrays mirror them for the neighbours' reads.  A
// sweep reads eight neighbour values from shared memory, updates the
// registers, and after a barrier writes them back.  The TPU padded n to 8
// or 128 and B to its block, and masked its circular rolls with `where`;
// here nothing is padded: a row's neighbours are guarded by its index i in
// its scenario, so Dirichlet rows (b = 1, a = c = 0) and the ends decouple
// exactly.  `layout` and `block_b` only set spb, the launch shape
// (ops/kernels/tridiag_kernel.py).  One block holds at most 8192 rows (R <=
// 8 with 1024 threads) and 4 * rows values must fit its shared memory:
// n <= 8192 in float32 and n <= 7264 in float64 on an H100.
//
// Both read the (B, n) bands straight, each band with its own batch stride
// (0 for a band shared by every scenario); offsets are 64-bit.
//
// Bound.  The function must read d, e, F and write u once: (4n - 1) B
// values.  PCR does ~16 operations per row and sweep, ceil(log2 n) sweeps,
// so at n = 129 (8 sweeps) float32 it does ~0.13 operations per byte,
// far below the card's balance point: the function is bound by bytes.  This
// kernel moves each of those bytes once, but every sweep also reads eight
// and writes four shared-memory values per row, which at n = 129 is ~25x the
// device-memory traffic, so in practice the block route is bound by shared
// memory and its barriers.  The warp route moves the eight neighbour values
// by shuffles (no stores, no barriers, no addresses): its cost is the
// shuffles, the selects at the slot boundaries and the IEEE divisions.

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

constexpr int kWarpMaxRows = 256;
constexpr int kWarpThreads = 128;   // 4 scenarios a block
constexpr unsigned kFull = 0xffffffffu;

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
// in the plain version's order, each operation rounded on its own.
template <typename T>
__device__ __forceinline__ Row<T> pcr_update(const Row<T>& x,
                                             const Row<T>& up,
                                             const Row<T>& dn) {
  const T alpha = quot(-x.a, up.b);
  const T gamma = quot(-x.c, dn.b);
  return Row<T>{mul(alpha, up.a), add(add(x.b, mul(alpha, up.c)),
                                      mul(gamma, dn.a)),
                mul(gamma, dn.c),
                add(add(x.r, mul(alpha, up.r)), mul(gamma, dn.r))};
}

// One sweep at a stride s < 32 over the K slots of a warp's scenario: the
// neighbours are shuffles, the rows across the lane boundary the
// neighbour slot's.  s is a run-time value, so one copy of this code
// serves the first five sweeps (the code stays small for the instruction
// cache).
template <typename T, int K>
__device__ __forceinline__ void warp_sweep_shfl(Row<T> (&x)[K], int lane,
                                                int n, int s) {
  const int src_up = (lane - s) & 31, src_dn = (lane + s) & 31;
  const bool wrap_up = lane < s, wrap_dn = lane + s >= 32;
  // t_prev: slot k-1 shuffled up (old values); d_cur, d_next: slots k and
  // k+1 shuffled down (old values)
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
    x[k] = pcr_update(x[k], up, dn);
    t_prev = t_cur;
    d_cur = d_next;
  }
}

// One sweep at the stride S = 32 M: the neighbours are slots k -+ M of the
// same lane, updated in place along each chain k0, k0 + M, ... with the
// previous slot's old value kept.
template <typename T, int K, int M>
__device__ __forceinline__ void warp_sweep_slots(Row<T> (&x)[K], int lane,
                                                 int n) {
#pragma unroll
  for (int k0 = 0; k0 < M && k0 < K; ++k0) {
    Row<T> prev = fill_row<T>();   // old value of slot k - M
#pragma unroll
    for (int k = k0; k < K; k += M) {
      const Row<T> old = x[k];
      Row<T> dn = k + M < K ? x[k + M] : fill_row<T>();
      if (32 * (k + M) + lane >= n) dn = fill_row<T>();
      x[k] = pcr_update(old, prev, dn);
      prev = old;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kWarpThreads)
pcr_warp_kernel(const T* __restrict__ d, long long sd,
                const T* __restrict__ e, long long se,
                const T* __restrict__ F, long long sF, T* __restrict__ u,
                int B, int n, int steps) {
  const int lane = threadIdx.x & 31;
  const long long sc = static_cast<long long>(blockIdx.x) *
                           (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (sc >= B) return;   // the whole warp: shuffles stay within live warps
  const T* dr = d + sc * sd;
  const T* er = e + sc * se;
  const T* Fr = F + sc * sF;
  Row<T> x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    x[k] = fill_row<T>();
    if (i < n) {
      x[k].b = dr[i];
      x[k].r = Fr[i];
      if (i > 0) x[k].a = er[i - 1];
      if (i < n - 1) x[k].c = er[i];
    }
  }
  // ceil(log2 n) sweeps: strides 1..16 by shuffles in one loop, then 32,
  // 64 and 128 (where K has them) by slot moves
  const int shfl_steps = steps < 5 ? steps : 5;
#pragma unroll 1
  for (int st = 0; st < shfl_steps; ++st)
    warp_sweep_shfl<T, K>(x, lane, n, 1 << st);
  if constexpr (K > 1) {
    if (steps > 5) warp_sweep_slots<T, K, 1>(x, lane, n);
  }
  if constexpr (K > 2) {
    if (steps > 6) warp_sweep_slots<T, K, 2>(x, lane, n);
  }
  if constexpr (K > 4) {
    if (steps > 7) warp_sweep_slots<T, K, 4>(x, lane, n);
  }
  T* ur = u + sc * n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    if (i < n) ur[i] = quot(x[k].r, x[k].b);
  }
}

template <typename T, int K>
int launch_warp_k(const void* d, long long sd, const void* e, long long se,
                  const void* F, long long sF, void* u, int B, int n,
                  int steps, cudaStream_t stream) {
  constexpr int per_block = kWarpThreads / 32;
  const int blocks = (B + per_block - 1) / per_block;
  pcr_warp_kernel<T, K><<<blocks, kWarpThreads, 0, stream>>>(
      static_cast<const T*>(d), sd, static_cast<const T*>(e), se,
      static_cast<const T*>(F), sF, static_cast<T*>(u), B, n, steps);
  return cudaGetLastError();
}

template <typename T>
int launch_warp(const void* d, long long sd, const void* e, long long se,
                const void* F, long long sF, void* u, int B, int n,
                cudaStream_t stream) {
  if (n < 1 || n > kWarpMaxRows || B < 1) return cudaErrorInvalidValue;
  int steps = 0;
  while ((1 << steps) < n) ++steps;
  switch ((n + 31) / 32) {
#define DIFFFE_K(k)                                                        \
  case k:                                                                  \
    return launch_warp_k<T, k>(d, sd, e, se, F, sF, u, B, n, steps, stream);
    DIFFFE_K(1)
    DIFFFE_K(2)
    DIFFFE_K(3)
    DIFFFE_K(4)
    DIFFFE_K(5)
    DIFFFE_K(6)
    DIFFFE_K(7)
    DIFFFE_K(8)
#undef DIFFFE_K
    default:
      return cudaErrorInvalidValue;
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

// The warp route: u (B, n) = T^-1 F as difffe_tridiag_pcr below, one warp a
// scenario, for 1 <= n <= kWarpMaxRows (256; the wrapper's
// WARP_MAX_ROWS).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an n
// it does not take.
extern "C" int difffe_tridiag_pcr_warp(const void* d, long long sd,
                                       const void* e, long long se,
                                       const void* F, long long sF, void* u,
                                       int B, int n, int is_double,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_warp<double>(d, sd, e, se, F, sF, u, B, n, s);
  return launch_warp<float>(d, sd, e, se, F, sF, u, B, n, s);
}

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
