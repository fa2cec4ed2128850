// The masked edge-ELL operator in the batch-minor layout (kernel K8).
//
// Replaces the row gather-sum the TPU could not lower, the Pallas probe
// try_kernel of scripts/probe_mosaic_gather.py (P1: out[i,:] =
// sum_d u[idx[i,d], :], a take / take_along_axis over a VMEM array that
// Mosaic refused), and with it the per-iteration operator of the JAX
// general-mesh CG, _ell_bm_impl in difffe_tpu/ops/unstructured.py
// (m*v + p*applyK(p*v), left to XLA's gathers on the TPU).  For n nodes,
// Dn neighbour slots and B scenarios, with p = 1 - m:
//
//   y[i,b] = m_i v[i,b] + p_i ( diag[i,b] p_i v[i,b]
//                               + sum_d W[i,d,b] p_j v[j,b] ),  j = nbr[i,d]
//
// nbr (n, Dn) int32, W (n, Dn, B), diag (n, B), v (n, B), m (n,), y (n, B),
// all contiguous, float32 or float64.  Padding slots carry W = 0 at index 0
// and add nothing.  With W = 1, diag = 0 and m = 0 this is P1's function.
// Per value both bodies below do the same operations in the same order,
// the slot sum and the final masked sum each a fused multiply-add (fma),
// so they give the same bits.
//
// The batch is the minor axis, so the loads of W, diag, v and y are
// contiguous along b, and the gather v[j, :] reads whole contiguous rows
// of B: the gather that Mosaic could not lower is a plain load here.
// Nothing is staged in shared memory; the gathered rows of v (n B values,
// 4.3 MB at 64^2 nodes and B = 256 in float32) stay in the 50 MB L2.
//
// Four-scenario body (ell_apply4_kernel): a thread takes one node i and
// four adjacent scenarios b..b+3, so W[i, d, b:b+4], diag, v, the gathered
// row v[j, b:b+4] and y are 16-byte accesses (a float4, or two double2),
// and nbr[i, d] and p_j = 1 - m[j] are read once a slot for the four.
// Index arithmetic is 32-bit.  It needs B % 4 == 0, planes on 16-byte
// boundaries and fewer than 2^31 values of W and of v (ell_kernel.k8_body
// decides).
//
// Scalar body (ell_apply_kernel, the first design, with its multiply-adds
// written out): one thread per (i, b), 4-byte loads, nbr and m re-read for
// every scenario, 64-bit indices; it serves every other shape.
//
// Bound.  The function must read W, diag, v, nbr and m and write y once:
// (n Dn B + 3 n B) values plus 4 n Dn + n values of bytes, about 2 Dn + 4
// operations a value of y, so well under one operation a byte: it is bound
// by bytes.

#include "fused_step_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxVec4Values = 1LL << 31;

__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Four adjacent values at p (16-byte aligned), read through the read-only
// path, and written.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 lo = __ldg(reinterpret_cast<const double2*>(p));
  const double2 hi = __ldg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&x)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_apply_kernel(const int* __restrict__ nbr, const T* __restrict__ W,
                 const T* __restrict__ diag, const T* __restrict__ v,
                 const T* __restrict__ m, T* __restrict__ y, int n, int Dn,
                 int B) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * B) return;
  const long long i = t / B;
  const long long b = t - i * B;
  const T mi = m[i];
  const T pi = sub(T(1), mi);
  const T vi = v[t];
  T acc = mul(diag[t], mul(pi, vi));
  const int* nb = nbr + i * Dn;
  const T* w = W + i * Dn * B + b;
  for (int d = 0; d < Dn; ++d) {
    const long long j = __ldg(nb + d);
    const T pj = sub(T(1), __ldg(m + j));
    acc = madd(w[static_cast<long long>(d) * B], mul(pj, v[j * B + b]), acc);
  }
  y[t] = madd(mi, vi, mul(pi, acc));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_apply4_kernel(const int* __restrict__ nbr, const T* __restrict__ W,
                  const T* __restrict__ diag, const T* __restrict__ v,
                  const T* __restrict__ m, T* __restrict__ y, int n, int Dn,
                  int B4) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * B4) return;
  const int i = t / B4;
  const int q = t - i * B4;          // scenarios 4q .. 4q + 3
  const T mi = __ldg(m + i);
  const T pi = sub(T(1), mi);
  T vi[4], acc[4];
  load4(v + 4 * t, vi);
  load4(diag + 4 * t, acc);
#pragma unroll
  for (int s = 0; s < 4; ++s) acc[s] = mul(acc[s], mul(pi, vi[s]));
  const int* nb = nbr + i * Dn;
  const T* w = W + 4 * (i * Dn * B4 + q);
#pragma unroll 2
  for (int d = 0; d < Dn; ++d) {
    const int j = __ldg(nb + d);
    const T pj = sub(T(1), __ldg(m + j));
    T wd[4], vj[4];
    load4(w + 4 * d * B4, wd);
    load4(v + 4 * (j * B4 + q), vj);
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[s] = madd(wd[s], mul(pj, vj[s]), acc[s]);
  }
  T out[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) out[s] = madd(mi, vi[s], mul(pi, acc[s]));
  store4(y + 4 * t, out);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

template <typename T>
int launch(const void* nbr, const void* W, const void* diag, const void* v,
           const void* m, void* y, int n, int Dn, int B, int four,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * B;
  if (total == 0) return 0;
  const int* nb = static_cast<const int*>(nbr);
  const T* W_ = static_cast<const T*>(W);
  const T* d_ = static_cast<const T*>(diag);
  const T* v_ = static_cast<const T*>(v);
  const T* m_ = static_cast<const T*>(m);
  T* y_ = static_cast<T*>(y);
  if (four) {
    if (B % 4 != 0 || total * (Dn > 0 ? Dn : 1) >= kMaxVec4Values ||
        !aligned16(W) || !aligned16(diag) || !aligned16(v) || !aligned16(y))
      return cudaErrorInvalidValue;
    const int threads4 = static_cast<int>(total / 4);
    const int blocks = (threads4 + kThreads - 1) / kThreads;
    ell_apply4_kernel<T><<<blocks, kThreads, 0, stream>>>(nb, W_, d_, v_, m_,
                                                          y_, n, Dn, B / 4);
    return cudaGetLastError();
  }
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_apply_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(nb, W_, d_, v_, m_, y_, n, Dn, B);
  return cudaGetLastError();
}

}  // namespace

// y (n, B) = the masked operator above, on the four-scenario body when
// `four` is nonzero (B % 4 == 0, 16-byte-aligned W, diag, v and y, fewer
// than 2^31 values of W and of v), else on the scalar body.  float32, or
// float64 when `is_double` is nonzero.  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a shape the
// chosen body does not take.
extern "C" int difffe_ell_apply(const void* nbr, const void* W,
                                const void* diag, const void* v,
                                const void* m, void* y, int n, int Dn, int B,
                                int four, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(nbr, W, diag, v, m, y, n, Dn, B, four, s);
  return launch<float>(nbr, W, diag, v, m, y, n, Dn, B, four, s);
}
