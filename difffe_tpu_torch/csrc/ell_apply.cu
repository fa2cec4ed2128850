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
//
// Design.  One thread per (i, b), b fastest, 256 threads a block.  The
// batch is the minor axis, so a warp's loads of W, diag, v and y are
// contiguous, and the gather v[j, :] reads whole contiguous rows of B:
// the gather that Mosaic could not lower is a plain load here.  For
// B >= 32, nbr[i, d] and m[j] are the same for the whole warp (one
// broadcast load).  Nothing is staged in shared memory; the gathered rows
// of v (n * B values, 4.3 MB at 64^2 nodes and B = 256 in float32) stay
// in the 50 MB L2.  A simple kernel that is right comes first: making it
// fast (several scenarios a thread, vector loads, the CG's dots fused in)
// is later work.
//
// Bound.  The function must read W, diag, v, nbr and m and write y once:
// (n Dn B + 3 n B) values plus 4 n Dn + n values of bytes, about 2 Dn + 4
// operations a value of y, so well under one operation a byte: it is bound
// by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
  const T pi = T(1) - mi;
  const T vi = v[t];
  T acc = diag[t] * (pi * vi);
  const int* nb = nbr + i * Dn;
  const T* w = W + i * Dn * B + b;
  for (int d = 0; d < Dn; ++d) {
    const long long j = __ldg(nb + d);
    const T pj = T(1) - __ldg(m + j);
    acc += w[static_cast<long long>(d) * B] * (pj * v[j * B + b]);
  }
  y[t] = mi * vi + pi * acc;
}

template <typename T>
int launch(const void* nbr, const void* W, const void* diag, const void* v,
           const void* m, void* y, int n, int Dn, int B,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * B;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_apply_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(
      static_cast<const int*>(nbr), static_cast<const T*>(W),
      static_cast<const T*>(diag), static_cast<const T*>(v),
      static_cast<const T*>(m), static_cast<T*>(y), n, Dn, B);
  return cudaGetLastError();
}

}  // namespace

// y (n, B) = the masked operator above.  float32, or float64 when
// `is_double` is nonzero.  Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int difffe_ell_apply(const void* nbr, const void* W,
                                const void* diag, const void* v,
                                const void* m, void* y, int n, int Dn, int B,
                                int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(nbr, W, diag, v, m, y, n, Dn, B, s);
  return launch<float>(nbr, W, diag, v, m, y, n, Dn, B, s);
}
