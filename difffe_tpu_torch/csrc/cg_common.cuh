// The whole-CG body shared by the structured-grid kernels K3 (2D,
// stencil_cg.cu) and K4 (3D, stencil3d_cg.cu).
//
// Per scenario b (one thread block), with the BC-folded stencil operator A
// and the Jacobi preconditioner Minv supplied by an operator type `Op`:
//
//   r = rhs - A x0;  z = Minv r;  p = z;  rz = <r, z>
//   floor = (4 eps)^2 * max(rz, 1e-30)
//   iters times, live = rz > floor:
//     alpha = live && pAp != 0 ? rz / pAp : 0
//     x += alpha p;  r -= alpha Ap;  z = Minv r
//     beta = live && rz' > floor && rz != 0 ? rz' / rz : 0;  p = z + beta p
//
// The two-solve form (K3b, K4b) solves A x = b from x0, writes x, forms
// gbar = scale * (x - u_data) and solves A lam = gbar from lam0.
//
// `Op` walks this thread's nodes with a cursor that carries the node's grid
// coordinates (advanced without division) and provides:
//   int n;                                   nodes per scenario
//   Cursor first() const;  void next(Cursor&) const;   (Cursor has int i)
//   float apply(const Cursor&, const float* v) const;  (A v) at the node
//   float minv(int i) const;                            Minv at node i
//
// Each dot is a warp-shuffle butterfly plus a fixed-order sum of the warp
// partials in shared memory: no atomics, so a run repeats bit for bit, and
// every thread takes the same freeze decision.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kVecs = 4;  // x, r, p, Ap

// Sum over the block in a fixed order; every thread gets the total.
// `red` is one of two 32-float buffers, used alternately, so the write of
// one reduction never races the reads of the previous one.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

// One fixed-trip PCG solve.  On entry x holds x0 and r holds the right-hand
// side, both complete (the caller synchronized); on exit x holds the
// solution.
template <class Op>
__device__ void cg_solve(const Op& op, float* x, float* r, float* p,
                         float* ap, int iters, float (*red)[32], int& rb) {
  float part = 0.f;
  for (auto c = op.first(); c.i < op.n; op.next(c)) {
    const int i = c.i;
    const float ri = r[i] - op.apply(c, x);
    const float zi = op.minv(i) * ri;
    r[i] = ri;
    p[i] = zi;
    part += ri * zi;
  }
  float rz = block_sum(part, red[rb]);
  rb ^= 1;
  const float eps4 = 4.f * FLT_EPSILON;
  const float floor_ = eps4 * eps4 * fmaxf(rz, 1e-30f);

  for (int it = 0; it < iters; ++it) {
    const bool live = rz > floor_;
    part = 0.f;
    for (auto c = op.first(); c.i < op.n; op.next(c)) {
      const float a = op.apply(c, p);
      ap[c.i] = a;
      part += p[c.i] * a;
    }
    const float pap = block_sum(part, red[rb]);
    rb ^= 1;
    const float alpha = (live && pap != 0.f) ? rz / pap : 0.f;
    part = 0.f;
    for (int i = threadIdx.x; i < op.n; i += blockDim.x) {
      x[i] += alpha * p[i];
      const float ri = r[i] - alpha * ap[i];
      r[i] = ri;
      part += ri * (op.minv(i) * ri);
    }
    const float rz_new = block_sum(part, red[rb]);
    rb ^= 1;
    const float beta =
        (live && rz_new > floor_ && rz != 0.f) ? rz_new / rz : 0.f;
    for (int i = threadIdx.x; i < op.n; i += blockDim.x)
      p[i] = op.minv(i) * r[i] + beta * p[i];
    __syncthreads();  // p complete before the next stencil apply reads it
    rz = rz_new;
  }
}

// One thread block's work: one scenario's solve (or two).  Every plane
// pointer is already offset to this scenario; `vecs` holds 4 * op.n floats
// (shared memory or this scenario's slice of the workspace).
template <bool TWO_SOLVES, class Op>
__device__ void cg_block(const Op& op, const float* __restrict__ b,
                         const float* __restrict__ x0,
                         const float* __restrict__ lam0,
                         const float* __restrict__ ud,
                         float* __restrict__ x_out,
                         float* __restrict__ lam_out, float* vecs, int iters,
                         float scale) {
  __shared__ float red[2][32];
  int rb = 0;
  const int n = op.n;
  float *x = vecs, *r = vecs + n, *p = vecs + 2 * n, *ap = vecs + 3 * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = x0[i];
    r[i] = b[i];
  }
  __syncthreads();
  cg_solve(op, x, r, p, ap, iters, red, rb);

  if constexpr (TWO_SOLVES) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float xi = x[i];
      x_out[i] = xi;
      r[i] = scale * (xi - ud[i]);
      x[i] = lam0[i];
    }
    __syncthreads();
    cg_solve(op, x, r, p, ap, iters, red, rb);
    for (int i = threadIdx.x; i < n; i += blockDim.x) lam_out[i] = x[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) x_out[i] = x[i];
  }
}

// Floats of dynamic shared memory a block may take on the current device,
// beside cg_block's two static 32-float reduction buffers.
int smem_optin_floats() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (bytes - static_cast<int>(sizeof(float) * 2 * 32)) /
         static_cast<int>(sizeof(float));
}

}  // namespace
