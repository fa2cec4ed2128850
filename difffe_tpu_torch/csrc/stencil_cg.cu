// Whole-CG Jacobi-PCG on structured 2D grids (kernels K3a and K3b).
//
// Replaces the Pallas TPU kernels of
// difffe_tpu/ops/pallas/stencil_cg_kernel.py: _cg_kernel / _cg_kernel_tb
// behind _cg_pallas (K3a, one fixed-trip solve) and _cg2_kernel_tb behind
// _cg2_pallas (K3b, forward solve, MSE cotangent, adjoint solve).  Per
// scenario b, on the BC-folded 5-point planes D0..D4 of an (H, W) node grid
// with A v = sum_k D_k * shift(v, OFFSETS[k]):
//
//   r = rhs - A x0;  z = Minv r;  p = z;  rz = <r, z>
//   floor = (4 eps)^2 * max(rz, 1e-30)
//   iters times, live = rz > floor:
//     alpha = live && pAp != 0 ? rz / pAp : 0
//     x += alpha p;  r -= alpha Ap;  z = Minv r
//     beta = live && rz' > floor && rz != 0 ? rz' / rz : 0;  p = z + beta p
//
// K3b solves A x = b from x0, writes x, forms gbar = scale * (x - u_data)
// and solves A lam = gbar from lam0, writing lam.
//
// Design.  One thread block per scenario; its threads stride over the H*W
// nodes, so every plane read is coalesced along a row.  The CG vectors x,
// r, p and Ap live in dynamic shared memory when 4*H*W floats fit the
// block's opt-in limit (H*W <= 14,500 nodes: the 64^2 grid of the main
// path, 16.5 KB a plane), else in a global workspace of 4*H*W floats per
// scenario that the wrapper allocates.  The coefficient planes and Minv are
// read from device memory (through L1/L2) in every iteration.  Each dot is
// a warp-shuffle butterfly plus a fixed-order sum of the warp partials in
// shared memory: no atomics, so a run repeats bit for bit.  Neighbour reads
// are guarded at the grid's edges (no reliance on zero coefficients) and
// plane offsets are 64-bit.
//
// Bound.  At the main path's workload (64^2 grid, B = 4096, 32 iterations,
// two solves) the work is ~20 flop per node per iteration, 2.2e10 flop =
// 0.33 ms at 67 TFLOP/s fp32, against 0.83 GB of inputs and outputs
// (0.25 ms at 3.35 TB/s): the function is bound by operations.  This first
// design re-reads the 5 planes and Minv (24 B a node) from L2 or device
// memory in every iteration, so it is bound in practice by that traffic;
// keeping them on the chip (registers or shared memory) is later work.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kVecs = 4;  // x, r, p, Ap

struct Grid {
  int H, W, n;           // n = H * W
  int step_r, step_c;    // a thread's stride over nodes, as (rows, cols)
  size_t plane_stride;   // B * H * W: distance between two D planes
};

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

// (A v)_i at node i = (row, col), with guarded neighbour reads.
__device__ __forceinline__ float apply_at(const float* __restrict__ D,
                                          const Grid& g, int i, int row,
                                          int col, const float* v) {
  float out = __ldg(D + i) * v[i];
  if (col + 1 < g.W) out += __ldg(D + g.plane_stride + i) * v[i + 1];
  if (col > 0) out += __ldg(D + 2 * g.plane_stride + i) * v[i - 1];
  if (row + 1 < g.H) out += __ldg(D + 3 * g.plane_stride + i) * v[i + g.W];
  if (row > 0) out += __ldg(D + 4 * g.plane_stride + i) * v[i - g.W];
  return out;
}

// Walk this thread's nodes: i = tid, tid + blockDim, ... with (row, col)
// advanced incrementally (no division in the loop).
#define FOR_NODES(g)                                                    \
  for (int i = threadIdx.x, row = threadIdx.x / (g).W,                  \
           col = threadIdx.x - row * (g).W;                             \
       i < (g).n; i += blockDim.x, row += (g).step_r, col += (g).step_c, \
           row += (col >= (g).W), col -= (col >= (g).W) * (g).W)

// One fixed-trip PCG solve.  On entry x holds x0 and r holds the right-hand
// side, both complete (the caller synchronized); on exit x holds the
// solution.  D and minv point at this scenario's planes.
__device__ void cg_solve(const float* __restrict__ D,
                         const float* __restrict__ minv, float* x, float* r,
                         float* p, float* ap, const Grid& g, int iters,
                         float (*red)[32], int& rb) {
  float part = 0.f;
  FOR_NODES(g) {
    const float ri = r[i] - apply_at(D, g, i, row, col, x);
    const float zi = __ldg(minv + i) * ri;
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
    FOR_NODES(g) {
      const float a = apply_at(D, g, i, row, col, p);
      ap[i] = a;
      part += p[i] * a;
    }
    const float pap = block_sum(part, red[rb]);
    rb ^= 1;
    const float alpha = (live && pap != 0.f) ? rz / pap : 0.f;
    part = 0.f;
    FOR_NODES(g) {
      x[i] += alpha * p[i];
      const float ri = r[i] - alpha * ap[i];
      r[i] = ri;
      part += ri * (__ldg(minv + i) * ri);
    }
    const float rz_new = block_sum(part, red[rb]);
    rb ^= 1;
    const float beta =
        (live && rz_new > floor_ && rz != 0.f) ? rz_new / rz : 0.f;
    FOR_NODES(g) { p[i] = __ldg(minv + i) * r[i] + beta * p[i]; }
    __syncthreads();  // p complete before the next stencil apply reads it
    rz = rz_new;
  }
}

template <bool TWO_SOLVES>
__global__ void __launch_bounds__(kMaxThreads)
stencil_cg_kernel(const float* __restrict__ D, const float* __restrict__ b,
                  const float* __restrict__ minv,
                  const float* __restrict__ x0,
                  const float* __restrict__ lam0,
                  const float* __restrict__ ud, float* __restrict__ x_out,
                  float* __restrict__ lam_out, float* work, Grid g,
                  int iters, float scale) {
  extern __shared__ float smem[];
  __shared__ float red[2][32];
  int rb = 0;
  const size_t base = static_cast<size_t>(blockIdx.x) * g.n;
  float* vecs = work ? work + static_cast<size_t>(blockIdx.x) * kVecs * g.n
                     : smem;
  float *x = vecs, *r = vecs + g.n, *p = vecs + 2 * g.n,
        *ap = vecs + 3 * g.n;
  const float* Ds = D + base;
  const float* ms = minv + base;

  for (int i = threadIdx.x; i < g.n; i += blockDim.x) {
    x[i] = x0[base + i];
    r[i] = b[base + i];
  }
  __syncthreads();
  cg_solve(Ds, ms, x, r, p, ap, g, iters, red, rb);

  if constexpr (TWO_SOLVES) {
    for (int i = threadIdx.x; i < g.n; i += blockDim.x) {
      const float xi = x[i];
      x_out[base + i] = xi;
      r[i] = scale * (xi - ud[base + i]);
      x[i] = lam0[base + i];
    }
    __syncthreads();
    cg_solve(Ds, ms, x, r, p, ap, g, iters, red, rb);
    for (int i = threadIdx.x; i < g.n; i += blockDim.x)
      lam_out[base + i] = x[i];
  } else {
    for (int i = threadIdx.x; i < g.n; i += blockDim.x) x_out[base + i] = x[i];
  }
}

// Floats of dynamic shared memory a block may take on the current device.
int smem_optin_floats() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (bytes - static_cast<int>(sizeof(float) * 2 * 32)) /
         static_cast<int>(sizeof(float));
}

template <bool TWO_SOLVES>
int launch(const void* D, const void* b, const void* minv, const void* x0,
           const void* lam0, const void* ud, void* x_out, void* lam_out,
           void* work, int B, int H, int W, int iters, float scale,
           void* stream) {
  Grid g;
  g.H = H;
  g.W = W;
  g.n = H * W;
  int threads = ((g.n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  g.step_r = threads / W;
  g.step_c = threads - g.step_r * W;
  g.plane_stride = static_cast<size_t>(B) * g.n;
  size_t smem = 0;
  if (work == nullptr) {
    smem = sizeof(float) * kVecs * static_cast<size_t>(g.n);
    cudaError_t e = cudaFuncSetAttribute(
        stencil_cg_kernel<TWO_SOLVES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  stencil_cg_kernel<TWO_SOLVES>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(D), static_cast<const float*>(b),
          static_cast<const float*>(minv), static_cast<const float*>(x0),
          static_cast<const float*>(lam0), static_cast<const float*>(ud),
          static_cast<float*>(x_out), static_cast<float*>(lam_out),
          static_cast<float*>(work), g, iters, scale);
  return cudaGetLastError();
}

}  // namespace

// Floats of global workspace one scenario needs on an (H, W) grid: 0 when
// the CG vectors fit in shared memory, else 4*H*W.
extern "C" int difffe_stencil_cg_work(int H, int W) {
  const long long need = static_cast<long long>(kVecs) * H * W;
  return need <= smem_optin_floats() ? 0 : static_cast<int>(need);
}

// Every entry returns cudaGetLastError() after the launch (0 on success).
// D is (5, B, H, W); every other plane is (B, H, W); all float32 and
// contiguous.  `work` is null or holds difffe_stencil_cg_work(H, W) floats
// per scenario.
extern "C" int difffe_stencil_cg(const void* D, const void* b,
                                 const void* minv, const void* x0, void* out,
                                 void* work, int B, int H, int W, int iters,
                                 void* stream) {
  return launch<false>(D, b, minv, x0, nullptr, nullptr, out, nullptr, work,
                       B, H, W, iters, 0.f, stream);
}

extern "C" int difffe_stencil_cg2(const void* D, const void* b,
                                  const void* minv, const void* x0,
                                  const void* lam0, const void* ud,
                                  void* x_out, void* lam_out, void* work,
                                  int B, int H, int W, int iters, float scale,
                                  void* stream) {
  return launch<true>(D, b, minv, x0, lam0, ud, x_out, lam_out, work, B, H, W,
                      iters, scale, stream);
}
