// Whole-CG Jacobi-PCG on structured 2D grids (kernels K3a and K3b).
//
// Replaces the Pallas TPU kernels of
// difffe_tpu/ops/pallas/stencil_cg_kernel.py: _cg_kernel / _cg_kernel_tb
// behind _cg_pallas (K3a, one fixed-trip solve) and _cg2_kernel_tb behind
// _cg2_pallas (K3b, forward solve, MSE cotangent, adjoint solve).  The
// operator is the BC-folded 5-point stencil D0..D4 of an (H, W) node grid,
// A v = sum_k D_k * shift(v, OFFSETS[k]); the CG body (algorithm, freeze
// rule, dots) is cg_common.cuh's, shared with the 3D kernels K4.
//
// Design.  One thread block per scenario; its threads stride over the H*W
// nodes, so every plane read is coalesced along a row.  The CG vectors x,
// r, p and Ap live in dynamic shared memory when 4*H*W floats fit the
// block's opt-in limit (H*W <= 14,500 nodes: the 64^2 grid of the main
// path, 16.5 KB a plane), else in a global workspace of 4*H*W floats per
// scenario that the wrapper allocates.  The coefficient planes and Minv are
// read from device memory (through L1/L2) in every iteration.  Neighbour
// reads are guarded at the grid's edges (no reliance on zero coefficients)
// and plane offsets are 64-bit.
//
// Bound.  At the main path's workload (64^2 grid, B = 4096, 32 iterations,
// two solves) the work is ~20 flop per node per iteration, 2.2e10 flop =
// 0.33 ms at 67 TFLOP/s fp32, against 0.83 GB of inputs and outputs
// (0.25 ms at 3.35 TB/s): the function is bound by operations.  This first
// design re-reads the 5 planes and Minv (24 B a node) from L2 or device
// memory in every iteration, so it is bound in practice by that traffic;
// keeping them on the chip (registers or shared memory) is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "cg_common.cuh"

namespace {

constexpr int kMaxThreads = 512;

// The BC-folded 5-point operator of one scenario on an (H, W) node grid.
struct Stencil5 {
  const float* D;                  // this scenario's D0 plane
  const float* minv_;
  size_t plane_stride;             // B * H * W: distance between D planes
  int H, W, n;                     // n = H * W
  int step_r, step_c;              // a thread's stride, as (rows, cols)

  struct Cursor {
    int i, row, col;
  };

  __device__ Cursor first() const {
    Cursor c;
    c.i = threadIdx.x;
    c.row = threadIdx.x / W;
    c.col = threadIdx.x - c.row * W;
    return c;
  }

  __device__ void next(Cursor& c) const {
    c.i += blockDim.x;
    c.row += step_r;
    c.col += step_c;
    c.row += (c.col >= W);
    c.col -= (c.col >= W) * W;
  }

  // (A v) at the cursor's node, with guarded neighbour reads.
  __device__ float apply(const Cursor& c, const float* v) const {
    const int i = c.i;
    float out = __ldg(D + i) * v[i];
    if (c.col + 1 < W) out += __ldg(D + plane_stride + i) * v[i + 1];
    if (c.col > 0) out += __ldg(D + 2 * plane_stride + i) * v[i - 1];
    if (c.row + 1 < H) out += __ldg(D + 3 * plane_stride + i) * v[i + W];
    if (c.row > 0) out += __ldg(D + 4 * plane_stride + i) * v[i - W];
    return out;
  }

  __device__ float minv(int i) const { return __ldg(minv_ + i); }
};

template <bool TWO_SOLVES>
__global__ void __launch_bounds__(kMaxThreads)
stencil_cg_kernel(const float* __restrict__ D, const float* __restrict__ b,
                  const float* __restrict__ minv,
                  const float* __restrict__ x0,
                  const float* __restrict__ lam0,
                  const float* __restrict__ ud, float* __restrict__ x_out,
                  float* __restrict__ lam_out, float* work, Stencil5 grid,
                  int iters, float scale) {
  extern __shared__ float smem[];
  const size_t base = static_cast<size_t>(blockIdx.x) * grid.n;
  float* vecs = work ? work + static_cast<size_t>(blockIdx.x) * kVecs * grid.n
                     : smem;
  Stencil5 op = grid;
  op.D = D + base;
  op.minv_ = minv + base;
  cg_block<TWO_SOLVES>(op, b + base, x0 + base,
                       TWO_SOLVES ? lam0 + base : nullptr,
                       TWO_SOLVES ? ud + base : nullptr, x_out + base,
                       TWO_SOLVES ? lam_out + base : nullptr, vecs, iters,
                       scale);
}

template <bool TWO_SOLVES>
int launch(const void* D, const void* b, const void* minv, const void* x0,
           const void* lam0, const void* ud, void* x_out, void* lam_out,
           void* work, int B, int H, int W, int iters, float scale,
           void* stream) {
  Stencil5 op;
  op.D = nullptr;     // set per scenario in the kernel
  op.minv_ = nullptr;
  op.H = H;
  op.W = W;
  op.n = H * W;
  int threads = ((op.n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  op.step_r = threads / W;
  op.step_c = threads - op.step_r * W;
  op.plane_stride = static_cast<size_t>(B) * op.n;
  size_t smem = 0;
  if (work == nullptr) {
    smem = sizeof(float) * kVecs * static_cast<size_t>(op.n);
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
          static_cast<float*>(work), op, iters, scale);
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
