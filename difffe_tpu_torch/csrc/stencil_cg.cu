// Whole-CG Jacobi-PCG on structured 2D grids (kernels K3a and K3b).
//
// Replaces the Pallas TPU kernels of
// difffe_tpu/ops/pallas/stencil_cg_kernel.py: _cg_kernel / _cg_kernel_tb
// behind _cg_pallas (K3a, one fixed-trip solve) and _cg2_kernel_tb behind
// _cg2_pallas (K3b, forward solve, MSE cotangent, adjoint solve).  The
// operator is the BC-folded 5-point stencil D0..D4 of an (H, W) node grid,
// A v = sum_k D_k * shift(v, OFFSETS[k]); the algorithm, freeze rule and
// dots are cg_common.cuh's, shared with the 3D kernels K4.
//
// K3a and K3b each have two routes, which the wrapper's plan picks from the
// shape (one plan for both, K3b's):
//
// * cluster (cg_cluster.cuh): one thread-block cluster of C blocks a
//   scenario holds the scenario's 5 planes, Minv and CG state in shared
//   memory (36 B a node) and registers for the whole launch, so its loop
//   reads no device memory; neighbours in another block's range are read
//   through DSMEM.  It takes grids of up to 16 * 8 * 640 = 81,920 nodes
//   (285^2; 256^2 at C = 16, the main path's 64^2 at C = 1).  K3a starts
//   from any x0: the initial residual reads x0's neighbours from device
//   memory.
// * workspace (cg_common.cuh, the first design): one thread block a
//   scenario, the CG vectors in dynamic shared memory when 4*H*W floats
//   fit (H*W <= 14,500 nodes) else in a global workspace of 4*H*W floats a
//   scenario that the wrapper allocates; the planes and Minv are read from
//   device memory in every iteration.  The plan sends only grids past the
//   cluster route's reach here.
//
// Neighbour reads are guarded at the grid's edges (no reliance on zero
// coefficients) and plane offsets are 64-bit.
//
// Bound.  At the main path's workload (64^2 grid, B = 4096, 32 iterations,
// two solves) the work is ~20 flop per node per iteration, 2.2e10 flop =
// 0.33 ms at 67 TFLOP/s fp32, against 0.83 GB of inputs and outputs
// (0.25 ms at 3.35 TB/s): the function is bound by operations; K3a's
// u_data solve (one solve, 256 iterations, 9 planes) likewise.  The first
// design re-read the 5 planes and Minv (24 B a node) from L2 or device
// memory in every iteration and was bound by that traffic (K3a at 64^2,
// B = 4096: 403 MB an iteration); the cluster route moves each byte of
// device memory once and is bound by its shared-memory traffic (~64 B a
// node and iteration), its instructions and the latency of its two dots
// an iteration.

#include <cuda_runtime.h>

#include <cstddef>

#include "cg_cluster.cuh"
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

// Floats of global workspace one scenario needs on an (H, W) grid on the
// first design (K3a; K3b's workspace route): 0 when the CG vectors fit in
// shared memory, else 4*H*W.
extern "C" int difffe_stencil_cg_work(int H, int W) {
  const long long need = static_cast<long long>(kVecs) * H * W;
  return need <= smem_optin_floats() ? 0 : static_cast<int>(need);
}

// Shared memory one block may opt in to on the current device, in bytes.
extern "C" int difffe_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Every entry returns cudaGetLastError() after the launch (0 on success).
// D is (5, B, H, W); every other plane is (B, H, W); all float32 and
// contiguous.  `work` is null or holds difffe_stencil_cg_work(H, W) floats
// per scenario.
//
// K3a.  `cluster` > 0 takes the cluster route with clusters of that many
// blocks of `threads` threads (work must be null); 0 takes the workspace
// route (the first design; `threads` unused).
extern "C" int difffe_stencil_cg(const void* D, const void* b,
                                 const void* minv, const void* x0, void* out,
                                 void* work, int B, int H, int W, int iters,
                                 int cluster, int threads, void* stream) {
  if (cluster > 0) {
    if (work != nullptr) return cudaErrorInvalidValue;
    return launch_cluster_cg<float, 5, false>(D, b, minv, x0, nullptr,
                                              nullptr, out, nullptr, B, 1, H,
                                              W, iters, 0.f, cluster, threads,
                                              stream);
  }
  return launch<false>(D, b, minv, x0, nullptr, nullptr, out, nullptr, work,
                       B, H, W, iters, 0.f, stream);
}

// K3a's cluster route: how many clusters of `cluster` blocks of `threads`
// threads the card holds at once on an (H, W) grid (0: none; < 0: minus a
// CUDA error).
extern "C" int difffe_stencil_cg_clusters(int H, int W, int cluster,
                                          int threads) {
  return cluster_capacity<float, 5, false>(1, H, W, cluster, threads);
}

// K3b.  `cluster` > 0 takes the cluster route with clusters of that many
// blocks of `threads` threads (work must be null); 0 takes the workspace
// route (the first design; `threads` unused).
extern "C" int difffe_stencil_cg2(const void* D, const void* b,
                                  const void* minv, const void* x0,
                                  const void* lam0, const void* ud,
                                  void* x_out, void* lam_out, void* work,
                                  int B, int H, int W, int iters, float scale,
                                  int cluster, int threads, void* stream) {
  if (cluster > 0) {
    if (work != nullptr) return cudaErrorInvalidValue;
    return launch_cluster_cg<float, 5, true>(D, b, minv, x0, lam0, ud, x_out,
                                             lam_out, B, 1, H, W, iters,
                                             scale, cluster, threads, stream);
  }
  return launch<true>(D, b, minv, x0, lam0, ud, x_out, lam_out, work, B, H, W,
                      iters, scale, stream);
}

// K3b's cluster route: how many clusters of `cluster` blocks of `threads`
// threads the card holds at once on an (H, W) grid (0: none; < 0: minus a
// CUDA error).
extern "C" int difffe_stencil_cg2_clusters(int H, int W, int cluster,
                                           int threads) {
  return cluster_capacity<float, 5, true>(1, H, W, cluster, threads);
}
