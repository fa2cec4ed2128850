// Whole-CG Jacobi-PCG on structured 3D boxes (kernels K4a and K4b).
//
// Replaces the Pallas TPU kernels of
// difffe_tpu/ops/pallas/stencil3d_cg_kernel.py: _cg3_kernel_tb behind
// _cg3_pallas (K4a, one fixed-trip solve) and _cg3_2_kernel_tb behind
// _cg3_2_pallas (K4b, forward solve, MSE cotangent, adjoint solve).  The
// operator is the BC-folded 7-point stencil D0..D6 of a (Dz, H, W) node box,
// A v = sum_k D_k * shift(v, OFFSETS3[k]); the algorithm, freeze rule and
// dots are cg_common.cuh's, shared with the 2D kernels K3.  The TPU folded
// the box to (Dz, H*W) and shifted it with six maskless rolls whose
// wrap-around met zero coefficients or lane padding; here nothing is
// padded, and each of the six neighbour reads is guarded by the node's
// (z, y, x), which the thread advances without division (a read outside
// the box would be an illegal address).  Plane offsets are 64-bit
// (7 * B * 33^3 floats at the main path).  The coefficient planes and Minv
// may be stored as bf16 (CT = __nv_bfloat16), upcast at each load, with all
// arithmetic, the right-hand side, the state and the outputs in f32.
//
// K4a and K4b each have two routes, which the wrapper's plan picks from
// the shape and the stored type (one plan for both: the one-solve and the
// two-solve kernels hold the same bytes a block):
//
// * cluster (cg_cluster.cuh): one thread-block cluster of C blocks a
//   scenario holds the scenario's 7 planes, Minv and CG state in shared
//   memory (44 B a node in f32, 28 B in bf16) and registers for the whole
//   launch, so its loop reads no device memory; neighbours in another
//   block's range are read through DSMEM.  It takes boxes of up to
//   16 * 8 * 640 = 81,920 nodes (42^3; the main path's 32^3 at C = 8).
//   K4a starts from any x0: the initial residual reads x0's neighbours
//   from device memory.
// * workspace (cg_common.cuh, the first design): one thread block a
//   scenario, the CG vectors in dynamic shared memory when 4*n floats fit
//   (n <= ~14,500 nodes) else in a global workspace of 4*n floats a
//   scenario that the wrapper allocates; the planes and Minv are read from
//   device memory (through L1/L2) in every iteration.  The plan sends only
//   boxes past the cluster route's reach here (43^3 and up).
//
// Bound.  At the main path's workload (32^3 box, B = 128, 100 iterations,
// two solves) the work is 24 operations per node per iteration (7-point
// apply 13, two dots 4, x/r/p updates 6, Jacobi 1), 2.2e10 = 0.33 ms at
// 67 TFLOP/s fp32, against 14 (B, 33^3) f32 planes moved once (0.26 GB,
// 0.077 ms at 3.35 TB/s): bound by operations; K4a's eval solve (one
// solve, 400 iterations, 11 planes) likewise.  The first design ran one
// scenario an SM (B = 128 blocks on 132 SMs) and re-read the 8 coefficient
// planes and streamed x, r, p and Ap through its workspace in every
// iteration (~80 B a node); the cluster route spreads a scenario over C
// SMs' shared memory and is bound by its shared-memory traffic (~80 B a
// node and iteration), its instructions and the latency of its two dots
// an iteration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "cg_cluster.cuh"
#include "cg_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The BC-folded 7-point operator of one scenario on a (Dz, H, W) node box,
// coefficient planes and Minv stored as CT.
template <typename CT>
struct Stencil7 {
  const CT* D;               // this scenario's D0 plane
  const CT* minv_;
  size_t plane_stride;       // B * n: distance between two D planes
  int Dz, H, W, HW, n;       // n = Dz * H * W
  int step_z, step_y, step_x;  // a thread's stride over nodes, as (z, y, x)

  struct Cursor {
    int i, z, y, x;
  };

  __device__ Cursor first() const {
    Cursor c;
    c.i = threadIdx.x;
    c.z = threadIdx.x / HW;
    const int rem = threadIdx.x - c.z * HW;
    c.y = rem / W;
    c.x = rem - c.y * W;
    return c;
  }

  // step_x < W and step_y < H, so each carry happens at most once.
  __device__ void next(Cursor& c) const {
    c.i += blockDim.x;
    c.x += step_x;
    c.y += step_y;
    c.z += step_z;
    if (c.x >= W) {
      c.x -= W;
      ++c.y;
    }
    if (c.y >= H) {
      c.y -= H;
      ++c.z;
    }
  }

  // (A v) at the cursor's node, with guarded neighbour reads, in the order
  // of OFFSETS3: (0,0,+1) (0,0,-1) (0,+1,0) (0,-1,0) (+1,0,0) (-1,0,0).
  __device__ float apply(const Cursor& c, const float* v) const {
    const int i = c.i;
    float out = load(D + i) * v[i];
    if (c.x + 1 < W) out += load(D + plane_stride + i) * v[i + 1];
    if (c.x > 0) out += load(D + 2 * plane_stride + i) * v[i - 1];
    if (c.y + 1 < H) out += load(D + 3 * plane_stride + i) * v[i + W];
    if (c.y > 0) out += load(D + 4 * plane_stride + i) * v[i - W];
    if (c.z + 1 < Dz) out += load(D + 5 * plane_stride + i) * v[i + HW];
    if (c.z > 0) out += load(D + 6 * plane_stride + i) * v[i - HW];
    return out;
  }

  __device__ float minv(int i) const { return load(minv_ + i); }
};

template <typename CT, bool TWO_SOLVES>
__global__ void __launch_bounds__(kMaxThreads)
stencil3d_cg_kernel(const CT* __restrict__ D, const float* __restrict__ b,
                    const CT* __restrict__ minv,
                    const float* __restrict__ x0,
                    const float* __restrict__ lam0,
                    const float* __restrict__ ud, float* __restrict__ x_out,
                    float* __restrict__ lam_out, float* work,
                    Stencil7<CT> box, int iters, float scale) {
  extern __shared__ float smem[];
  const size_t base = static_cast<size_t>(blockIdx.x) * box.n;
  float* vecs =
      work ? work + static_cast<size_t>(blockIdx.x) * kVecs * box.n : smem;
  Stencil7<CT> op = box;
  op.D = D + base;
  op.minv_ = minv + base;
  cg_block<TWO_SOLVES>(op, b + base, x0 + base,
                       TWO_SOLVES ? lam0 + base : nullptr,
                       TWO_SOLVES ? ud + base : nullptr, x_out + base,
                       TWO_SOLVES ? lam_out + base : nullptr, vecs, iters,
                       scale);
}

template <typename CT, bool TWO_SOLVES>
int launch(const void* D, const void* b, const void* minv, const void* x0,
           const void* lam0, const void* ud, void* x_out, void* lam_out,
           void* work, int B, int Dz, int H, int W, int iters, float scale,
           void* stream) {
  Stencil7<CT> op;
  op.D = nullptr;     // set per scenario in the kernel
  op.minv_ = nullptr;
  op.Dz = Dz;
  op.H = H;
  op.W = W;
  op.HW = H * W;
  op.n = Dz * op.HW;
  int threads = ((op.n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  op.step_z = threads / op.HW;
  const int rem = threads - op.step_z * op.HW;
  op.step_y = rem / W;
  op.step_x = rem - op.step_y * W;
  op.plane_stride = static_cast<size_t>(B) * op.n;
  size_t smem = 0;
  if (work == nullptr) {
    smem = sizeof(float) * kVecs * static_cast<size_t>(op.n);
    cudaError_t e = cudaFuncSetAttribute(
        stencil3d_cg_kernel<CT, TWO_SOLVES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  stencil3d_cg_kernel<CT, TWO_SOLVES>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const CT*>(D), static_cast<const float*>(b),
          static_cast<const CT*>(minv), static_cast<const float*>(x0),
          static_cast<const float*>(lam0), static_cast<const float*>(ud),
          static_cast<float*>(x_out), static_cast<float*>(lam_out),
          static_cast<float*>(work), op, iters, scale);
  return cudaGetLastError();
}

}  // namespace

// Floats of global workspace one scenario needs on a (Dz, H, W) box on
// the first design (K4a; K4b's workspace route): 0 when the CG vectors fit
// in shared memory, else 4*Dz*H*W.
extern "C" int difffe_stencil3d_cg_work(int Dz, int H, int W) {
  const long long need = static_cast<long long>(kVecs) * Dz * H * W;
  return need <= smem_optin_floats() ? 0 : static_cast<int>(need);
}

// Every entry returns cudaGetLastError() after the launch (0 on success).
// D is (7, B, Dz, H, W) and Minv (B, Dz, H, W), both float32, or both
// bfloat16 when `bf16` is nonzero; every other plane is (B, Dz, H, W)
// float32; all contiguous.  `work` is null or holds
// difffe_stencil3d_cg_work(Dz, H, W) floats per scenario.
//
// K4a.  `cluster` > 0 takes the cluster route with clusters of that many
// blocks of `threads` threads (work must be null); 0 takes the workspace
// route (the first design; `threads` unused).
extern "C" int difffe_stencil3d_cg(const void* D, const void* b,
                                   const void* minv, const void* x0,
                                   void* out, void* work, int B, int Dz,
                                   int H, int W, int iters, int bf16,
                                   int cluster, int threads, void* stream) {
  if (cluster > 0) {
    if (work != nullptr) return cudaErrorInvalidValue;
    if (bf16)
      return launch_cluster_cg<__nv_bfloat16, 7, false>(
          D, b, minv, x0, nullptr, nullptr, out, nullptr, B, Dz, H, W, iters,
          0.f, cluster, threads, stream);
    return launch_cluster_cg<float, 7, false>(D, b, minv, x0, nullptr,
                                              nullptr, out, nullptr, B, Dz, H,
                                              W, iters, 0.f, cluster, threads,
                                              stream);
  }
  if (bf16)
    return launch<__nv_bfloat16, false>(D, b, minv, x0, nullptr, nullptr, out,
                                        nullptr, work, B, Dz, H, W, iters,
                                        0.f, stream);
  return launch<float, false>(D, b, minv, x0, nullptr, nullptr, out, nullptr,
                              work, B, Dz, H, W, iters, 0.f, stream);
}

// K4b.  `cluster` > 0 takes the cluster route with clusters of that many
// blocks of `threads` threads (work must be null); 0 takes the workspace
// route (the first design; `threads` unused).
extern "C" int difffe_stencil3d_cg2(const void* D, const void* b,
                                    const void* minv, const void* x0,
                                    const void* lam0, const void* ud,
                                    void* x_out, void* lam_out, void* work,
                                    int B, int Dz, int H, int W, int iters,
                                    float scale, int bf16, int cluster,
                                    int threads, void* stream) {
  if (cluster > 0) {
    if (work != nullptr) return cudaErrorInvalidValue;
    if (bf16)
      return launch_cluster_cg<__nv_bfloat16, 7, true>(
          D, b, minv, x0, lam0, ud, x_out, lam_out, B, Dz, H, W, iters, scale,
          cluster, threads, stream);
    return launch_cluster_cg<float, 7, true>(D, b, minv, x0, lam0, ud, x_out,
                                             lam_out, B, Dz, H, W, iters,
                                             scale, cluster, threads, stream);
  }
  if (bf16)
    return launch<__nv_bfloat16, true>(D, b, minv, x0, lam0, ud, x_out,
                                       lam_out, work, B, Dz, H, W, iters,
                                       scale, stream);
  return launch<float, true>(D, b, minv, x0, lam0, ud, x_out, lam_out, work,
                             B, Dz, H, W, iters, scale, stream);
}

// K4a's and K4b's cluster routes: how many clusters of `cluster` blocks of
// `threads` threads the card holds at once on a (Dz, H, W) box (0: none;
// < 0: minus a CUDA error).
extern "C" int difffe_stencil3d_cg_clusters(int Dz, int H, int W,
                                            int cluster, int threads,
                                            int bf16) {
  if (bf16)
    return cluster_capacity<__nv_bfloat16, 7, false>(Dz, H, W, cluster,
                                                     threads);
  return cluster_capacity<float, 7, false>(Dz, H, W, cluster, threads);
}

extern "C" int difffe_stencil3d_cg2_clusters(int Dz, int H, int W,
                                             int cluster, int threads,
                                             int bf16) {
  if (bf16)
    return cluster_capacity<__nv_bfloat16, 7, true>(Dz, H, W, cluster,
                                                    threads);
  return cluster_capacity<float, 7, true>(Dz, H, W, cluster, threads);
}
