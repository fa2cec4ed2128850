// The whole-CG body of the cluster routes on the H100: one thread-block
// cluster a scenario, with the scenario's operator, Minv and CG state on
// the chip (shared memory and registers) for the whole launch.  Its users:
// K3b (stencil_cg.cu) and K4b (stencil3d_cg.cu), two solves a launch; K4a
// (stencil3d_cg.cu), one; K8s (ell_cg.cu), one solve of the edge-ELL
// operator.  An operator type gives the loop its nodes, its Minv, its
// apply and its initial residual: ClusterBox here (the BC-folded stencil of
// a node box), ClusterEll in ell_cg.cu.
//
// Algorithm, freeze rule and two-solve form are cg_common.cuh's (see its
// header); where the data lives and how a dot is summed differ.
//
// Launch.  One cluster of C blocks a scenario (C in {1, 2, 4, 8, 16}; 16 is
// a non-portable size), the clusters side by side along x: block b*C + k is
// rank k of scenario b's cluster.  The wrapper's plan picks C and the
// threads a block.
//
// Partition.  Rank k owns the contiguous node range [k*chunk,
// min(n, (k+1)*chunk)), chunk = ceil(n / C), and each of its threads at most
// kNodesPerThread of those nodes (node lo + t + j*threads for j = 0, 1, ...).
// The rank stages its range's NP coefficient planes and Minv into dynamic
// shared memory once, in the stored type CT (f32, or bf16 on K4's bf16
// route); a thread keeps x, r and Ap (then z) of its nodes in registers.
// The CG loop reads no device memory.  Shared memory a block: chunk * (12 +
// (NP + 1) * sizeof(CT)) bytes (p twice, r, the planes) and
// kClusterStaticBytes; every rank lays it out alike, so a value of another
// rank sits at the same offset in that rank's window.
//
// Neighbour reads.  The initial residual reads x0 (or lambda0) at the
// neighbours from device memory, once a solve.  Each apply reads p at a
// neighbour in its own range from shared memory; at a neighbour at +-1, +-W
// or +-HW in another rank's range it reads that rank's r, Minv and previous
// p through DSMEM and forms the neighbour's p = Minv r + beta p_prev
// itself (cluster_remote_p), with the owner's own roundings, so it gets the
// owner's bits without waiting for the owner to store them.  p is
// double-buffered, so no rank overwrites a p another rank may still read.
// Every read stays guarded by the node's (z, y, x), as in cg_common's
// operators.  The 2D operator is the 3D one with Dz = 1 and NP = 5 (its z
// terms never compile).
//
// Rounding.  Every product and sum is rounded on its own, in the plain
// version's order (no contraction to fma), so a kernel run differs from
// the plain f32 run only in the order of each dot's sum.
//
// Dots.  Each block reduces its partial to the same bits in every thread
// (a butterfly in each warp, then over the warp partials), then thread k
// sends it to rank k with st.async, whose mbarrier complete_tx releases it
// at cluster scope; every rank waits on its own mbarrier for the C partials
// and sums them in rank order.  Every block so holds the same bits, takes
// the same freeze and alpha/beta decisions, and a run repeats bit for bit.
// Two slots (table and mbarrier) serve alternate dots: a rank writes slot s
// again only after every rank's next dot, which each sends after reading s.
//
// Barriers.  None an iteration across the cluster: a block barrier after the
// p update (the rank's own p complete before its apply), the dots' two
// mbarrier waits, and the block barriers inside the block reductions.  Why
// this is safe: a rank overwrites its r or p only after a dot that needs
// every rank's partial, and each rank sends its partial only after its
// apply has read what it needs.  (On the H100 a cluster barrier with
// release/acquire semantics costs several block barriers, even at C = 1.)
// One cluster barrier after staging (the mbarriers initialised) and one
// before the end, so that no block's shared memory goes away while a
// neighbour may read it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

namespace cgx = cooperative_groups;

constexpr int kMaxCluster = 16;
// 640 threads leave a thread 96 registers (65,536 an SM) for the x, r and
// Ap of its up to 8 nodes without spilling
constexpr int kClusterMaxThreads = 640;
constexpr int kNodesPerThread = 8;
constexpr int kClusterVecs = 3;  // p (two buffers) and r, in f32
// two 32-float reduction buffers, two tables of published partials, two
// mbarriers
constexpr int kClusterStaticBytes = static_cast<int>(
    sizeof(float) * (2 * 32 + 2 * kMaxCluster) + 2 * sizeof(uint64_t));

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory offset in rank `rank`'s window.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// This rank's one arrival on `bar`, announcing `bytes` to come.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Store v at `remote` (a shared::cluster address) and complete 4 bytes of
// the transaction on the mbarrier at `remote_bar` in the same window.
__device__ __forceinline__ void st_async(uint32_t remote, float v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(remote),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ float stored(float v) { return v; }
__device__ __forceinline__ float stored(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The next search direction at a node from z = Minv r, the current p and
// beta, z + beta p; the owner and every neighbour that forms it round alike.
__device__ __forceinline__ float next_p(float z, float p, float beta) {
  return __fadd_rn(z, __fmul_rn(beta, p));
}

// The block's total of v, the same bits in every thread: a butterfly in
// each warp, the warp partials through `red` (one of two 32-float buffers,
// used alternately), and a butterfly over them in every warp.
__device__ __forceinline__ float block_total(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// p at node j of another rank of `chunk` nodes a rank: formed from that
// rank's r, Minv and previous p (the buffers at the same offsets as this
// rank's `rs`, `minv`, `prev`), as the owner forms it.
template <typename CT>
__device__ __forceinline__ float cluster_remote_p(int j, int chunk,
                                                  float* rs, const CT* minv,
                                                  float* prev, float beta) {
  cgx::cluster_group cluster = cgx::this_cluster();
  const int owner = j / chunk, o = j - owner * chunk;
  const float r = cluster.map_shared_rank(rs, owner)[o];
  const float m =
      stored(cluster.map_shared_rank(const_cast<CT*>(minv), owner)[o]);
  const float pp = cluster.map_shared_rank(prev, owner)[o];
  return next_p(__fmul_rn(m, r), pp, beta);
}

// Dots over the cluster, summed in rank order (see the header).
struct ClusterDots {
  float (*red)[32];
  float (*pub)[kMaxCluster];
  uint64_t* bar;
  int rb, pb, rank, ranks;
  uint32_t parity;  // bit s: the phase parity slot s waits for next

  __device__ __forceinline__ float sum(float part) {
    const float v = block_total(part, red[rb]);
    rb ^= 1;
    if (ranks == 1) return v;
    const uint32_t b = smem_addr(&bar[pb]);
    if (static_cast<int>(threadIdx.x) < ranks)
      st_async(at_rank(smem_addr(&pub[pb][rank]), threadIdx.x), v,
               at_rank(b, threadIdx.x));
    if (threadIdx.x == 0) mbar_expect(b, ranks * sizeof(float));
    mbar_wait(b, (parity >> pb) & 1u);
    parity ^= 1u << pb;
    float s = 0.f;
    for (int k = 0; k < ranks; ++k) s += pub[pb][k];
    pb ^= 1;
    return s;
  }
};

// The BC-folded NP-point operator of one scenario on a (Dz, H, W) node
// box, seen from one rank: its planes are this rank's shared copies.
template <typename CT, int NP>
struct ClusterBox {
  int Dz, H, W, HW, n;         // n = Dz * H * W
  int ranks, chunk;            // C, nodes a rank
  int step_z, step_y, step_x;  // a thread's stride over nodes, as (z, y, x)
  int lo, end;                 // this rank's nodes [lo, end)
  int in_lo, in_hi;            // nodes whose neighbours all lie in it
  const CT* planes;            // NP planes of chunk values, then Minv

  struct Cursor {
    int i, z, y, x;
  };

  __device__ __forceinline__ Cursor first() const {
    Cursor c;
    c.i = lo + static_cast<int>(threadIdx.x);
    c.z = c.i / HW;
    const int rem = c.i - c.z * HW;
    c.y = rem / W;
    c.x = rem - c.y * W;
    return c;
  }

  // step_x < W and step_y < H, so each carry happens at most once.
  __device__ __forceinline__ void next(Cursor& c) const {
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

  __device__ __forceinline__ float coef(int k, int q) const {
    return stored(planes[k * chunk + q]);
  }

  __device__ __forceinline__ float minv(int q) const { return coef(NP, q); }

  // r - (A x0) at the cursor's node, with x0 there x and at its neighbours
  // read from the scenario's x0 in device memory.
  __device__ __forceinline__ float residual0(const Cursor& c, int q, float r,
                                             float x,
                                             const float* __restrict__ x0)
      const {
    return __fsub_rn(r, stencil(c, q, x,
                                [&](int d) { return __ldg(x0 + c.i + d); }));
  }

  // (A v) at the cursor's node, with v there vq and at offset d nb(d), in
  // the order of OFFSETS / OFFSETS3:
  // (0,0,+1) (0,0,-1) (0,+1,0) (0,-1,0) [(+1,0,0) (-1,0,0)].
  template <class Nb>
  __device__ __forceinline__ float stencil(const Cursor& c, int q, float vq,
                                           Nb nb) const {
    float out = __fmul_rn(coef(0, q), vq);
    if (c.x + 1 < W) out = __fadd_rn(out, __fmul_rn(coef(1, q), nb(1)));
    if (c.x > 0) out = __fadd_rn(out, __fmul_rn(coef(2, q), nb(-1)));
    if (c.y + 1 < H) out = __fadd_rn(out, __fmul_rn(coef(3, q), nb(W)));
    if (c.y > 0) out = __fadd_rn(out, __fmul_rn(coef(4, q), nb(-W)));
    if constexpr (NP == 7) {
      if (c.z + 1 < Dz) out = __fadd_rn(out, __fmul_rn(coef(5, q), nb(HW)));
      if (c.z > 0) out = __fadd_rn(out, __fmul_rn(coef(6, q), nb(-HW)));
    }
    return out;
  }

  // (A p) at the cursor's node; p is `cur` on this rank, formed as
  // cluster_remote_p on the others.
  __device__ __forceinline__ float apply(const Cursor& c, int q, float pq,
                                         float* cur, float* rs, float* prev,
                                         float beta) const {
    const int i = c.i;
    if (i >= in_lo && i < in_hi)
      return stencil(c, q, pq, [&](int d) { return cur[q + d]; });
    return stencil(c, q, pq, [&](int d) {
      const int j = i + d;
      return j >= lo && j < end
                 ? cur[j - lo]
                 : cluster_remote_p(j, chunk, rs, planes + NP * chunk,
                                    prev, beta);
    });
  }
};

// One fixed-trip PCG solve over this rank's nodes.  On entry a thread's
// x[] holds x0 at its nodes and r[] the right-hand side, and `x0` points at
// the scenario's x0 in device memory (the operator's initial residual may
// read the neighbours there); on exit x[] holds the solution.  p0, p1 and
// rs are this rank's shared vectors, indexed by q = node - lo.
template <int K, class Op>
__device__ __forceinline__ void cluster_cg_solve(
    const Op& op, float (&x)[K], float (&r)[K], const float* __restrict__ x0,
    float* p0, float* p1, float* rs, int iters, ClusterDots& dots) {
  const int len = op.end - op.lo, T = blockDim.x;
  float t[K];  // Ap, then z = Minv r
  float part = 0.f;
  {
    auto c = op.first();
#pragma unroll
    for (int k = 0; k < K; ++k, op.next(c)) {
      if (c.i >= op.end) continue;
      const int q = c.i - op.lo;
      const float ri = op.residual0(c, q, r[k], x[k], x0);
      const float z = __fmul_rn(op.minv(q), ri);
      r[k] = ri;
      rs[q] = ri;
      p0[q] = next_p(z, 0.f, 0.f);
      p1[q] = 0.f;  // the "previous p" of the first iteration
      part = __fadd_rn(part, __fmul_rn(ri, z));
    }
  }
  float rz = dots.sum(part);
  const float eps4 = 4.f * FLT_EPSILON;
  const float floor_ = eps4 * eps4 * fmaxf(rz, 1e-30f);
  float beta_prev = 0.f;

  for (int it = 0; it < iters; ++it) {
    const bool live = rz > floor_;
    float* cur = (it & 1) ? p1 : p0;
    float* prev = (it & 1) ? p0 : p1;
    part = 0.f;
    auto c = op.first();
#pragma unroll
    for (int k = 0; k < K; ++k, op.next(c)) {
      if (c.i >= op.end) continue;
      const int q = c.i - op.lo;
      const float pq = cur[q];
      const float a = op.apply(c, q, pq, cur, rs, prev, beta_prev);
      t[k] = a;
      part = __fadd_rn(part, __fmul_rn(pq, a));
    }
    const float pap = dots.sum(part);
    const float alpha = (live && pap != 0.f) ? rz / pap : 0.f;
    part = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * T;
      if (q >= len) continue;
      const float ri = __fsub_rn(r[k], __fmul_rn(alpha, t[k]));
      const float z = __fmul_rn(op.minv(q), ri);
      r[k] = ri;
      rs[q] = ri;
      t[k] = z;
      part = __fadd_rn(part, __fmul_rn(ri, z));
    }
    const float rz_new = dots.sum(part);
    const float beta =
        (live && rz_new > floor_ && rz != 0.f) ? rz_new / rz : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * T;
      if (q >= len) continue;
      const float pq = cur[q];
      x[k] = __fadd_rn(x[k], __fmul_rn(alpha, pq));
      prev[q] = next_p(t[k], pq, beta);  // the next iteration's p
    }
    __syncthreads();  // this rank's p complete before its next apply
    beta_prev = beta;
    rz = rz_new;
  }
}

template <typename CT, int NP, bool TWO_SOLVES>
__global__ void __launch_bounds__(kClusterMaxThreads)
cluster_cg_kernel(const CT* __restrict__ D, const float* __restrict__ b,
                  const CT* __restrict__ minv,
                  const float* __restrict__ x0,
                  const float* __restrict__ lam0,
                  const float* __restrict__ ud, float* __restrict__ x_out,
                  float* __restrict__ lam_out, ClusterBox<CT, NP> op,
                  size_t plane_stride, int iters, float scale) {
  constexpr int K = kNodesPerThread;
  extern __shared__ __align__(16) float cl_smem[];
  __shared__ float red[2][32];
  __shared__ float pub[2][kMaxCluster];
  __shared__ uint64_t bar[2];
  const int rank = static_cast<int>(blockIdx.x) % op.ranks;
  const int chunk = op.chunk, T = blockDim.x;
  op.lo = rank * chunk;
  op.end = min(op.n, op.lo + chunk);
  if (op.end < op.lo) op.end = op.lo;  // a rank past the last node
  const int len = op.end - op.lo;
  const int reach = NP == 7 ? op.HW : op.W;  // the farthest neighbour
  op.in_lo = rank == 0 ? 0 : op.lo + reach;
  op.in_hi = rank == op.ranks - 1 ? op.n : op.end - reach;
  float *p0 = cl_smem, *p1 = p0 + chunk, *rs = p1 + chunk;
  CT* planes = reinterpret_cast<CT*>(cl_smem + kClusterVecs * chunk);
  op.planes = planes;

  const size_t scen = static_cast<size_t>(blockIdx.x / op.ranks) * op.n;
  const size_t base = scen + op.lo;
  for (int q = threadIdx.x; q < len; q += T) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
      planes[k * chunk + q] = D[k * plane_stride + base + q];
    planes[NP * chunk + q] = minv[base + q];
  }
  float x[K], r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * T;
    x[k] = q < len ? x0[base + q] : 0.f;
    r[k] = q < len ? b[base + q] : 0.f;
  }
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bar[0]));
    mbar_init(smem_addr(&bar[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  ClusterDots dots{red, pub, bar, 0, 0, rank, op.ranks, 0u};
  if (op.ranks > 1)
    cluster_sync();  // every rank's mbarriers ready for the first dot
  else
    __syncthreads();  // the planes staged
  cluster_cg_solve(op, x, r, x0 + scen, p0, p1, rs, iters, dots);

  if constexpr (TWO_SOLVES) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * T;
      if (q >= len) continue;
      x_out[base + q] = x[k];
      r[k] = __fmul_rn(scale, __fsub_rn(x[k], ud[base + q]));
      x[k] = lam0[base + q];
    }
    cluster_cg_solve(op, x, r, lam0 + scen, p0, p1, rs, iters, dots);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * T;
      if (q < len) lam_out[base + q] = x[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * T;
      if (q < len) x_out[base + q] = x[k];
    }
  }
  if (op.ranks > 1) cluster_sync();  // no window goes away while read
}

// The operator's geometry for C ranks of `threads` threads; false when C,
// threads or the nodes a thread would hold are not what the kernel takes.
template <typename CT, int NP>
bool cluster_box(int Dz, int H, int W, int C, int threads,
                 ClusterBox<CT, NP>& op) {
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return false;
  if (threads < 32 || threads > kClusterMaxThreads || threads % 32 != 0)
    return false;
  op.Dz = Dz;
  op.H = H;
  op.W = W;
  op.HW = H * W;
  op.n = Dz * op.HW;
  op.ranks = C;
  op.chunk = (op.n + C - 1) / C;
  if (op.chunk > kNodesPerThread * threads) return false;
  op.step_z = threads / op.HW;
  const int rem = threads - op.step_z * op.HW;
  op.step_y = rem / W;
  op.step_x = rem - op.step_y * W;
  op.lo = op.end = op.in_lo = op.in_hi = 0;  // set per rank in the kernel
  op.planes = nullptr;
  return true;
}

template <typename CT, int NP>
size_t cluster_smem_bytes(const ClusterBox<CT, NP>& op) {
  return static_cast<size_t>(op.chunk) *
         (kClusterVecs * sizeof(float) + (NP + 1) * sizeof(CT));
}

// Raise the kernel's shared-memory limit and allow a 16-block cluster.
template <typename Kernel>
cudaError_t cluster_kernel_ready(Kernel kern, size_t smem, int C) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t cluster_config(int blocks, int threads, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int C) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kern` on `blocks` blocks in clusters of C; returns the launch's
// error.
template <typename Kernel, typename... Args>
int cluster_launch(Kernel kern, int blocks, int C, int threads, size_t smem,
                   void* stream, Args... args) {
  cudaError_t e = cluster_kernel_ready(kern, smem, C);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      blocks, threads, smem, static_cast<cudaStream_t>(stream), &attr, C);
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of C blocks of `kern` the card can hold at once (>= 1), 0 when
// it can hold none, or minus a CUDA error code.
template <typename Kernel>
int cluster_capacity_of(Kernel kern, size_t smem, int C, int threads) {
  cudaError_t e = cluster_kernel_ready(kern, smem, C);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(C, threads, smem, nullptr, &attr, C);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return clusters;
}

// Launch the cluster kernel on B scenarios; returns the launch's error.
template <typename CT, int NP, bool TWO_SOLVES>
int launch_cluster_cg(const void* D, const void* b, const void* minv,
                      const void* x0, const void* lam0, const void* ud,
                      void* x_out, void* lam_out, int B, int Dz, int H,
                      int W, int iters, float scale, int C, int threads,
                      void* stream) {
  ClusterBox<CT, NP> op;
  if (!cluster_box(Dz, H, W, C, threads, op)) return cudaErrorInvalidValue;
  auto kern = cluster_cg_kernel<CT, NP, TWO_SOLVES>;
  return cluster_launch(
      kern, B * C, C, threads, cluster_smem_bytes(op), stream,
      static_cast<const CT*>(D),
      static_cast<const float*>(b), static_cast<const CT*>(minv),
      static_cast<const float*>(x0), static_cast<const float*>(lam0),
      static_cast<const float*>(ud), static_cast<float*>(x_out),
      static_cast<float*>(lam_out), op, static_cast<size_t>(B) * op.n,
      iters, scale);
}

// Clusters of this shape the card can hold at once (see
// cluster_capacity_of).
template <typename CT, int NP, bool TWO_SOLVES>
int cluster_capacity(int Dz, int H, int W, int C, int threads) {
  ClusterBox<CT, NP> op;
  if (!cluster_box(Dz, H, W, C, threads, op)) return -cudaErrorInvalidValue;
  auto kern = cluster_cg_kernel<CT, NP, TWO_SOLVES>;
  return cluster_capacity_of(kern, cluster_smem_bytes(op), C, threads);
}

}  // namespace
