// The whole edge-ELL Jacobi-PCG solve in one launch (kernel K8s).
//
// Replaces, for float32 fixed-trip solves, the per-iteration route of the
// general-mesh CG: one K8 launch (ell_apply.cu) an operator application plus
// ~18 torch launches of dots and updates an iteration.  The TPU counterpart
// is the JAX general-mesh CG, _ell_bm_impl / _ell_bm_bwd in
// difffe_tpu/ops/unstructured.py on the PCG of difffe_tpu/ops/pcg.py, left
// to XLA's gathers there (the TPU's gather probe P1 could not lower the row
// gather-sum); K8 is the port of that probe.  For n nodes, Dn neighbour
// slots and B scenarios, each scenario b solves, from x0 = 0 and for exactly
// `iters` iterations, A x = rhs with the Dirichlet-eliminated operator
//
//   (A v)[i] = m_i v_i + p_i ( diag[i,b] p_i v_i + sum_d W[i,d,b] p_j v_j ),
//              j = nbr[i,d], p = 1 - m,
//
// and the Jacobi preconditioner Minv = 1 / (m + p diag) (1 where that is
// below 1e-30 in magnitude): the PCG of cg_common.cuh, with its freeze rule
// and 0/0 -> 0.  W (n, Dn, B), diag, rhs and x (n, B), m (n,), all float32
// and contiguous: the batch-minor layout of K8, which the wrapper's callers
// fold once a step; the neighbour table nbrP (n, DMAX) int32, K8's (n, Dn)
// table padded by the wrapper to DMAX = 8 or 16 columns (padding slots
// carry W = 0 at index 0), so that a thread reads its node's indices as
// DMAX / 4 16-byte loads.
//
// Design.  cg_cluster.cuh's body with an edge-ELL operator: one cluster of
// C blocks a scenario, rank k owning nodes [k*chunk, (k+1)*chunk).  Each
// rank stages, once, its range's Dn W slots, m + p diag and Minv into shared
// memory (reading W and diag at stride B: the fold's batch-minor layout, no
// copy), so the CG loop reads no W, diag or m from device memory; x, r and
// Ap live in registers, p is double-buffered in shared memory, and a
// neighbour in another rank's range is formed through DSMEM with the
// owner's roundings (cluster_remote_p).  The mask is folded in at staging:
// m is 0/1 (FEMesh's bc_mask), so p_i p_j W[i,d] is W[i,d] where both ends
// are free and 0 elsewhere, and the row of a Dirichlet node is 1 * v_i.
// A slot whose staged weight is 0 (padding, a Dirichlet end, or a zero
// weight) reads p at the node itself: 0 * p adds nothing, as the plain
// version's 0 * p_j v_j there, and a padding slot never reads node 0 of
// another rank.  The apply is unrolled in groups of 8 slots (Dn beyond
// predicated off; DMAX is 8 or 16), so a group's weights and indices are
// all in flight at once before its p reads, instead of one dependent chain
// a slot.  The index table, shared by every scenario, is read in the loop
// from device memory through __ldg (L1/L2), two 16-byte loads a group: a
// warp's load is four contiguous lines, where Dn scalar loads at stride Dn
// would take Dn wavefronts each through L1.  (A copy of the table in each
// rank's shared memory, Dn more ints a node, needs more blocks a scenario;
// the card ran it slower at every cluster size the plan could pick.)
// Every product and sum is rounded on its own in the plain version's order
// (the slot sum in d order, then diag p v + that sum), so a run differs
// from the plain f32 run only in the order of each dot's sum, and two runs
// agree bit for bit.
//
// Shared memory a block: chunk * (12 + (Dn + 2) * 4) bytes and
// kClusterStaticBytes (64^2 triangles, Dn = 6: 185 900 B at C = 1).
//
// Bound.  Per node and iteration the apply does 2 operations a nonzero slot
// and 2 more (diag p v and the sum), the CG 11 (two dots 4, the x, r and p
// updates 6, Jacobi 1); the bytes are W, diag, rhs, nbr and m read once and
// x written once.  At 64^2, B = 256, 128 iterations that is ~3.3e9
// operations (0.05 ms at 67 TFLOP/s f32) against 39 MB (0.012 ms at
// 3.35 TB/s): bound by operations.  What paces it is what paces K3b, more
// so: the latency of the loop's dependent reads (an index, then p at the
// neighbour) and the L1/shared-memory data path, a wavefront a warp for
// each load of W, the indices and p, about twice K3b's a node, and the two
// dots an iteration.

#include <cuda_runtime.h>

#include <cstddef>

#include "cg_cluster.cuh"

namespace {

constexpr int kEllMaxSlots = 16;  // the most neighbour slots K8s takes

// The eliminated edge-ELL operator of one scenario, seen from one rank;
// Dn <= DMAX slots.
template <int DMAX>
struct ClusterEll {
  int n, Dn;                     // nodes, neighbour slots
  int ranks, chunk;              // C, nodes a rank
  int lo, end;                   // this rank's nodes [lo, end)
  const int* __restrict__ nbrP;  // (n, DMAX), device memory
  const float* planes;           // Dn W planes of chunk values, m + p diag,
                                 // Minv

  struct Cursor {
    int i;
  };

  __device__ __forceinline__ Cursor first() const {
    return Cursor{lo + static_cast<int>(threadIdx.x)};
  }

  __device__ __forceinline__ void next(Cursor& c) const { c.i += blockDim.x; }

  __device__ __forceinline__ float minv(int q) const {
    return planes[(Dn + 1) * chunk + q];
  }

  // x0 = 0, so r - A x0 = r exactly.
  __device__ __forceinline__ float residual0(const Cursor&, int, float r,
                                             float, const float*) const {
    return r;
  }

  // (A p) at the cursor's node; p is `cur` on this rank, formed as
  // cluster_remote_p on the others.
  __device__ __forceinline__ float apply(const Cursor& c, int q, float pq,
                                         float* cur, float* rs, float* prev,
                                         float beta) const {
    constexpr int G = 8;  // slots a group
    const int len = end - lo;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < DMAX; g += G) {
      const int4* row = reinterpret_cast<const int4*>(
          nbrP + static_cast<size_t>(c.i) * DMAX + g);
      const int4 a = __ldg(row), b = __ldg(row + 1);
      int j[G] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float w[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        if (g + e < Dn) {
          w[e] = planes[(g + e) * chunk + q];
          if (w[e] == 0.f) j[e] = c.i;
        }
      }
#pragma unroll
      for (int e = 0; e < G; ++e) {
        if (g + e < Dn) {
          const int o = j[e] - lo;
          const float pj =
              ranks == 1 || (o >= 0 && o < len)
                  ? cur[o]
                  : cluster_remote_p(j[e], chunk, rs,
                                     planes + (Dn + 1) * chunk, prev, beta);
          s = __fadd_rn(s, __fmul_rn(w[e], pj));
        }
      }
    }
    return __fadd_rn(__fmul_rn(planes[Dn * chunk + q], pq), s);
  }
};

template <int DMAX>
__global__ void __launch_bounds__(kClusterMaxThreads)
ell_cg_kernel(const float* __restrict__ W, const float* __restrict__ diag,
              const float* __restrict__ m, const float* __restrict__ rhs,
              float* __restrict__ x_out, ClusterEll<DMAX> op, int B,
              int iters) {
  constexpr int K = kNodesPerThread;
  extern __shared__ __align__(16) float cl_smem[];
  __shared__ float red[2][32];
  __shared__ float pub[2][kMaxCluster];
  __shared__ uint64_t bar[2];
  const int rank = static_cast<int>(blockIdx.x) % op.ranks;
  const int scen = static_cast<int>(blockIdx.x) / op.ranks;
  const int chunk = op.chunk, T = blockDim.x, Dn = op.Dn;
  op.lo = rank * chunk;
  op.end = min(op.n, op.lo + chunk);
  if (op.end < op.lo) op.end = op.lo;  // a rank past the last node
  const int len = op.end - op.lo;
  float *p0 = cl_smem, *p1 = p0 + chunk, *rs = p1 + chunk;
  float* planes = cl_smem + kClusterVecs * chunk;
  op.planes = planes;

  for (int q = threadIdx.x; q < len; q += T) {
    const int i = op.lo + q;
    const float mi = __ldg(m + i);
    const float dA = __fadd_rn(
        mi, __fmul_rn(__fsub_rn(1.f, mi),
                      __ldg(diag + static_cast<size_t>(i) * B + scen)));
    planes[Dn * chunk + q] = dA;
    planes[(Dn + 1) * chunk + q] =
        __fdiv_rn(1.f, fabsf(dA) > 1e-30f ? dA : 1.f);
    for (int d = 0; d < Dn; ++d) {
      const int j = __ldg(op.nbrP + static_cast<size_t>(i) * DMAX + d);
      const bool free_ends = mi == 0.f && __ldg(m + j) == 0.f;
      planes[d * chunk + q] =
          free_ends
              ? __ldg(W + (static_cast<size_t>(i) * Dn + d) * B + scen)
              : 0.f;
    }
  }
  float x[K], r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * T;
    x[k] = 0.f;
    r[k] = q < len ? rhs[static_cast<size_t>(op.lo + q) * B + scen] : 0.f;
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
  cluster_cg_solve(op, x, r, nullptr, p0, p1, rs, iters, dots);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * T;
    if (q < len) x_out[static_cast<size_t>(op.lo + q) * B + scen] = x[k];
  }
  if (op.ranks > 1) cluster_sync();  // no window goes away while read
}

// The operator's geometry for C ranks of `threads` threads; false when C,
// threads, Dn or the nodes a thread would hold are not what the kernel
// takes.
template <int DMAX>
bool cluster_ell(int n, int Dn, int C, int threads, ClusterEll<DMAX>& op) {
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return false;
  if (threads < 32 || threads > kClusterMaxThreads || threads % 32 != 0)
    return false;
  if (n < 1 || Dn < 1 || Dn > DMAX) return false;
  op.n = n;
  op.Dn = Dn;
  op.ranks = C;
  op.chunk = (n + C - 1) / C;
  if (op.chunk > kNodesPerThread * threads) return false;
  op.lo = op.end = 0;  // set per rank in the kernel
  op.nbrP = nullptr;
  op.planes = nullptr;
  return true;
}

template <int DMAX>
size_t ell_smem_bytes(const ClusterEll<DMAX>& op) {
  return static_cast<size_t>(op.chunk) * sizeof(float) *
         (kClusterVecs + op.Dn + 2);
}

template <int DMAX>
int launch(const void* nbrP, const void* W, const void* diag, const void* m,
           const void* rhs, void* x, int n, int Dn, int B, int iters, int C,
           int threads, void* stream) {
  ClusterEll<DMAX> op;
  if (!cluster_ell(n, Dn, C, threads, op)) return cudaErrorInvalidValue;
  op.nbrP = static_cast<const int*>(nbrP);
  auto kern = ell_cg_kernel<DMAX>;
  return cluster_launch(kern, B * C, C, threads, ell_smem_bytes(op), stream,
                        static_cast<const float*>(W),
                        static_cast<const float*>(diag),
                        static_cast<const float*>(m),
                        static_cast<const float*>(rhs),
                        static_cast<float*>(x), op, B, iters);
}

template <int DMAX>
int capacity(int n, int Dn, int C, int threads) {
  ClusterEll<DMAX> op;
  if (!cluster_ell(n, Dn, C, threads, op)) return -cudaErrorInvalidValue;
  auto kern = ell_cg_kernel<DMAX>;
  return cluster_capacity_of(kern, ell_smem_bytes(op), C, threads);
}

}  // namespace

// x (n, B) = `iters` PCG iterations from 0 on each scenario (see the
// header; nbrP is the neighbour table padded to 8 columns for Dn <= 8,
// else to 16; Dn <= 16), in clusters of `cluster` blocks of `threads`
// threads.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int difffe_ell_cg(const void* nbrP, const void* W,
                             const void* diag, const void* m, const void* rhs,
                             void* x, int n, int Dn, int B, int iters,
                             int cluster, int threads, void* stream) {
  if (B == 0) return 0;
  if (Dn <= 8)
    return launch<8>(nbrP, W, diag, m, rhs, x, n, Dn, B, iters, cluster,
                     threads, stream);
  if (Dn <= kEllMaxSlots)
    return launch<16>(nbrP, W, diag, m, rhs, x, n, Dn, B, iters, cluster,
                      threads, stream);
  return cudaErrorInvalidValue;
}

// How many clusters of `cluster` blocks of `threads` threads the card holds
// at once for n nodes and Dn slots (0: none; < 0: minus a CUDA error).
extern "C" int difffe_ell_cg_clusters(int n, int Dn, int cluster,
                                      int threads) {
  if (Dn <= 8) return capacity<8>(n, Dn, cluster, threads);
  if (Dn <= kEllMaxSlots) return capacity<16>(n, Dn, cluster, threads);
  return -cudaErrorInvalidValue;
}
