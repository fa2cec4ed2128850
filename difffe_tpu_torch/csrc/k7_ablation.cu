// K7's ablations: the port of the TPU probe scripts/probe_mxu_kernel.py
// (P2, `grad_call` and its bodies `make_kernel` / `make_kernel_packed`).
//
// Every variant computes the scalar-kappa grad step of K7 version 1
// (csrc/fused_grad_mxu.cu) on one shared load F (n,), per scenario, with
// kappa = exp(log kappa), the (8, n) unit-kappa block (m, p, d0, a0, c0,
// mg, t0, rhs0) and W the inverse of the unit-kappa eliminated system:
//
//   x = (m + p / kappa)((mg + p F) - kappa t0);  u = W x
//   loss = sum_i (u - u_data)_i^2
//   lambda = W ((m + p / kappa)(u - u_data))
//   dlog kappa = (scale kappa) * -sum_i lambda_i (t0 + a0 u_{i-1} + d0 u_i
//                                                 + c0 u_{i+1})
//
// with one thing changed, as P2's variants change it (variant A, the
// baseline, is K7 itself and lives in fused_grad_mxu.cu):
//
//   B  both products as 3xTF32 split products on the tensor cores
//      (P2: matmul precision HIGH, the TPU's 3-pass bf16 products);
//   C  both products as single-pass bf16 tensor-core products with f32
//      accumulation (P2: precision DEFAULT);
//   D  one product: lambda = (m + p / kappa)(u - u_data), wrong math,
//      timing only (P2: the adjoint product dropped);
//   E  no shifts: the contraction is sum_i lambda_i (t0 + d0 u_i), wrong
//      math, timing only (P2: no rolls);
//   F  the same math as A mapped onto the SM another way: register-blocked
//      rows (P2: W packed block-diagonally onto the 128 x 128 MXU);
//   A1 no change: D and E's kernel with nothing ablated (no P2 variant).
//
// The row work (everything but the products) rounds each product, sum and
// difference on its own in the plain PyTorch versions' order
// (difffe_tpu_torch/probes/k7_ablation.py), as K7 does.  n <= 32: the
// probe's mesh has 31 nodes, padded here to NP = 16 or 32 with zero rows
// and columns of W and zero constants, which change no result.
//
// Designs.
//
// D, E: A's design (K7's): one scenario a thread; a block of 128 stages W
// and the tiles of u_data, x and u in shared memory [row][thread]; each
// multiply-add reads W[i][j] (a broadcast) and x[j] from shared memory.
// K7 takes its body (version 1-3, refinement passes) at run time, these
// kernels at compile time, so the same kernel with nothing ablated runs
// beside them as A1, their baseline: A's math in A's order, equal to A
// bit for bit.
//
// F: register-blocked rows.  A thread keeps its scenario's x and u in
// registers (NP a template parameter), and only W^T (zero padded to
// NP x NP), the constants and the u_data tile are staged, so a block uses
// 21 KB of shared memory against K7's 84 KB at n = 31.  Each product
// walks the columns j in order and updates the rows eight at a time from
// two 16-byte broadcast loads of W^T[j][i..i+7]: one shared-memory load
// per four multiply-adds against K7's two per one.  Each u_i is still one
// running fused multiply-add over j in column order starting from 0, as
// in K7, so F's outputs equal K7 version 1's bit for bit; the parallelism
// comes from the independent rows.
//
// B, C: one warp a tile of 16 scenarios, on mma.sync.  A product is
// computed transposed, U^T (16 x NP) = X^T (16 x NP) W^T, so the
// scenarios are the M rows, W^T is the B operand (held in registers for
// the warp's life: 32 TF32 registers a pass at NP = 32, 16 for bf16) and
// a lane (groupID g = lane / 4, q = lane % 4) holds scenarios g and g + 8
// at rows 8 nn + 2q + {0, 1} of each 8-row tile nn.  That is where the
// f32 accumulator of m16n8k8 / m16n8k16 puts them; the K order of the A
// operand is permuted to the same rows (for TF32, K column q of a tile is
// row 2q and column q + 4 row 2q + 1; for bf16 the natural order already
// matches), so u's accumulator is the right-hand side of the adjoint
// product without a shuffle or a trip through shared memory.  The shifts
// u_{i -/+ 1} are shuffles inside the four lanes of a group (the edge of a
// tile comes from the neighbour tile's register of lane 3 or 0), and the
// sums over i are two xor-shuffles.  B splits each operand a = hi + lo,
// each rounded to TF32 with cvt.rna (the 13 low bits cleared), and
// accumulates lo hi + hi lo + hi hi in f32 (lo lo dropped); C rounds each
// operand to bf16 (round to nearest even).  The mapping on the card
// differs from P2's F, whose packing quadrupled the work to fill a
// 128 x 128 unit: mma tiles are 16 x 8 x 8 (TF32) or 16 x 8 x 16 (bf16),
// and a 31-node W already fills 4 x 4 (or 4 x 2) of them.
//
// Bound (at n = 31, B = 2^21, bf16 u_data): each scenario moves 74 B (log
// kappa, u_data, loss, gradient): 155 MB, 0.046 ms at 3.35 TB/s; A and F
// do 2 * 2 n^2 + 12 n + 3 operations a scenario, 0.132 ms at 67 TFLOP/s
// f32, so they are bound by operations; B and C put the products on the
// tensor cores, which run beside the f32 pipes, so their operations take
// the larger of the products' time and the row work's (0.012 ms at 67):
// B's three passes at 495 TFLOP/s TF32, 0.049 ms, leave B bound by
// operations; C's one at 989 bf16, 0.008 ms, leaves C bound by bytes.

#include "fused_step_common.cuh"

#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxNodes = 32;
// variant codes of difffe_k7_ablation (kA1: A's math in D and E's kernel)
constexpr int kB = 1, kC = 2, kD = 3, kE = 4, kF = 5, kA1 = 6;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The K7 right-hand side of row i, version 1 (csrc/fused_grad_mxu.cu).
template <typename T>
__device__ __forceinline__ T rhs(T m, T p, T mg, T t0, T f, T kappa,
                                 T kinv) {
  const T r = sub(add(mg, mul(p, f)), mul(kappa, t0));
  return mul(add(m, mul(p, kinv)), r);
}

// The four-term contraction term of row i, K7's order.
template <typename T>
__device__ __forceinline__ T term4(T t0, T a0, T d0, T c0, T um1, T u,
                                   T up1) {
  return add(add(add(t0, mul(a0, um1)), mul(d0, u)), mul(c0, up1));
}

// ---------------------------------------------------------------------------
// D and E: K7's design
// ---------------------------------------------------------------------------

template <typename T, typename TU, int V>
__global__ void __launch_bounds__(kBlock)
staged_kernel(const T* __restrict__ lk, long long sL,
              const T* __restrict__ F, const TU* __restrict__ ud,
              long long sU, const T* __restrict__ cols,
              const T* __restrict__ Wg, T* __restrict__ loss,
              T* __restrict__ grad, int B, int n, T scale) {
  extern __shared__ __align__(16) unsigned char staged_smem[];
  const int tb = blockDim.x, t = threadIdx.x, P = tb + 1;
  const long long s0 = static_cast<long long>(blockIdx.x) * tb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < tb ? static_cast<int>(left) : tb;
  const long long g = s0 + t;
  T* W = reinterpret_cast<T*>(staged_smem);
  T* UD = W + n * n;
  T* X = UD + n * P;
  T* U = X + n * P;

  for (int k = t; k < n * n; k += tb) W[k] = Wg[k];
  for (int k = t; k < nsc * n; k += tb) {
    const int s = k / n, i = k - s * n;
    UD[i * P + s] = load<T>(ud, (s0 + s) * sU + i);
  }
  __syncthreads();
  if (t >= nsc) return;

  const T zero = T(0), one = T(1);
  const T *cm = cols, *cp = cols + n, *cd0 = cols + 2 * n,
          *ca0 = cols + 3 * n, *cc0 = cols + 4 * n, *cmg = cols + 5 * n,
          *ct0 = cols + 6 * n;
  auto wrow = [&](int i, const T* v) -> T {
    const T* w = W + i * n;
    T acc = zero;
    for (int j = 0; j < n; ++j) acc = fmadd(w[j], v[j * P + t], acc);
    return acc;
  };
  auto nb = [&](const T* v, int i) -> T {
    return i < 0 || i >= n ? zero : v[i * P + t];
  };

  const T kappa = expo(lk[g * sL]);
  const T kinv = quot(one, kappa);
  for (int i = 0; i < n; ++i)
    X[i * P + t] = rhs(cm[i], cp[i], cmg[i], ct0[i], F[i], kappa, kinv);
  for (int i = 0; i < n; ++i) U[i * P + t] = wrow(i, X);
  T acc = zero;
  for (int i = 0; i < n; ++i) {
    const T d = sub(U[i * P + t], UD[i * P + t]);
    acc = add(acc, mul(d, d));
    X[i * P + t] = mul(add(cm[i], mul(cp[i], kinv)), d);
  }
  loss[g] = acc;

  T gacc = zero;
  for (int i = 0; i < n; ++i) {
    const T lam = V == kD ? X[i * P + t] : wrow(i, X);
    const T term =
        V == kE ? add(ct0[i], mul(cd0[i], U[i * P + t]))
                : term4(ct0[i], ca0[i], cd0[i], cc0[i], nb(U, i - 1),
                        U[i * P + t], nb(U, i + 1));
    gacc = add(gacc, mul(lam, term));
  }
  grad[g] = mul(mul(scale, kappa), -gacc);
}

// ---------------------------------------------------------------------------
// F: register-blocked rows
// ---------------------------------------------------------------------------

template <typename T>
struct Quad {
  T a, b, c, d;
};
// Four values from shared memory in one 16-byte load, as a volatile asm:
// plain loads of W^T would be merged between the two products by the
// compiler, which then keeps all of W live across the row work and spills
// it (measured: 4.4 KB of stack a thread at NP = 32).
__device__ __forceinline__ Quad<float> load4(const float* p) {
  Quad<float> r;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.a), "=f"(r.b), "=f"(r.c), "=f"(r.d)
               : "r"(a));
  return r;
}
__device__ __forceinline__ Quad<double> load4(const double* p) {
  Quad<double> r;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(r.a), "=d"(r.b)
               : "r"(a));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(r.c), "=d"(r.d)
               : "r"(a + 16));
  return r;
}

// (W x)_{i0 .. i0+7}: eight running fused multiply-adds over the columns
// in order, from 0, each W^T[j][i0..i0+7] two broadcast loads.
template <typename T, int NP>
__device__ __forceinline__ void rows8(const T* Wt, const T (&x)[NP], int i0,
                                      T (&r)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) r[q] = T(0);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const Quad<T> w0 = load4(Wt + j * NP + i0);
    const Quad<T> w1 = load4(Wt + j * NP + i0 + 4);
    r[0] = fmadd(w0.a, x[j], r[0]);
    r[1] = fmadd(w0.b, x[j], r[1]);
    r[2] = fmadd(w0.c, x[j], r[2]);
    r[3] = fmadd(w0.d, x[j], r[3]);
    r[4] = fmadd(w1.a, x[j], r[4]);
    r[5] = fmadd(w1.b, x[j], r[5]);
    r[6] = fmadd(w1.c, x[j], r[6]);
    r[7] = fmadd(w1.d, x[j], r[7]);
  }
}

// At most 128 registers in f32, four blocks (16 warps) an SM: uncapped,
// ptxas took all 255 (8 warps an SM) and still spilled at NP = 32; capped,
// it spills 352 bytes a thread there (ptxas -v).
template <typename T, typename TU, int NP>
__global__ void __launch_bounds__(kBlock, sizeof(T) == sizeof(float) ? 4 : 1)
rows_kernel(const T* __restrict__ lk, long long sL, const T* __restrict__ F,
            const TU* __restrict__ ud, long long sU,
            const T* __restrict__ cols, const T* __restrict__ Wg,
            T* __restrict__ loss, T* __restrict__ grad, int B, int n,
            T scale) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  const int tb = blockDim.x, t = threadIdx.x, P = tb + 1;
  const long long s0 = static_cast<long long>(blockIdx.x) * tb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < tb ? static_cast<int>(left) : tb;
  const long long g = s0 + t;
  T* Wt = reinterpret_cast<T*>(rows_smem);  // [NP][NP], W^T, zero padded
  T* cs = Wt + NP * NP;    // [8][NP]: m, p, d0, a0, c0, mg, t0 and F
  T* UD = cs + 8 * NP;     // [n][P]

  for (int k = t; k < NP * NP; k += tb) {
    const int j = k / NP, i = k - j * NP;
    Wt[k] = i < n && j < n ? Wg[i * n + j] : T(0);
  }
  for (int k = t; k < 8 * NP; k += tb) {
    const int r = k / NP, i = k - r * NP;
    cs[k] = i < n ? (r < 7 ? cols[r * n + i] : F[i]) : T(0);
  }
  for (int k = t; k < nsc * n; k += tb) {
    const int s = k / n, i = k - s * n;
    UD[i * P + s] = load<T>(ud, (s0 + s) * sU + i);
  }
  __syncthreads();
  if (t >= nsc) return;

  const T *cm = cs, *cp = cs + NP, *cd0 = cs + 2 * NP, *ca0 = cs + 3 * NP,
          *cc0 = cs + 4 * NP, *cmg = cs + 5 * NP, *ct0 = cs + 6 * NP,
          *cf = cs + 7 * NP;
  const T zero = T(0);
  const T kappa = expo(lk[g * sL]);
  const T kinv = quot(T(1), kappa);

  T x[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    x[i] = i < n ? rhs(cm[i], cp[i], cmg[i], ct0[i], cf[i], kappa, kinv)
                 : zero;
  T u[NP];
#pragma unroll
  for (int i0 = 0; i0 < NP; i0 += 8) {
    T r[8];
    rows8<T, NP>(Wt, x, i0, r);
#pragma unroll
    for (int q = 0; q < 8; ++q) u[i0 + q] = r[q];
  }
  T acc = zero;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i < n) {
      const T d = sub(u[i], UD[i * P + t]);
      acc = add(acc, mul(d, d));
      x[i] = mul(add(cm[i], mul(cp[i], kinv)), d);
    }
  }
  loss[g] = acc;
  // lambda eight rows at a time, each row's term formed from u where it is
  // folded into the sum, in row order
  T gacc = zero;
#pragma unroll
  for (int i0 = 0; i0 < NP; i0 += 8) {
    T lam[8];
    rows8<T, NP>(Wt, x, i0, lam);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q;
      if (i < n) {
        const T um1 = i > 0 ? u[i > 0 ? i - 1 : 0] : zero;
        const T up1 = i + 1 < n ? u[i + 1 < NP ? i + 1 : i] : zero;
        gacc = add(gacc, mul(lam[q], term4(ct0[i], ca0[i], cd0[i], cc0[i],
                                           um1, u[i], up1)));
      }
    }
  }
  grad[g] = mul(mul(scale, kappa), -gacc);
}

// ---------------------------------------------------------------------------
// B and C: tensor-core products
// ---------------------------------------------------------------------------

constexpr uint32_t kTf32Mask = 0xffffe000u;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & kTf32Mask;
}

// x = hi + lo, each rounded to TF32 (lo from the exact f32 residual)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W^T as the B operand of every (nn, kk) tile, in registers.  TF32 (B):
// K tiles of 8 with K column q at row 8 kk + 2q and q + 4 at 8 kk + 2q + 1,
// hi and lo parts; bf16 (C): K tiles of 16 in natural order.
template <int V, int NT>
struct WFrag {
  static constexpr int NK = V == kB ? NT : NT / 2;
  uint32_t hi[NT][NK][2];
  uint32_t lo[V == kB ? NT : 1][V == kB ? NK : 1][2];

  __device__ __forceinline__ void load(const float* __restrict__ Wg, int n,
                                       int g, int q) {
    auto w = [&](int i, int j) -> float {
      return i < n && j < n ? Wg[i * n + j] : 0.0f;
    };
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const int i = 8 * nn + g;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if constexpr (V == kB) {
          split_tf32(w(i, 8 * kk + 2 * q), hi[nn][kk][0], lo[nn][kk][0]);
          split_tf32(w(i, 8 * kk + 2 * q + 1), hi[nn][kk][1], lo[nn][kk][1]);
        } else {
          const int j = 16 * kk + 2 * q;
          hi[nn][kk][0] = bf16x2_bits(w(i, j), w(i, j + 1));
          hi[nn][kk][1] = bf16x2_bits(w(i, j + 8), w(i, j + 9));
        }
      }
    }
  }
};

// acc[nn][e'] = (X^T W^T) of the warp's 16 scenarios, where the lane's
// values v[nn][s][e] sit at scenario g + 8 s and row 8 nn + 2 q + e; acc
// comes back in the same layout: acc[nn][2 s + e].  Each K tile's product
// goes onto a zero accumulator and the tiles' partials are summed in f32,
// rounded to nearest: one accumulator carried over the K tiles, added to
// in the tensor cores' own rounding, missed phase 7's rule (chip_smoke) on
// B's gradient.  B's two small passes (2^-11 of the result) share one
// accumulator over the tiles.
template <int V, int NT>
__device__ __forceinline__ void product(const WFrag<V, NT>& wf,
                                        const float (&v)[NT][2][2],
                                        float (&acc)[NT][4]) {
  float small[NT][4];
#pragma unroll
  for (int nn = 0; nn < NT; ++nn)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nn][c] = small[nn][c] = 0.0f;
  if constexpr (V == kB) {
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      // A: a0 (scenario g, column q), a1 (g + 8, q), a2 (g, q + 4),
      // a3 (g + 8, q + 4); columns q, q + 4 are rows 8 kk + 2q, + 1
      uint32_t ahi[4], alo[4];
      split_tf32(v[kk][0][0], ahi[0], alo[0]);
      split_tf32(v[kk][1][0], ahi[1], alo[1]);
      split_tf32(v[kk][0][1], ahi[2], alo[2]);
      split_tf32(v[kk][1][1], ahi[3], alo[3]);
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(small[nn], alo, wf.hi[nn][kk][0], wf.hi[nn][kk][1]);
        mma_tf32(small[nn], ahi, wf.lo[nn][kk][0], wf.lo[nn][kk][1]);
        mma_tf32(part, ahi, wf.hi[nn][kk][0], wf.hi[nn][kk][1]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nn][c] = add(acc[nn][c], part[c]);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nn][c] = add(small[nn][c], acc[nn][c]);
  } else {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      // A: a0 (g, columns 2q, 2q + 1), a1 (g + 8, the same), a2 (g,
      // 2q + 8, 2q + 9), a3 (g + 8, the same) of rows 16 kk + column
      const uint32_t a[4] = {
          bf16x2_bits(v[2 * kk][0][0], v[2 * kk][0][1]),
          bf16x2_bits(v[2 * kk][1][0], v[2 * kk][1][1]),
          bf16x2_bits(v[2 * kk + 1][0][0], v[2 * kk + 1][0][1]),
          bf16x2_bits(v[2 * kk + 1][1][0], v[2 * kk + 1][1][1])};
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a, wf.hi[nn][kk][0], wf.hi[nn][kk][1]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nn][c] = add(acc[nn][c], part[c]);
      }
    }
  }
}

// Sum over the four lanes of a group.
__device__ __forceinline__ float group_sum(float v) {
  v = add(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return add(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <typename TU, int V, int NT>
__global__ void __launch_bounds__(kBlock)
tc_kernel(const float* __restrict__ lk, long long sL,
          const float* __restrict__ F, const TU* __restrict__ ud,
          long long sU, const float* __restrict__ cols,
          const float* __restrict__ Wg, float* __restrict__ loss,
          float* __restrict__ grad, int B, int n, float scale) {
  constexpr int NP = 8 * NT;
  // rows m, p, d0, a0, c0, mg, t0 and F, zero padded to NP
  __shared__ float cs[8][NP];
  for (int k = threadIdx.x; k < 8 * NP; k += blockDim.x) {
    const int r = k / NP, i = k - r * NP;
    cs[r][i] = i < n ? (r < 7 ? cols[r * n + i] : F[i]) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  WFrag<V, NT> wf;
  wf.load(Wg, n, g, q);
  const long long tiles = (static_cast<long long>(B) + 15) / 16;
  const long long warps = static_cast<long long>(gridDim.x) * (kBlock / 32);
  const unsigned full = 0xffffffffu;

  for (long long tile = static_cast<long long>(blockIdx.x) * (kBlock / 32) +
                        (threadIdx.x >> 5);
       tile < tiles; tile += warps) {
    long long sc[2];
    bool ok[2];
    float kappa[2], kinv[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sc[s] = tile * 16 + g + 8 * s;
      ok[s] = sc[s] < B;
      kappa[s] = expo(ok[s] ? lk[sc[s] * sL] : 0.0f);
      kinv[s] = quot(1.0f, kappa[s]);
    }
    // x at scenario g + 8 s, row 8 nn + 2 q + e
    float v[NT][2][2];
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * nn + 2 * q + e;
#pragma unroll
        for (int s = 0; s < 2; ++s)
          v[nn][s][e] = i < n ? rhs(cs[0][i], cs[1][i], cs[5][i], cs[6][i],
                                    cs[7][i], kappa[s], kinv[s])
                              : 0.0f;
      }
    float acc[NT][4];
    product<V, NT>(wf, v, acc);
    float u[NT][2][2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * nn + 2 * q + e;
          u[nn][s][e] = acc[nn][2 * s + e];
          float d = 0.0f;
          if (i < n && ok[s])
            d = sub(u[nn][s][e], load<float>(ud, sc[s] * sU + i));
          lsum[s] = add(lsum[s], mul(d, d));
          v[nn][s][e] = mul(add(cs[0][i], mul(cs[1][i], kinv[s])), d);
        }
    product<V, NT>(wf, v, acc);  // lambda
    float gsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // u_{i-1} of row 8 nn + 2q: lane q - 1's odd row, or at q = 0
        // lane 3's odd row of tile nn - 1; u_{i+1} of row 8 nn + 2q + 1:
        // lane q + 1's even row, or at q = 3 lane 0's of tile nn + 1
        const float odd_prev = __shfl_sync(full, u[nn][s][1], (q + 3) & 3, 4);
        const float odd_wrap =
            __shfl_sync(full, u[nn > 0 ? nn - 1 : 0][s][1], 3, 4);
        const float even_next =
            __shfl_sync(full, u[nn][s][0], (q + 1) & 3, 4);
        const float even_wrap =
            __shfl_sync(full, u[nn + 1 < NT ? nn + 1 : nn][s][0], 0, 4);
        const float um1 = q > 0 ? odd_prev : odd_wrap;
        const float up1 = q < 3 ? even_next : even_wrap;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * nn + 2 * q + e;
          if (i < n) {
            // u_{i-1} and u_{i+1}, 0 outside the rows (K7's nb)
            const float lo = i == 0 ? 0.0f : (e == 0 ? um1 : u[nn][s][0]);
            const float hi =
                i + 1 >= n ? 0.0f : (e == 0 ? u[nn][s][1] : up1);
            const float term = term4(cs[6][i], cs[3][i], cs[2][i], cs[4][i],
                                     lo, u[nn][s][e], hi);
            gsum[s] = add(gsum[s], mul(acc[nn][2 * s + e], term));
          }
        }
      }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float l = group_sum(lsum[s]);
      const float gk = group_sum(gsum[s]);
      if (q == s && ok[s]) {
        loss[sc[s]] = l;
        grad[sc[s]] = mul(mul(scale, kappa[s]), -gk);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename TU>
int launch_t(int variant, const void* lk, long long sL, const void* F,
             const void* ud, long long sU, const void* cols, const void* W,
             void* loss, void* grad, int B, int n, int np, double scale,
             cudaStream_t st) {
  const T* lk_ = static_cast<const T*>(lk);
  const T* F_ = static_cast<const T*>(F);
  const TU* ud_ = static_cast<const TU*>(ud);
  const T* cols_ = static_cast<const T*>(cols);
  const T* W_ = static_cast<const T*>(W);
  T* loss_ = static_cast<T*>(loss);
  T* grad_ = static_cast<T*>(grad);
  const T sc = T(scale);
  const int blocks = (B + kBlock - 1) / kBlock;
  const size_t P = kBlock + 1;
  if (variant == kD || variant == kE || variant == kA1) {
    const size_t smem = sizeof(T) * (static_cast<size_t>(n) * n + 3 * n * P);
    auto kern = variant == kD   ? staged_kernel<T, TU, kD>
                : variant == kE ? staged_kernel<T, TU, kE>
                                : staged_kernel<T, TU, kA1>;
    return launch_with_smem(kern, blocks, kBlock, smem, st, lk_, sL, F_, ud_,
                            sU, cols_, W_, loss_, grad_, B, n, sc);
  }
  if (variant == kF) {
    const size_t smem =
        sizeof(T) * (static_cast<size_t>(np) * np + 8 * np + n * P);
    auto kern = np == 16 ? rows_kernel<T, TU, 16> : rows_kernel<T, TU, 32>;
    return launch_with_smem(kern, blocks, kBlock, smem, st, lk_, sL, F_, ud_,
                            sU, cols_, W_, loss_, grad_, B, n, sc);
  }
  if constexpr (sizeof(T) == sizeof(float)) {
    // B, C: a warp a tile of 16 scenarios, grid-stride over the tiles
    const long long tiles = (static_cast<long long>(B) + 15) / 16;
    const long long need = (tiles + kBlock / 32 - 1) / (kBlock / 32);
    const int sms = device_attribute<cudaDevAttrMultiProcessorCount>();
    if (sms <= 0) return cudaErrorInvalidDevice;
    const long long cap = 16LL * sms;
    const int tc_blocks = static_cast<int>(need < cap ? need : cap);
    auto kern = variant == kB
                    ? (np == 16 ? tc_kernel<TU, kB, 2> : tc_kernel<TU, kB, 4>)
                    : (np == 16 ? tc_kernel<TU, kC, 2> : tc_kernel<TU, kC, 4>);
    return launch_with_smem(kern, tc_blocks, kBlock, 0, st, lk_, sL, F_, ud_,
                            sU, cols_, W_, loss_, grad_, B, n, sc);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One ablated grad step (variant 1-6: B, C, D, E, F, A1) for B scenarios of
// n <= 32 nodes: lk the log kappa (B,) with stride sL; F the shared load
// (n,); u_data (B, n) rows with unit stride along n and batch stride sU,
// stored as the compute type (u_code 0) or bf16 (1); cols the (8, n)
// unit-kappa block; W (n, n) row-major.  Writes loss (B,) and grad (B,).
// float32, or float64 when `is_double` (D, E, F and A1 only).  B, C and F
// pad n to NP = 16 or 32, the least that holds it.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernels do not take.
extern "C" int difffe_k7_ablation(int variant, const void* lk, long long sL,
                                  const void* F, const void* ud,
                                  long long sU, int u_code, const void* cols,
                                  const void* W, void* loss, void* grad,
                                  int B, int n, double scale,
                                  int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = n <= 16 ? 16 : 32;
  if (variant < kB || variant > kA1 || B < 1 || n < 1 || n > kMaxNodes ||
      u_code < 0 || u_code > 1 ||
      (is_double && (variant == kB || variant == kC)))
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (is_double)
    return u_code ? launch_t<double, bf16>(variant, lk, sL, F, ud, sU, cols,
                                           W, loss, grad, B, n, np, scale, st)
                  : launch_t<double, double>(variant, lk, sL, F, ud, sU, cols,
                                             W, loss, grad, B, n, np, scale,
                                             st);
  return u_code ? launch_t<float, bf16>(variant, lk, sL, F, ud, sU, cols, W,
                                        loss, grad, B, n, np, scale, st)
                : launch_t<float, float>(variant, lk, sL, F, ud, sU, cols, W,
                                         loss, grad, B, n, np, scale, st);
}
