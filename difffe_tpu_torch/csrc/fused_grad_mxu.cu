// The scalar-kappa 1D grad step as dense products with W = A~^-1 (kernel
// K7).
//
// Replaces the Pallas TPU kernel of
// difffe_tpu/ops/pallas/fused_grad_mxu_kernel.py: the bodies _mxu_body,
// _mxu_body_v2 and _mxu_body_v3 behind _mxu_pallas.  Per scenario, with
// kappa = exp(log kappa), the (8, n) unit-kappa block (m, p, d0, a0, c0,
// mg, t0, rhs0) and W the inverse of the unit-kappa eliminated system:
//
//   version 1: x = (m + p / kappa)((mg + p F) - kappa t0);  u = W x
//              lambda = W ((m + p / kappa)(u - u_data))
//              dlog kappa = (scale kappa) * -sum_i lambda_i (t0 + a0 u_{i-1}
//                                                + d0 u_i + c0 u_{i+1})
//   version 2: x = rhs0 + (1 / kappa) p F;  u = W x;  lambda as above;
//              dlog kappa = -scale * sum_i lambda_i p_i F_i
//   version 3: version 2, each solve followed by `refine` passes
//              u += W (y - T1 u),  T1 u = (m + d0) u + a0 u_{i-1} + c0 u_{i+1},
//              the residual y - T1 u formed in double and rounded once
//   loss = sum_i (u - u_data)_i^2
//
// The elementwise work is the plain PyTorch version's
// (difffe_tpu_torch/ops/kernels/fused_grad_mxu_kernel.py), each operation
// in its order and rounded on its own.  Two routes, which the wrapper's
// plan (k7_plan) picks from the dtype and n:
//
// "tc" (float32, n <= 32): tensor-core products, the TPU's own split.
// Versions 1 and 2 take 3xTF32 products, the counterpart of the TPU's
// Precision.HIGHEST multi-pass products; version 3 single-pass bf16
// m16n8k16 products (the TPU's DEFAULT) repaired by its refinement
// passes.  One warp a tile of 16 scenarios on mma.sync (mma_frag.cuh):
// the scenarios are the M rows, W^T the B operand in registers for the
// warp's life, u's f32 accumulator the adjoint product's A operand as it
// stands; the shifts u_{i-/+1} are 4-lane shuffles and the sums over i
// xor-shuffles.  A tile's u_data and streamed
// F are one contiguous span of the (B, n) row-major planes (16 n values),
// staged into the warp's own shared memory by 16-byte cp.async, double
// buffered: the next tile's copy is in flight while this one computes.  A
// persistent grid (the card's resident blocks, from the occupancy API)
// walks the tiles.  Every version, storage (f32 or bf16 u_data and F;
// shared or streamed F) and padding (NP = 16 or 32) is its own compiled
// body.
//
// "fma" (float64, and 32 < n <= 136): the first design.  One thread owns
// one scenario: a block of `tb` scenarios stages W (n^2 values, 3.8 KB at
// n = 31 in float32, 74 KB at n = 136) and its tiles of u_data and F, read
// as the caller holds them, (B, n) row-major, with coalesced loads, into
// shared memory transposed to [row][thread] (pitch tb + 1: no bank
// conflicts); a shared F (batch stride 0) is read in place.  The x, u and
// residual rows sit beside them in the same layout.  Each product is a
// running sum of fused multiply-adds in column order, full float32 or
// float64, reading W[i][j] (a broadcast) and x[j] of its own column.  tb
// is the largest power of two up to 128 whose arrays fit the block's
// shared memory.
//
// Bound: the step must read log kappa, u_data and a streamed F and write
// the loss and gradient: (2n + 3) values a scenario, 260 B at n = 31 in
// float32.  It does 2 n^2 multiply-adds a product, two products (v1, v2)
// or 2 (1 + refine) (v3), ~4.2 k operations a scenario at n = 31 for v2,
// plus ~12 n row operations.  On the tensor cores (TF32 495, bf16 989
// TFLOP/s), beside the row work on the f32 pipes, bytes bound v2; v3's
// float64 residual (7 operations a row and pass) runs on the float64
// pipes at half the f32 rate and may bound the bench row.  The fma route
// is paced by its two shared-memory loads a multiply-add.

#include <cstdint>

#include "fused_step_common.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kMaxBlock = 128;
constexpr int kRows = 5;  // u_data, F, x, u, residual rows per thread

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
template <typename T>
__device__ __forceinline__ double wide(T x) {
  return static_cast<double>(x);
}

template <typename T, typename TF, typename TU>
__global__ void __launch_bounds__(kMaxBlock)
mxu_kernel(const T* __restrict__ lk, long long sL, const TF* __restrict__ F,
           long long sF, const TU* __restrict__ ud, long long sU,
           const T* __restrict__ cols, const T* __restrict__ Wg,
           T* __restrict__ loss, T* __restrict__ grad, int B, int n,
           int version, int refine, T scale) {
  extern __shared__ unsigned char smem_raw[];
  const int tb = blockDim.x, t = threadIdx.x, P = tb + 1;
  const long long s0 = static_cast<long long>(blockIdx.x) * tb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < tb ? static_cast<int>(left) : tb;
  const long long g = s0 + t;
  T* W = reinterpret_cast<T*>(smem_raw);
  T* UD = W + n * n;
  T* FT = UD + n * P;
  T* X = FT + n * P;
  T* U = X + n * P;
  T* R = U + n * P;

  for (int k = t; k < n * n; k += tb) W[k] = Wg[k];
  for (int k = t; k < nsc * n; k += tb) {
    const int s = k / n, i = k - s * n;
    UD[i * P + s] = load<T>(ud, (s0 + s) * sU + i);
    if (sF != 0) FT[i * P + s] = load<T>(F, (s0 + s) * sF + i);
  }
  __syncthreads();
  if (t >= nsc) return;

  const T zero = T(0), one = T(1);
  const T *cm = cols, *cp = cols + n, *cd0 = cols + 2 * n,
          *ca0 = cols + 3 * n, *cc0 = cols + 4 * n, *cmg = cols + 5 * n,
          *ct0 = cols + 6 * n, *crhs0 = cols + 7 * n;
  auto f = [&](int i) -> T {
    return sF == 0 ? load<T>(F, i) : FT[i * P + t];
  };
  // (W v)_i, a running fused multiply-add over the columns
  auto wrow = [&](int i, const T* v) -> T {
    const T* w = W + i * n;
    T acc = zero;
    for (int j = 0; j < n; ++j) acc = fmadd(w[j], v[j * P + t], acc);
    return acc;
  };
  auto nb = [&](const T* v, int i) -> T {  // v_i, 0 outside the rows
    return i < 0 || i >= n ? zero : v[i * P + t];
  };
  // out = W y, then `passes` residual refinements (v3)
  auto solve = [&](const T* y, T* out, int passes) {
    for (int i = 0; i < n; ++i) out[i * P + t] = wrow(i, y);
    for (int it = 0; it < passes; ++it) {
      for (int i = 0; i < n; ++i) {
        const double t1 = add(
            add(mul(wide(add(cm[i], cd0[i])), wide(out[i * P + t])),
                mul(wide(ca0[i]), wide(nb(out, i - 1)))),
            mul(wide(cc0[i]), wide(nb(out, i + 1))));
        R[i * P + t] = static_cast<T>(sub(wide(y[i * P + t]), t1));
      }
      for (int i = 0; i < n; ++i)
        out[i * P + t] = add(out[i * P + t], wrow(i, R));
    }
  };

  const T kappa = expo(lk[g * sL]);
  const T kinv = quot(one, kappa);
  for (int i = 0; i < n; ++i) {
    if (version == 1) {
      const T r = sub(add(cmg[i], mul(cp[i], f(i))), mul(kappa, ct0[i]));
      X[i * P + t] = mul(add(cm[i], mul(cp[i], kinv)), r);
    } else {
      X[i * P + t] = add(crhs0[i], mul(kinv, mul(cp[i], f(i))));
    }
  }
  const int passes = version == 3 ? refine : 0;
  solve(X, U, passes);
  T acc = zero;
  for (int i = 0; i < n; ++i) {
    const T d = sub(U[i * P + t], UD[i * P + t]);
    acc = add(acc, mul(d, d));
    X[i * P + t] = mul(add(cm[i], mul(cp[i], kinv)), d);
  }
  loss[g] = acc;

  T gacc = zero;
  if (version == 1) {
    // lambda row by row against the four-term contraction of u
    for (int i = 0; i < n; ++i) {
      const T term = add(add(add(ct0[i], mul(ca0[i], nb(U, i - 1))),
                             mul(cd0[i], U[i * P + t])),
                         mul(cc0[i], nb(U, i + 1)));
      gacc = add(gacc, mul(wrow(i, X), term));
    }
    grad[g] = mul(mul(scale, kappa), -gacc);
    return;
  }
  solve(X, U, passes);  // lambda
  for (int i = 0; i < n; ++i)
    gacc = add(gacc, mul(U[i * P + t], mul(cp[i], f(i))));
  grad[g] = mul(-scale, gacc);
}

size_t smem_bytes(int n, int tb, int itemsize) {
  const size_t w = static_cast<size_t>(n) * n;
  return static_cast<size_t>(itemsize) *
         (w + static_cast<size_t>(kRows) * n * (tb + 1));
}

template <typename T, typename TF, typename TU>
int launch_t(const void* lk, long long sL, const void* F, long long sF,
             const void* ud, long long sU, const void* cols, const void* W,
             void* loss, void* grad, int B, int n, int block_lanes,
             int version, int refine, double scale, cudaStream_t stream) {
  if (n < 1 || B < 1 || block_lanes < 1 || version < 1 || version > 3 ||
      refine < 0)
    return cudaErrorInvalidValue;
  const size_t cap = static_cast<size_t>(smem_optin_bytes());
  int tb = block_lanes < kMaxBlock ? block_lanes : kMaxBlock;
  while (tb > 1 && smem_bytes(n, tb, sizeof(T)) > cap) tb /= 2;
  const size_t smem = smem_bytes(n, tb, sizeof(T));
  if (smem > cap) return cudaErrorInvalidValue;
  const int blocks = (B + tb - 1) / tb;
  return launch_with_smem(
      mxu_kernel<T, TF, TU>, blocks, tb, smem, stream,
      static_cast<const T*>(lk), sL, static_cast<const TF*>(F), sF,
      static_cast<const TU*>(ud), sU, static_cast<const T*>(cols),
      static_cast<const T*>(W), static_cast<T*>(loss), static_cast<T*>(grad),
      B, n, version, refine, T(scale));
}

template <typename T>
int launch(const void* lk, long long sL, const void* F, long long sF,
           int f_code, const void* ud, long long sU, int u_code,
           const void* cols, const void* W, void* loss, void* grad, int B,
           int n, int block_lanes, int version, int refine, double scale,
           cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (f_code == 0 && u_code == 0)
    return launch_t<T, T, T>(lk, sL, F, sF, ud, sU, cols, W, loss, grad, B,
                             n, block_lanes, version, refine, scale, st);
  if (f_code == 0 && u_code == 1)
    return launch_t<T, T, bf16>(lk, sL, F, sF, ud, sU, cols, W, loss, grad,
                                B, n, block_lanes, version, refine, scale,
                                st);
  if (f_code == 1 && u_code == 1)
    return launch_t<T, bf16, bf16>(lk, sL, F, sF, ud, sU, cols, W, loss,
                                   grad, B, n, block_lanes, version, refine,
                                   scale, st);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The "tc" route
// ---------------------------------------------------------------------------

constexpr int kTcBlock = 128;  // four warps, a tile of 16 scenarios each
constexpr int kTcWarps = kTcBlock / 32;
constexpr int kTcTile = 16;
constexpr int kTcMaxNodes = 32;
// how a tile meets F: one row shared by the batch (a table beside the
// constants), or streamed rows stored as f32 or bf16
constexpr int kFShared = 0, kFF32 = 1, kFBf16 = 2;
// constant rows of the table: m, p, d0, a0, c0, mg, t0, rhs0, shared F
constexpr int kRowM = 0, kRowP = 1, kRowD0 = 2, kRowA0 = 3, kRowC0 = 4,
              kRowMg = 5, kRowT0 = 6, kRowRhs0 = 7, kRowF = 8, kCsRows = 9;

template <int FM>
struct FStore {
  using type = float;
};
template <>
struct FStore<kFBf16> {
  using type = __nv_bfloat16;
};

// Register budget: 3xTF32 keeps W^T's hi and lo parts (64 registers at
// NP = 32) and version 1 also u for its shifts.
template <int V>
constexpr int kTcMinBlocks = V == 1 ? 2 : 3;

struct TcArgs {
  const float* lk;
  long long sL;
  const void* F;  // (n,) shared (sF = 0), or (B, n) rows
  long long sF;
  int f_code;  // storage of a shared F: 0 f32, 1 bf16
  const void* ud;
  long long sU;
  const float* cols;
  const float* W;
  float* loss;
  float* grad;
  int B, n, refine;
  float scale;
  bool vec_u, vec_f;  // the plane is contiguous and 16-byte aligned
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Stage `rows` scenarios of a (B, n) plane with batch stride `stride`,
// from scenario s0, into dst (rows * n values, row-major).  A contiguous,
// 16-byte aligned plane (`vec`) goes by 16-byte cp.async (a tile's span is
// 16 n values, a multiple of 16 bytes), its ragged end and any other
// layout (a shared row: stride 0) by plain loads.
template <typename S>
__device__ __forceinline__ void stage(S* dst, const S* __restrict__ src,
                                      long long s0, int rows, int n,
                                      long long stride, bool vec, int lane) {
  const int count = rows * n;
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(S));
    const S* base = src + s0 * n;
    const int chunks = count / kPer;
    for (int c = lane; c < chunks; c += 32)
      cp_async16(dst + c * kPer, base + c * kPer);
    for (int k = chunks * kPer + lane; k < count; k += 32) dst[k] = base[k];
  } else {
    for (int k = lane; k < count; k += 32) {
      const int s = k / n;
      dst[k] = src[(s0 + s) * stride + (k - s * n)];
    }
  }
}

// Shared memory of a block: version 3's double rows, the constant table and
// each warp's two buffers of a tile's u_data and streamed F.
template <int V, int NT, typename TU, int FM>
size_t tc_smem_bytes(int n) {
  using TF = typename FStore<FM>::type;
  constexpr int NP = 8 * NT;
  const int span_u = round16(kTcTile * n * static_cast<int>(sizeof(TU)));
  const int span_f = FM == kFShared
                         ? 0
                         : round16(kTcTile * n * static_cast<int>(sizeof(TF)));
  return (V == 3 ? 3 * NP * sizeof(double) : 0) +
         kCsRows * NP * sizeof(float) +
         static_cast<size_t>(kTcWarps) * 2 * (span_u + span_f);
}

// r = y - T1 u of a version 3 refinement pass, T1 u = (m + d0) u +
// a0 u_{i-1} + c0 u_{i+1} in double, rounded once to float.  Each product
// of two floats is exact in double, so the fused multiply-adds round as
// the plain version's products and sums.  dcs holds (m + d0), a0 and c0 as
// doubles, [3][NP].
template <int NT>
__device__ __forceinline__ void residual(const float (&y)[NT][2][2],
                                         const float (&u)[NT][2][2],
                                         float (&r)[NT][2][2],
                                         const double* __restrict__ dcs,
                                         int q) {
  constexpr int NP = 8 * NT;
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    double ue[NT], uo[NT], prev[NT], next[NT];
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      ue[nn] = u[nn][s][0];
      uo[nn] = u[nn][s][1];
      // lane q - 1's odd row and lane q + 1's even row of tile nn
      prev[nn] = __shfl_sync(full, uo[nn], (q + 3) & 3, 4);
      next[nn] = __shfl_sync(full, ue[nn], (q + 1) & 3, 4);
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      // at q = 0 u_{i-1} is lane 3's odd row of tile nn - 1, which lane 0
      // holds as prev[nn - 1]; at q = 3 u_{i+1} is lane 0's even row of
      // tile nn + 1, held as next[nn + 1]; 0 outside the rows (padding
      // rows hold 0: W's padded rows are zero)
      const double um1 =
          q > 0 ? prev[nn] : (nn > 0 ? prev[nn > 0 ? nn - 1 : 0] : 0.0);
      const double up1 =
          q < 3 ? next[nn]
                : (nn + 1 < NT ? next[nn + 1 < NT ? nn + 1 : nn] : 0.0);
      const int i = 8 * nn + 2 * q;
      const double t_even =
          __fma_rn(dcs[2 * NP + i], uo[nn],
                   __fma_rn(dcs[NP + i], um1, __dmul_rn(dcs[i], ue[nn])));
      const double t_odd = __fma_rn(
          dcs[2 * NP + i + 1], up1,
          __fma_rn(dcs[NP + i + 1], ue[nn], __dmul_rn(dcs[i + 1], uo[nn])));
      r[nn][s][0] = __double2float_rn(
          __dsub_rn(static_cast<double>(y[nn][s][0]), t_even));
      r[nn][s][1] = __double2float_rn(
          __dsub_rn(static_cast<double>(y[nn][s][1]), t_odd));
    }
  }
}

// u = W y, then version 3's refinement passes
template <int V, Products P, int NT>
__device__ __forceinline__ void tc_solve(const WFrag<P, NT>& wf,
                                         const float (&y)[NT][2][2],
                                         float (&u)[NT][2][2],
                                         const double* __restrict__ dcs,
                                         int refine, int q) {
  float acc[NT][4];
  product<P, NT>(wf, y, acc);
#pragma unroll
  for (int nn = 0; nn < NT; ++nn)
#pragma unroll
    for (int c = 0; c < 4; ++c) u[nn][c >> 1][c & 1] = acc[nn][c];
  if constexpr (V == 3) {
    for (int it = 0; it < refine; ++it) {
      float r[NT][2][2];
      residual<NT>(y, u, r, dcs, q);
      product<P, NT>(wf, r, acc);
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          u[nn][c >> 1][c & 1] = add(u[nn][c >> 1][c & 1], acc[nn][c]);
    }
  }
}

template <int V, Products P, int NT, typename TU, int FM>
__global__ void __launch_bounds__(kTcBlock, kTcMinBlocks<V>)
tc_kernel(TcArgs a) {
  using TF = typename FStore<FM>::type;
  constexpr int NP = 8 * NT;
  constexpr bool kStreamF = FM != kFShared;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int n = a.n, B = a.B;
  double* dcs = reinterpret_cast<double*>(tc_smem);  // [3][NP], version 3
  float* cs = reinterpret_cast<float*>(
      tc_smem + (V == 3 ? 3 * NP * sizeof(double) : 0));  // [kCsRows][NP]
  const int span_u = round16(kTcTile * n * static_cast<int>(sizeof(TU)));
  const int span_f =
      kStreamF ? round16(kTcTile * n * static_cast<int>(sizeof(TF))) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* mine = reinterpret_cast<unsigned char*>(cs + kCsRows * NP) +
                        warp * 2 * (span_u + span_f);

  const float* cols = a.cols;
  for (int k = threadIdx.x; k < kCsRows * NP; k += blockDim.x) {
    const int r = k / NP, i = k - r * NP;
    float v = 0.0f;
    if (i < n) {
      if (r < kRowF)
        v = cols[r * n + i];
      else if (!kStreamF)
        v = a.f_code ? load<float>(static_cast<const __nv_bfloat16*>(a.F), i)
                     : static_cast<const float*>(a.F)[i];
    }
    cs[k] = v;
  }
  if constexpr (V == 3) {
    // the plain version's (m + d0), a0 and c0, widened
    for (int i = threadIdx.x; i < NP; i += blockDim.x) {
      const bool in = i < n;
      dcs[i] = in ? static_cast<double>(add(cols[i], cols[2 * n + i])) : 0.0;
      dcs[NP + i] = in ? static_cast<double>(cols[3 * n + i]) : 0.0;
      dcs[2 * NP + i] = in ? static_cast<double>(cols[4 * n + i]) : 0.0;
    }
  }
  __syncthreads();

  WFrag<P, NT> wf;
  wf.load(a.W, n, g, q);
  const TU* ud = static_cast<const TU*>(a.ud);
  const TF* Fs = static_cast<const TF*>(a.F);
  const long long tiles = (static_cast<long long>(B) + kTcTile - 1) / kTcTile;
  const long long step = static_cast<long long>(gridDim.x) * kTcWarps;
  auto ubuf = [&](int b) {
    return reinterpret_cast<TU*>(mine + b * (span_u + span_f));
  };
  auto fbuf = [&](int b) {
    return reinterpret_cast<TF*>(mine + b * (span_u + span_f) + span_u);
  };
  auto prefetch = [&](long long t, int b) {
    if (t < tiles) {
      const long long s0 = t * kTcTile;
      const int rows = static_cast<int>(
          B - s0 < kTcTile ? B - s0 : static_cast<long long>(kTcTile));
      stage(ubuf(b), ud, s0, rows, n, a.sU, a.vec_u, lane);
      if constexpr (kStreamF)
        stage(fbuf(b), Fs, s0, rows, n, a.sF, a.vec_f, lane);
    }
    cp_async_commit();
  };
  auto lk_of = [&](long long t, int s) -> float {
    const long long sc = t * kTcTile + g + 8 * s;
    return t < tiles && sc < B ? a.lk[sc * a.sL] : 0.0f;
  };
  auto row = [&](int r, int i) -> float { return cs[r * NP + i]; };

  long long tile = static_cast<long long>(blockIdx.x) * kTcWarps + warp;
  prefetch(tile, 0);
  float lk_next[2] = {lk_of(tile, 0), lk_of(tile, 1)};
  for (int b = 0; tile < tiles; tile += step, b ^= 1) {
    const float lkc[2] = {lk_next[0], lk_next[1]};
    __syncwarp();  // every lane is done reading buffer b ^ 1
    prefetch(tile + step, b ^ 1);
    lk_next[0] = lk_of(tile + step, 0);
    lk_next[1] = lk_of(tile + step, 1);
    cp_async_wait_prior();
    __syncwarp();  // this tile's span, from every lane's copies
    const TU* U = ubuf(b);
    const TF* Ft = fbuf(b);

    long long sc[2];
    bool ok[2];
    float kappa[2], kinv[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sc[s] = tile * kTcTile + g + 8 * s;
      ok[s] = sc[s] < B;
      kappa[s] = expo(lkc[s]);
      kinv[s] = quot(1.0f, kappa[s]);
    }
    // F at the lane's scenario g + 8 s, row i (0 outside the rows)
    auto fval = [&](int s, int i) -> float {
      if constexpr (kStreamF)
        return ok[s] && i < n ? load<float>(Ft, (g + 8 * s) * n + i) : 0.0f;
      else
        return row(kRowF, i);
    };

    // the forward right-hand side at scenario g + 8 s, row 8 nn + 2 q + e
    float y[NT][2][2];
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * nn + 2 * q + e;
          const float p = row(kRowP, i), f = fval(s, i);
          if constexpr (V == 1) {
            const float r = sub(add(row(kRowMg, i), mul(p, f)),
                                mul(kappa[s], row(kRowT0, i)));
            y[nn][s][e] = mul(add(row(kRowM, i), mul(p, kinv[s])), r);
          } else {
            y[nn][s][e] = add(row(kRowRhs0, i), mul(kinv[s], mul(p, f)));
          }
        }
    float u[NT][2][2];
    tc_solve<V, P, NT>(wf, y, u, dcs, a.refine, q);
    // the misfit, its loss and the adjoint right-hand side
    float lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * nn + 2 * q + e;
          float d = 0.0f;
          if (i < n && ok[s])
            d = sub(u[nn][s][e], load<float>(U, (g + 8 * s) * n + i));
          lsum[s] = add(lsum[s], mul(d, d));
          y[nn][s][e] =
              mul(add(row(kRowM, i), mul(row(kRowP, i), kinv[s])), d);
        }
    float lam[NT][2][2];
    tc_solve<V, P, NT>(wf, y, lam, dcs, a.refine, q);
    float gsum[2] = {0.0f, 0.0f};
    if constexpr (V == 1) {
      // lambda row by row against the four-term contraction of u
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float prev[NT], next[NT];
#pragma unroll
        for (int nn = 0; nn < NT; ++nn) {
          prev[nn] = __shfl_sync(0xffffffffu, u[nn][s][1], (q + 3) & 3, 4);
          next[nn] = __shfl_sync(0xffffffffu, u[nn][s][0], (q + 1) & 3, 4);
        }
#pragma unroll
        for (int nn = 0; nn < NT; ++nn) {
          // u_{i-1} of the even row, u_{i+1} of the odd row (residual's
          // reading of the neighbours)
          const float um1 =
              q > 0 ? prev[nn] : (nn > 0 ? prev[nn > 0 ? nn - 1 : 0] : 0.0f);
          const float up1 =
              q < 3 ? next[nn]
                    : (nn + 1 < NT ? next[nn + 1 < NT ? nn + 1 : nn] : 0.0f);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * nn + 2 * q + e;
            if (i < n) {
              // u_{i-1} and u_{i+1}, 0 outside the rows (K7's nb)
              const float lo = e == 0 ? um1 : u[nn][s][0];
              const float hi =
                  i + 1 >= n ? 0.0f : (e == 0 ? u[nn][s][1] : up1);
              const float term =
                  add(add(add(row(kRowT0, i), mul(row(kRowA0, i), lo)),
                          mul(row(kRowD0, i), u[nn][s][e])),
                      mul(row(kRowC0, i), hi));
              gsum[s] = add(gsum[s], mul(lam[nn][s][e], term));
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * nn + 2 * q + e;
            if (i < n)
              gsum[s] = add(gsum[s], mul(lam[nn][s][e],
                                         mul(row(kRowP, i), fval(s, i))));
          }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float l = group_sum(lsum[s]);
      const float gk = group_sum(gsum[s]);
      if (q == s && ok[s]) {
        a.loss[sc[s]] = l;
        a.grad[sc[s]] = V == 1 ? mul(mul(a.scale, kappa[s]), -gk)
                               : mul(-a.scale, gk);
      }
    }
  }
}

// Resident blocks an SM of `kern` at `smem` bytes, asked once per kernel,
// device and size (0 when the card cannot be asked).
template <typename Kernel>
int resident_blocks(Kernel kern, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<std::pair<const void*, int>, size_t>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key =
      std::make_pair(std::make_pair(reinterpret_cast<const void*>(kern), dev),
                     smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kTcBlock,
                                                    smem) != cudaSuccess)
    return 0;
  known[key] = blocks;
  return blocks;
}

template <int V, Products P, int NT, typename TU, int FM>
int launch_tc_t(const TcArgs& a, cudaStream_t st) {
  auto kern = tc_kernel<V, P, NT, TU, FM>;
  const size_t smem = tc_smem_bytes<V, NT, TU, FM>(a.n);
  const long long tiles =
      (static_cast<long long>(a.B) + kTcTile - 1) / kTcTile;
  const long long need = (tiles + kTcWarps - 1) / kTcWarps;
  const int per_sm = resident_blocks(kern, smem);
  const int sms = device_attribute<cudaDevAttrMultiProcessorCount>();
  if (per_sm <= 0 || sms <= 0) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  return launch_with_smem(kern, blocks, kTcBlock, smem, st, a);
}

template <int V, Products P, int NT>
int launch_tc_storage(const TcArgs& a, int fm, int u_code, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (u_code == 0 && fm == kFShared)
    return launch_tc_t<V, P, NT, float, kFShared>(a, st);
  if (u_code == 0 && fm == kFF32)
    return launch_tc_t<V, P, NT, float, kFF32>(a, st);
  if (u_code == 1 && fm == kFShared)
    return launch_tc_t<V, P, NT, bf16, kFShared>(a, st);
  if (u_code == 1 && fm == kFF32)
    return launch_tc_t<V, P, NT, bf16, kFF32>(a, st);
  if (u_code == 1 && fm == kFBf16)
    return launch_tc_t<V, P, NT, bf16, kFBf16>(a, st);
  return cudaErrorInvalidValue;
}

template <int V, Products P>
int launch_tc_pad(const TcArgs& a, int fm, int u_code, cudaStream_t st) {
  if (a.n <= 16) return launch_tc_storage<V, P, 2>(a, fm, u_code, st);
  return launch_tc_storage<V, P, 4>(a, fm, u_code, st);
}

}  // namespace

// One fused scalar-kappa grad step for B scenarios of n nodes: lk the log
// kappa (B,) with stride sL; F and u_data (B, n) rows with unit stride
// along n and batch strides sF, sU (0: shared), stored as the compute type
// (code 0) or bf16 (code 1); cols the (8, n) unit-kappa block; W (n, n)
// row-major.  Writes loss (B,) and grad (B,).  float32, or float64 when
// `is_double`.  `block_lanes` caps the scenarios a block holds.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int difffe_fused_mxu(const void* lk, long long sL, const void* F,
                                long long sF, int f_code, const void* ud,
                                long long sU, int u_code, const void* cols,
                                const void* W, void* loss, void* grad, int B,
                                int n, int block_lanes, int version,
                                int refine, double scale, int is_double,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(lk, sL, F, sF, f_code, ud, sU, u_code, cols, W,
                          loss, grad, B, n, block_lanes, version, refine,
                          scale, s);
  return launch<float>(lk, sL, F, sF, f_code, ud, sU, u_code, cols, W, loss,
                       grad, B, n, block_lanes, version, refine, scale, s);
}

// The "tc" route of the same step, float32 and n <= 32 only, with the same
// operands, strides and storage codes as difffe_fused_mxu: 3xTF32
// products for versions 1-2, bf16 for version 3.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int difffe_fused_mxu_tc(const void* lk, long long sL,
                                   const void* F, long long sF, int f_code,
                                   const void* ud, long long sU, int u_code,
                                   const void* cols, const void* W,
                                   void* loss, void* grad, int B, int n,
                                   int version, int refine, double scale,
                                   void* stream) {
  if (n < 1 || n > kTcMaxNodes || B < 1 || version < 1 || version > 3 ||
      refine < 0 || f_code < 0 || f_code > 1 || u_code < 0 || u_code > 1)
    return cudaErrorInvalidValue;
  const int fm = sF == 0 ? kFShared : (f_code ? kFBf16 : kFF32);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  TcArgs a;
  a.lk = static_cast<const float*>(lk);
  a.sL = sL;
  a.F = F;
  a.sF = sF;
  a.f_code = f_code;
  a.ud = ud;
  a.sU = sU;
  a.cols = static_cast<const float*>(cols);
  a.W = static_cast<const float*>(W);
  a.loss = static_cast<float*>(loss);
  a.grad = static_cast<float*>(grad);
  a.B = B;
  a.n = n;
  a.refine = refine;
  a.scale = static_cast<float>(scale);
  a.vec_u = sU == n && aligned(ud);
  a.vec_f = sF == n && aligned(F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (version == 1)
    return launch_tc_pad<1, Products::kTf32x3>(a, fm, u_code, st);
  if (version == 2)
    return launch_tc_pad<2, Products::kTf32x3>(a, fm, u_code, st);
  return launch_tc_pad<3, Products::kBf16>(a, fm, u_code, st);
}
