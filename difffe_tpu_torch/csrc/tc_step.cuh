// K7's "tc" route (csrc/fused_grad_mxu.cu): the scalar-kappa grad step with
// its two products on the tensor cores, one warp a tile of 16 scenarios on
// mma.sync (mma_frag.cuh).  The scenarios are the M rows, W^T the B operand
// in registers for the warp's life, u's f32 accumulator the adjoint
// product's A operand as it stands; the shifts u_{i-/+1} are 4-lane
// shuffles and the sums over i xor-shuffles.  A tile's u_data and streamed
// F are one contiguous span of the (B, n) row-major planes (16 n values),
// staged into the warp's own shared memory by 16-byte cp.async, double
// buffered (async_copy.cuh); a persistent grid walks the tiles.
//
// K7 instantiates the body with nothing ablated (TcAblation::kNone).  Its
// ablations, the tc set of K7's ablation probe (csrc/k7_ablation.cu,
// difffe_tpu_torch/probes/k7_ablation.py), instantiate it at version 1 with
// one thing changed: other products (Products::kTf32, kBf16), or
//   kOneProduct  lambda = (m + p / kappa)(u - u_data): the adjoint product
//                dropped (wrong math, timing only);
//   kNoShifts    the contraction sum_i lambda_i (t0 + d0 u_i): no shifts
//                (wrong math, timing only);
//   kTwoTiles    the same math with two tiles a warp, their mma.syncs
//                interleaved (product_tiles), so the same tiles take half
//                the warps: the two-tile kernel below, whose tiles each run
//                the body's arithmetic, so the outputs equal K7's bit for
//                bit.
// The ablations enter the body only through `if constexpr`, so K7's own
// instantiations compile as they would without them.

#pragma once

#include <cstdint>

#include "async_copy.cuh"
#include "fused_step_common.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kTcBlock = 128;  // four warps
constexpr int kTcWarps = kTcBlock / 32;
constexpr int kTcTile = 16;  // scenarios a tile
constexpr int kTcMaxNodes = 32;
// constant rows of the table: m, p, d0, a0, c0, mg, t0, rhs0, shared F
constexpr int kRowM = 0, kRowP = 1, kRowD0 = 2, kRowA0 = 3, kRowC0 = 4,
              kRowMg = 5, kRowT0 = 6, kRowRhs0 = 7, kRowF = 8, kCsRows = 9;

enum class TcAblation { kNone, kOneProduct, kNoShifts, kTwoTiles };

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

// Shared memory of a block: version 3's double rows, the constant table and
// each warp's two buffers of a span of `rows` scenarios' u_data and
// streamed F (a tile of 16, or two).
template <int V, int NT, typename TU, int FM>
size_t tc_smem_bytes(int n, int rows = kTcTile) {
  using TF = typename FStore<FM>::type;
  constexpr int NP = 8 * NT;
  const int span_u = round16(rows * n * static_cast<int>(sizeof(TU)));
  const int span_f =
      FM == kFShared ? 0 : round16(rows * n * static_cast<int>(sizeof(TF)));
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

template <int V, Products P, int NT, typename TU, int FM,
          TcAblation A = TcAblation::kNone>
__global__ void __launch_bounds__(kTcBlock, kTcMinBlocks<V>)
tc_kernel(TcArgs a) {
  static_assert(A == TcAblation::kNone ||
                    (V == 1 && A != TcAblation::kTwoTiles),
                "the one-tile ablations are of version 1");
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
    if constexpr (A == TcAblation::kOneProduct) {
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          lam[nn][c >> 1][c & 1] = y[nn][c >> 1][c & 1];
    } else {
      tc_solve<V, P, NT>(wf, y, lam, dcs, a.refine, q);
    }
    float gsum[2] = {0.0f, 0.0f};
    if constexpr (V == 1 && A == TcAblation::kNoShifts) {
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * nn + 2 * q + e;
            if (i < n)
              gsum[s] = add(gsum[s],
                            mul(lam[nn][s][e],
                                add(row(kRowT0, i),
                                    mul(row(kRowD0, i), u[nn][s][e]))));
          }
    } else if constexpr (V == 1) {
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


// tcF: tc_kernel's version 1 step with two tiles of 16 scenarios a warp
// (a span of 32) and a shared F.  Each tile's arithmetic is tc_kernel's in
// its order, the two tiles' mma.syncs interleaved (product_tiles), so the
// outputs equal K7's bit for bit.  It copies tc_kernel's version 1 loop
// (staging, right-hand sides, misfit, contraction, write-back): a change to
// one is made to the other, and chip_smoke.py's phase 24 and the card tests
// hold tcF equal to K7's "tc" route.  The doubled arrays take all 255
// registers a thread and spill 72 bytes at NT = 4 (the launch bounds ask
// for one block an SM; the occupancy API gives the grid what the registers
// allow).
template <int NT, typename TU>
__global__ void __launch_bounds__(kTcBlock, 1)
tc_two_tiles_kernel(TcArgs a) {
  constexpr int NP = 8 * NT;
  constexpr int KT = 2, kRows = KT * kTcTile;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int n = a.n, B = a.B;
  float* cs = reinterpret_cast<float*>(tc_smem);  // [kCsRows][NP]
  const int span_u = round16(kRows * n * static_cast<int>(sizeof(TU)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* mine = reinterpret_cast<unsigned char*>(cs + kCsRows * NP) +
                        warp * 2 * span_u;

  const float* cols = a.cols;
  for (int k = threadIdx.x; k < kCsRows * NP; k += blockDim.x) {
    const int r = k / NP, i = k - r * NP;
    float v = 0.0f;
    if (i < n) {
      if (r < kRowF)
        v = cols[r * n + i];
      else
        v = a.f_code ? load<float>(static_cast<const __nv_bfloat16*>(a.F), i)
                     : static_cast<const float*>(a.F)[i];
    }
    cs[k] = v;
  }
  __syncthreads();

  WFrag<Products::kTf32x3, NT> wf;
  wf.load(a.W, n, g, q);
  const TU* ud = static_cast<const TU*>(a.ud);
  const long long tiles = (static_cast<long long>(B) + kRows - 1) / kRows;
  const long long step = static_cast<long long>(gridDim.x) * kTcWarps;
  auto ubuf = [&](int b) { return reinterpret_cast<TU*>(mine + b * span_u); };
  auto prefetch = [&](long long t, int b) {
    if (t < tiles) {
      const long long s0 = t * kRows;
      const int rows = static_cast<int>(
          B - s0 < kRows ? B - s0 : static_cast<long long>(kRows));
      stage(ubuf(b), ud, s0, rows, n, a.sU, a.vec_u, lane);
    }
    cp_async_commit();
  };
  // tile k's scenario g + 8 s sits at row k * 16 + g + 8 s of the span
  auto srow = [&](int k, int s) { return k * kTcTile + g + 8 * s; };
  auto lk_of = [&](long long t, int k, int s) -> float {
    const long long sc = t * kRows + srow(k, s);
    return t < tiles && sc < B ? a.lk[sc * a.sL] : 0.0f;
  };
  auto row = [&](int r, int i) -> float { return cs[r * NP + i]; };

  long long tile = static_cast<long long>(blockIdx.x) * kTcWarps + warp;
  prefetch(tile, 0);
  float lk_next[KT][2];
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int s = 0; s < 2; ++s) lk_next[k][s] = lk_of(tile, k, s);
  for (int b = 0; tile < tiles; tile += step, b ^= 1) {
    float kappa[KT][2], kinv[KT][2];
    long long sc[KT][2];
    bool ok[KT][2];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        sc[k][s] = tile * kRows + srow(k, s);
        ok[k][s] = sc[k][s] < B;
        kappa[k][s] = expo(lk_next[k][s]);
        kinv[k][s] = quot(1.0f, kappa[k][s]);
      }
    __syncwarp();  // every lane is done reading buffer b ^ 1
    prefetch(tile + step, b ^ 1);
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int s = 0; s < 2; ++s) lk_next[k][s] = lk_of(tile + step, k, s);
    cp_async_wait_prior();
    __syncwarp();  // this span, from every lane's copies
    const TU* U = ubuf(b);

    // the forward right-hand side of each tile (tc_kernel's, version 1)
    float y[KT][NT][2][2];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * nn + 2 * q + e;
            const float p = row(kRowP, i);
            const float r = sub(add(row(kRowMg, i), mul(p, row(kRowF, i))),
                                mul(kappa[k][s], row(kRowT0, i)));
            y[k][nn][s][e] = mul(add(row(kRowM, i), mul(p, kinv[k][s])), r);
          }
    float u[KT][NT][4], lam[KT][NT][4];
    product_tiles<NT, KT>(wf, y, u);
    // the misfit, its loss and the adjoint right-hand side
    float lsum[KT][2], gsum[KT][2];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        lsum[k][s] = 0.0f;
        gsum[k][s] = 0.0f;
#pragma unroll
        for (int nn = 0; nn < NT; ++nn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * nn + 2 * q + e;
            float d = 0.0f;
            if (i < n && ok[k][s])
              d = sub(u[k][nn][2 * s + e],
                      load<float>(U, srow(k, s) * n + i));
            lsum[k][s] = add(lsum[k][s], mul(d, d));
            y[k][nn][s][e] =
                mul(add(row(kRowM, i), mul(row(kRowP, i), kinv[k][s])), d);
          }
      }
    product_tiles<NT, KT>(wf, y, lam);
    // lambda row by row against the four-term contraction of u
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float prev[NT], next[NT];
#pragma unroll
        for (int nn = 0; nn < NT; ++nn) {
          prev[nn] =
              __shfl_sync(0xffffffffu, u[k][nn][2 * s + 1], (q + 3) & 3, 4);
          next[nn] = __shfl_sync(0xffffffffu, u[k][nn][2 * s], (q + 1) & 3, 4);
        }
#pragma unroll
        for (int nn = 0; nn < NT; ++nn) {
          const float um1 =
              q > 0 ? prev[nn] : (nn > 0 ? prev[nn > 0 ? nn - 1 : 0] : 0.0f);
          const float up1 =
              q < 3 ? next[nn]
                    : (nn + 1 < NT ? next[nn + 1 < NT ? nn + 1 : nn] : 0.0f);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * nn + 2 * q + e;
            if (i < n) {
              const float lo = e == 0 ? um1 : u[k][nn][2 * s];
              const float hi =
                  i + 1 >= n ? 0.0f : (e == 0 ? u[k][nn][2 * s + 1] : up1);
              const float term =
                  add(add(add(row(kRowT0, i), mul(row(kRowA0, i), lo)),
                          mul(row(kRowD0, i), u[k][nn][2 * s + e])),
                      mul(row(kRowC0, i), hi));
              gsum[k][s] = add(gsum[k][s], mul(lam[k][nn][2 * s + e], term));
            }
          }
        }
      }
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float l = group_sum(lsum[k][s]);
        const float gk = group_sum(gsum[k][s]);
        if (q == s && ok[k][s]) {
          a.loss[sc[k][s]] = l;
          a.grad[sc[k][s]] = mul(mul(a.scale, kappa[k][s]), -gk);
        }
      }
  }
}

template <int V, Products P, int NT, typename TU, int FM,
          TcAblation A = TcAblation::kNone>
int launch_tc_t(const TcArgs& a, cudaStream_t st) {
  constexpr bool kTwo = A == TcAblation::kTwoTiles;
  static_assert(!kTwo || (V == 1 && P == Products::kTf32x3 &&
                          FM == kFShared),
                "two tiles a warp: version 1, 3xTF32, a shared F");
  const int rows = kTwo ? 2 * kTcTile : kTcTile;
  const size_t smem = tc_smem_bytes<V, NT, TU, FM>(a.n, rows);
  const long long tiles = (static_cast<long long>(a.B) + rows - 1) / rows;
  auto launch = [&](auto kern) {
    const int blocks = persistent_blocks(kern, kTcWarps, smem, tiles);
    if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    return launch_with_smem(kern, blocks, kTcBlock, smem, st, a);
  };
  if constexpr (kTwo)
    return launch(tc_two_tiles_kernel<NT, TU>);
  else
    return launch(tc_kernel<V, P, NT, TU, FM, A>);
}

// The row padding NP = 16 or 32 (NT = 2 or 4 tiles of 8 rows) that holds n.
template <int V, Products P, typename TU, int FM,
          TcAblation A = TcAblation::kNone>
int launch_tc_pad(const TcArgs& a, cudaStream_t st) {
  if (a.n <= 16) return launch_tc_t<V, P, 2, TU, FM, A>(a, st);
  return launch_tc_t<V, P, 4, TU, FM, A>(a, st);
}

// The TcArgs of a launch: every operand as difffe_fused_mxu_tc takes it.
inline TcArgs tc_args(const void* lk, long long sL, const void* F,
                      long long sF, int f_code, const void* ud, long long sU,
                      const void* cols, const void* W, void* loss, void* grad,
                      int B, int n, int refine, double scale) {
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
  return a;
}

}  // namespace
