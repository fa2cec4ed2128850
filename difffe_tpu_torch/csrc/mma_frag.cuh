// Tensor-core fragments of K7's products (the "tc" route, csrc/tc_step.cuh,
// which csrc/fused_grad_mxu.cu instantiates) and of its ablations
// (csrc/k7_ablation.cu: B and C on their own kernel, the tc set on K7's).
//
// A product is computed transposed, U^T (16 x NP) = X^T (16 x NP) W^T, with
// one warp a tile of 16 scenarios: the scenarios are the M rows, W^T (zero
// padded to NP = 8 NT rows and columns) is the B operand, held in registers
// for the warp's life, and a lane (groupID g = lane / 4, q = lane % 4)
// holds scenarios g and g + 8 at rows 8 nn + 2q + {0, 1} of each 8-row tile
// nn.  That is where the f32 accumulator of m16n8k8 / m16n8k16 puts them;
// the K order of the A operand is permuted to the same rows (for TF32, K
// column q of a tile is row 2q and column q + 4 row 2q + 1; for bf16 the
// natural order already matches), so one product's accumulator is the next
// product's right-hand side without a shuffle or a trip through shared
// memory.
//
// Products:
//   kTf32x3  each operand split a = hi + lo, each rounded to TF32 with
//            cvt.rna (the 13 low bits cleared), lo hi + hi lo + hi hi
//            accumulated in f32 (lo lo dropped);
//   kTf32    one TF32 pass (operands rounded with cvt.rna), m16n8k8: no
//            route of K7 runs it, only its ablation tcB (k7_ablation.cu);
//   kBf16    one bf16 pass (operands rounded to nearest even), m16n8k16.
//
// A warp may hold KT tiles of 16 scenarios at once (product_tiles, 3xTF32
// only): each tile's products are the one-tile products, in the same order,
// with the KT tiles' mma.syncs interleaved (ablation tcF; K7 holds one).

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "fused_step_common.cuh"

namespace {

enum class Products { kTf32x3, kBf16, kTf32 };

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

// W^T as the B operand of every (nn, kk) tile, in registers.  TF32: K
// tiles of 8 with K column q at row 8 kk + 2q and q + 4 at 8 kk + 2q + 1
// (3xTF32: hi and lo parts); bf16: K tiles of 16 in natural order.
template <Products P, int NT>
struct WFrag {
  static constexpr bool kSplit = P == Products::kTf32x3;
  static constexpr bool kTf32 = P != Products::kBf16;
  static constexpr int NK = kTf32 ? NT : NT / 2;
  uint32_t hi[NT][NK][2];
  uint32_t lo[kSplit ? NT : 1][kSplit ? NK : 1][2];

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
        if constexpr (kSplit) {
          split_tf32(w(i, 8 * kk + 2 * q), hi[nn][kk][0], lo[nn][kk][0]);
          split_tf32(w(i, 8 * kk + 2 * q + 1), hi[nn][kk][1], lo[nn][kk][1]);
        } else if constexpr (kTf32) {
          hi[nn][kk][0] = tf32_bits(w(i, 8 * kk + 2 * q));
          hi[nn][kk][1] = tf32_bits(w(i, 8 * kk + 2 * q + 1));
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
// ablation B's gradient.  kTf32x3's two small passes (2^-11 of the result)
// share one accumulator over the tiles.
template <Products P, int NT>
__device__ __forceinline__ void product(const WFrag<P, NT>& wf,
                                        const float (&v)[NT][2][2],
                                        float (&acc)[NT][4]) {
#pragma unroll
  for (int nn = 0; nn < NT; ++nn)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nn][c] = 0.0f;
  if constexpr (P == Products::kTf32x3) {
    float small[NT][4];
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) small[nn][c] = 0.0f;
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
  } else if constexpr (P == Products::kTf32) {
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t a[4] = {tf32_bits(v[kk][0][0]), tf32_bits(v[kk][1][0]),
                             tf32_bits(v[kk][0][1]), tf32_bits(v[kk][1][1])};
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(part, a, wf.hi[nn][kk][0], wf.hi[nn][kk][1]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nn][c] = add(acc[nn][c], part[c]);
      }
    }
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

// product's 3xTF32 pass over KT tiles of 16 scenarios at once (acc[t]
// from v[t]): each tile's operations are product's, in its order, with the
// KT tiles' mma.syncs interleaved.
template <int NT, int KT>
__device__ __forceinline__ void product_tiles(
    const WFrag<Products::kTf32x3, NT>& wf, const float (&v)[KT][NT][2][2],
    float (&acc)[KT][NT][4]) {
  float small[KT][NT][4];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][nn][c] = small[t][nn][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ahi[KT][4], alo[KT][4];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      split_tf32(v[t][kk][0][0], ahi[t][0], alo[t][0]);
      split_tf32(v[t][kk][1][0], ahi[t][1], alo[t][1]);
      split_tf32(v[t][kk][0][1], ahi[t][2], alo[t][2]);
      split_tf32(v[t][kk][1][1], ahi[t][3], alo[t][3]);
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(small[t][nn], alo[t], wf.hi[nn][kk][0], wf.hi[nn][kk][1]);
        mma_tf32(small[t][nn], ahi[t], wf.lo[nn][kk][0], wf.lo[nn][kk][1]);
        mma_tf32(part, ahi[t], wf.hi[nn][kk][0], wf.hi[nn][kk][1]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[t][nn][c] = add(acc[t][nn][c], part[c]);
      }
  }
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[t][nn][c] = add(small[t][nn][c], acc[t][nn][c]);
}

// Sum over the four lanes of a group.
__device__ __forceinline__ float group_sum(float v) {
  v = add(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return add(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace
