// Closed-form per-element-kappa 1D gradient step and SGD chain (kernel K1).
//
// Replaces the Pallas TPU kernels _cf_step_kernel, _cf_step_kernel_stream_ud,
// _cf_chain_kernel and _cf_chain_kernel_stream_ud in
// difffe_tpu/ops/pallas/fused_grad_cf_kernel.py.  Per scenario column b of
// the transposed (N, Bp) layout it computes, with the per-row constants
// h_e, P_e (= sum_{i<e} F_i) and u_data (shared mode), and the node rows
// 0..n-1 and interior rows 1..n-2:
//
//   s = h/kappa;  S = cumsum(s);  T = cumsum(s*P);  w1 = (u_R-u_L+T_tot)/S_tot
//   u_i = u_L + w1*S_{i-1} - T_{i-1};  d = (u - u_data)*node_mask
//   loss = sum d^2;  P^lambda = cumsum(scale*d*interior_mask)
//   wl1 = sum(s*P^lambda)/S_tot;  g = -(h/kappa^2)(w1 - P)(wl1 - P^lambda)
//
// and either writes g (step) or applies n_inner updates kappa -= lr*g with
// kappa held on the chip (chain) and writes kappa'.  Rows are bucketed to
// NB in {32, 64, 128, 256}: rows N..NB-1 act as padding rows (h = 0), which
// leaves every prefix total and gradient unchanged.  Lanes b >= B are
// padding: loss 0, gradient 0, kappa' = kappa.  No atomics: deterministic.
//
// Bound.  A single step reads kappa (4 B) and a streamed u_data (2 or 4 B)
// per element and writes 4 B, against ~36 operations per element: it is
// bound by device-memory bandwidth.  The chain keeps kappa and the u_data
// column on the chip across n_inner steps, so that traffic is paid once
// per launch while the per-row work repeats n_inner times: bound by the
// FP32 pipes.
//
// Design.  L adjacent lanes of a warp share one scenario, lane l holding
// the R = NB/L contiguous rows l*R .. l*R+R-1 in registers: kappa,
// 1/kappa, P^lambda and u_data (bf16 kept packed two to a register).  Each
// lane keeps running sums over its rows in 8-row blocks (the rounding
// error grows with R/8 + 8 terms, not R); the prefix offsets of the other
// lanes come from a width-L shuffle scan of the lanes' totals.  The
// adjoint's sum(s*P^lambda) is linear in the lane's offset o:
// sum_l (sum s*p_local + o_l*S_l), one shuffle reduction.  The per-row
// constants h_e, P_e and the shared u_data sit in __constant__ memory
// (c_rows, copied on the launch's stream before each launch from the
// wrapper's k1_rows block): with L = 1 every row index is a compile-time
// constant and the FP32 instructions read them as constant-bank operands,
// with no load; with L > 1 each lane loads its rows' constants into
// registers once per launch.  The two masks come from the row index and n:
// the interior mask only matters on row 0 (rows >= n-1 have h = 0, so
// their P^lambda meets s = 0 and a zero gradient), and the node mask only
// enters the loss, which is summed on the last inner step alone (peeled at
// compile time).  1/kappa is one rcp.approx.ftz a row and step (not the
// IEEE reciprocal: <= 1 ulp, inside the tolerances of the plain f32
// version), kept for the adjoint pass and the gradient; the gradient pass
// of step t and the totals pass of step t+1 are one loop.  No bucket keeps
// its arrays in local memory.  L by bucket, as measured on an H100: L = 1
// at NB = 32 (its ~250 registers run 8 warps an SM, and still beat L = 2
// and 4, whose shuffles and per-scenario work repeated on every lane cost
// more than the occupancy gives), L = NB/16 above (16 rows a lane under a
// 128-register cap, 16 warps an SM).  ~30 instructions a row and step
// remain, so the chain is bound by the FP32 issue rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 256;
constexpr int kRowVals = 3;  // {h, P, shared u_data} a row in c_rows
constexpr unsigned kFull = 0xffffffffu;

// The per-row constants, row-major {h, P, shared u_data}, rows
// N..NB-1 zero (the wrapper's k1_rows block, copied on the stream).
__constant__ float c_rows[kMaxRows * kRowVals];

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Inclusive prefix sum over the L lanes of a scenario (width-L segments).
template <int L>
__device__ __forceinline__ float lane_scan(float v, int l) {
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d, L);
    if (l >= d) v += o;
  }
  return v;
}

// The previous lane's value (0 on lane 0): an exclusive offset from an
// inclusive scan.
template <int L>
__device__ __forceinline__ float lane_prev(float inc, int l) {
  if constexpr (L == 1) {
    return 0.f;
  } else {
    const float o = __shfl_up_sync(kFull, inc, 1, L);
    return l == 0 ? 0.f : o;
  }
}

template <int L>
__device__ __forceinline__ float lane_last(float v) {
  if constexpr (L == 1) {
    return v;
  } else {
    return __shfl_sync(kFull, v, L - 1, L);
  }
}

// Sum over the L lanes; every lane gets the same bits (each butterfly
// level adds the same two values on both lanes of a pair).
template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int d = L / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d, L);
  return v;
}

// u_data rows of one lane: a streamed float or bf16 plane (bf16 packed two
// rows to a 32-bit register), or the shared column of c_rows.
template <int R, int L, bool STREAM_UD, typename UdT>
struct UdRows;

template <int R, int L>
struct UdRows<R, L, true, float> {
  float v[R];
  __device__ __forceinline__ void load(const float* udT, size_t ld,
                                       size_t b, int row0, int N, bool live) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = live && row0 + r < N ? udT[(row0 + r) * ld + b] : 0.f;
  }
  __device__ __forceinline__ float get(int r) const { return v[r]; }
};

template <int R, int L>
struct UdRows<R, L, true, __nv_bfloat16> {
  static_assert(R % 2 == 0, "bf16 rows are packed in pairs");
  uint32_t v[R / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* udT, size_t ld,
                                       size_t b, int row0, int N,
                                       bool live) {
    const uint16_t* u = reinterpret_cast<const uint16_t*>(udT);
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      const uint32_t lo =
          live && row0 + r < N ? u[(row0 + r) * ld + b] : 0u;
      const uint32_t hi =
          live && row0 + r + 1 < N ? u[(row0 + r + 1) * ld + b] : 0u;
      v[r / 2] = lo | (hi << 16);
    }
  }
  __device__ __forceinline__ float get(int r) const {
    return (r & 1) ? __uint_as_float(v[r / 2] & 0xffff0000u)
                   : __uint_as_float(v[r / 2] << 16);
  }
};

template <int R, int L, typename UdT>
struct UdRows<R, L, false, UdT> {
  float v[L == 1 ? 1 : R];
  __device__ __forceinline__ void load(const UdT*, size_t, size_t, int row0,
                                       int, bool) {
    if constexpr (L > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = c_rows[(row0 + r) * kRowVals + 2];
    }
  }
  __device__ __forceinline__ float get(int r) const {
    if constexpr (L == 1) {
      return c_rows[r * kRowVals + 2];
    } else {
      return v[r];
    }
  }
};

// h and P of one lane's rows: constant-bank operands with L = 1 (row0 is
// 0 and every index compile-time), registers loaded once with L > 1.
template <int R, int L>
struct RowConsts {
  float h[L == 1 ? 1 : R], p[L == 1 ? 1 : R];
  __device__ __forceinline__ void load(int row0) {
    if constexpr (L > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h[r] = c_rows[(row0 + r) * kRowVals];
        p[r] = c_rows[(row0 + r) * kRowVals + 1];
      }
    }
  }
  __device__ __forceinline__ float H(int r) const {
    if constexpr (L == 1) {
      return c_rows[r * kRowVals];
    } else {
      return h[r];
    }
  }
  __device__ __forceinline__ float P(int r) const {
    if constexpr (L == 1) {
      return c_rows[r * kRowVals + 1];
    } else {
      return p[r];
    }
  }
};

// L > 1: two blocks an SM (at most 128 registers, 16 warps), which ran the
// buckets 64-256 fastest; L = 1 runs 8 warps an SM on ~210 registers
template <int NB, int L, bool STREAM_UD, bool CHAIN, typename UdT>
__global__ void __launch_bounds__(kThreads, (L == 1 ? 1 : 2))
cf_lanes_kernel(const float* __restrict__ keT, const UdT* __restrict__ udT,
                float* __restrict__ loss, float* __restrict__ out, int N,
                int n, int Bp, int B, float scale, float u_l, float u_r,
                int n_inner, float lr) {
  constexpr int R = NB / L;
  static_assert(NB % L == 0 && 32 % L == 0, "L divides NB and the warp");
  const int l = L == 1 ? 0 : static_cast<int>(threadIdx.x % L);
  const size_t b =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const bool in_plane = b < static_cast<size_t>(Bp);
  const bool live = b < static_cast<size_t>(B);
  const size_t ld = static_cast<size_t>(Bp);
  const int row0 = l * R;

  RowConsts<R, L> cst;
  cst.load(row0);
  UdRows<R, L, STREAM_UD, UdT> ud;
  ud.load(udT, ld, b, row0, N, live);
  float ke[R], inv[R], pl[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    ke[r] = live && row0 + r < N ? keT[(row0 + r) * ld + b] : 1.f;

  const float du = u_r - u_l;
  // row 0 is not an interior row: P^lambda starts at 0 there
  const float sc0 = l == 0 ? 0.f : scale;
  const int n_lane = n - row0;   // this lane's rows r < n_lane are nodes

  // totals pass of the first step: s = h/kappa, the lane's sums of s, s*P
  float s_lane, t_lane;
  {
    float sb = 0.f, tb = 0.f, sp = 0.f, tp = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      inv[r] = rcp_approx(ke[r]);
      const float s = cst.H(r) * inv[r];
      sp += s;
      tp = fmaf(s, cst.P(r), tp);
      if ((r & 7) == 7 || r == R - 1) {
        sb += sp;
        tb += tp;
        sp = tp = 0.f;
      }
    }
    s_lane = sb;
    t_lane = tb;
  }

  // one step; the last (LAST) also sums the loss and computes no totals
  // for a step after it
  float lsum = 0.f;
  auto step = [&](auto last_tag) {
    constexpr bool LAST = decltype(last_tag)::value;
    // lane offsets and totals of S and T; w1
    const float s_inc = lane_scan<L>(s_lane, l);
    const float t_inc = lane_scan<L>(t_lane, l);
    const float s_off = lane_prev<L>(s_inc, l);
    const float t_off = lane_prev<L>(t_inc, l);
    const float S_tot = lane_last<L>(s_inc);
    const float T_tot = lane_last<L>(t_inc);
    const float w1 = (du + T_tot) / S_tot;

    // adjoint pass: u, d, the local P^lambda and sum(s*P^lambda)
    float Pl = 0.f, tl = 0.f, ls = 0.f;
    {
      float Sb = s_off, Tb = t_off, sp = 0.f, tp = 0.f;
      float c = u_l + (w1 * Sb - Tb);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float u = c + fmaf(w1, sp, -tp);
        const float d = u - ud.get(r);
        if (LAST && r < n_lane) ls = fmaf(d, d, ls);
        Pl = r == 0 ? sc0 * d : fmaf(scale, d, Pl);
        pl[r] = Pl;
        const float s = cst.H(r) * inv[r];
        tl = fmaf(s, Pl, tl);
        sp += s;
        tp = fmaf(s, cst.P(r), tp);
        if ((r & 7) == 7 && r != R - 1) {
          Sb += sp;
          Tb += tp;
          sp = tp = 0.f;
          c = u_l + (w1 * Sb - Tb);
        }
      }
    }
    if constexpr (LAST) lsum = lane_sum<L>(ls);
    const float pl_off = lane_prev<L>(lane_scan<L>(Pl, l), l);
    const float tl_tot = lane_sum<L>(fmaf(pl_off, s_lane, tl));
    const float wl1 = tl_tot / S_tot;
    const float wl = wl1 - pl_off;   // wl1 - P^lambda_i = wl - pl[r]

    // gradient pass, and the next step's totals pass
    float sb = 0.f, tb = 0.f, sp = 0.f, tp = 0.f;
    const float lw1 = lr * w1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float t = cst.H(r) * inv[r] * inv[r];
      if constexpr (CHAIN) {
        const float a = fmaf(-lr, cst.P(r), lw1);   // lr (w1 - P)
        ke[r] = fmaf(t * a, wl - pl[r], ke[r]);     // kappa - lr g
        if constexpr (!LAST) {
          inv[r] = rcp_approx(ke[r]);
          const float s = cst.H(r) * inv[r];
          sp += s;
          tp = fmaf(s, cst.P(r), tp);
          if ((r & 7) == 7 || r == R - 1) {
            sb += sp;
            tb += tp;
            sp = tp = 0.f;
          }
        }
      } else {
        const float g = -t * (w1 - cst.P(r)) * (wl - pl[r]);
        if (in_plane && row0 + r < N)
          out[(row0 + r) * ld + b] = live ? g : 0.f;
      }
    }
    s_lane = sb;
    t_lane = tb;
  };
  if constexpr (CHAIN) {
    for (int it = 1; it < n_inner; ++it) step(std::false_type{});
  }
  step(std::true_type{});
  if (!in_plane) return;
  if (l == 0) loss[b] = live ? lsum : 0.f;
  if constexpr (CHAIN) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row0 + r < N)
        out[(row0 + r) * ld + b] = live ? ke[r] : keT[(row0 + r) * ld + b];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const float* keT;
  const void* udT;
  int ud_kind;
  float* loss;
  float* out;
  int N, n, Bp, B;
  float scale, u_l, u_r;
  int n_inner;
  float lr;
  cudaStream_t stream;
};

template <int NB, int L, bool CHAIN>
cudaError_t launch_lanes(const Args& a) {
  const long long threads = static_cast<long long>(a.Bp) * L;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  switch (a.ud_kind) {
    case 0:
      cf_lanes_kernel<NB, L, false, CHAIN, float>
          <<<grid, kThreads, 0, a.stream>>>(
              a.keT, nullptr, a.loss, a.out, a.N, a.n, a.Bp, a.B, a.scale,
              a.u_l, a.u_r, a.n_inner, a.lr);
      break;
    case 1:
      cf_lanes_kernel<NB, L, true, CHAIN, float>
          <<<grid, kThreads, 0, a.stream>>>(
              a.keT, static_cast<const float*>(a.udT), a.loss, a.out, a.N,
              a.n, a.Bp, a.B, a.scale, a.u_l, a.u_r, a.n_inner, a.lr);
      break;
    case 2:
      cf_lanes_kernel<NB, L, true, CHAIN, __nv_bfloat16>
          <<<grid, kThreads, 0, a.stream>>>(
              a.keT, static_cast<const __nv_bfloat16*>(a.udT), a.loss, a.out,
              a.N, a.n, a.Bp, a.B, a.scale, a.u_l, a.u_r, a.n_inner, a.lr);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The bucket NB of N rows and its lanes a scenario (the wrapper's
// K1_LANES).
template <bool CHAIN>
cudaError_t launch(const Args& a, const void* rows, int lanes) {
  if (a.N < 1 || a.N > kMaxRows || a.n < 2 || a.n > a.N || a.Bp < 1 ||
      a.B < 1 || a.B > a.Bp || a.n_inner < 1)
    return cudaErrorInvalidValue;
  const int NB = a.N <= 32 ? 32 : a.N <= 64 ? 64 : a.N <= 128 ? 128 : 256;
  // the bucket's rows {h, P, u_data}, zero-padded to NB rows, on the stream
  void* sym = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&sym, c_rows);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(sym, rows, sizeof(float) * kRowVals * NB,
                        cudaMemcpyDeviceToDevice, a.stream);
  if (err != cudaSuccess) return err;
  switch (NB * 64 + lanes) {
    case 32 * 64 + 1: return launch_lanes<32, 1, CHAIN>(a);
    case 64 * 64 + 4: return launch_lanes<64, 4, CHAIN>(a);
    case 128 * 64 + 8: return launch_lanes<128, 8, CHAIN>(a);
    case 256 * 64 + 16: return launch_lanes<256, 16, CHAIN>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ud_kind: 0 = shared u_data (row value 2 of rows; udT unused),
//          1 = streamed float (N, Bp) plane, 2 = streamed bf16 plane.
// rows is the (NB, 3) block {h, P, shared u_data} (NB the bucket of N,
// zero rows past N), n the node count (the masks' rows), lanes the
// bucket's lanes a scenario.  Every entry returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int difffe_cf_step(const void* keT, const void* udT, int ud_kind,
                              const void* rows, void* loss, void* gradT,
                              int N, int n, int Bp, int B, float scale,
                              float u_l, float u_r, int lanes, void* stream) {
  const Args a{static_cast<const float*>(keT), udT, ud_kind,
               static_cast<float*>(loss), static_cast<float*>(gradT), N, n,
               Bp, B, scale, u_l, u_r, 1, 0.f,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<false>(a, rows, lanes));
}

extern "C" int difffe_cf_chain(const void* keT, const void* udT, int ud_kind,
                               const void* rows, void* loss, void* keT_out,
                               int N, int n, int Bp, int B, float scale,
                               float u_l, float u_r, int n_inner, float lr,
                               int lanes, void* stream) {
  const Args a{static_cast<const float*>(keT), udT, ud_kind,
               static_cast<float*>(loss), static_cast<float*>(keT_out), N, n,
               Bp, B, scale, u_l, u_r, n_inner, lr,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<true>(a, rows, lanes));
}
