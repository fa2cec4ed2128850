// Closed-form per-element-kappa 1D gradient step and SGD chain (kernel K1).
//
// Replaces the Pallas TPU kernels _cf_step_kernel, _cf_step_kernel_stream_ud,
// _cf_chain_kernel and _cf_chain_kernel_stream_ud in
// difffe_tpu/ops/pallas/fused_grad_cf_kernel.py.  Per scenario column b of
// the transposed (N, Bp) layout it computes, with the per-row constants
// h_e, P_e (= sum_{i<e} F_i), u_data (shared mode), node and interior masks:
//
//   s = h/kappa;  S = cumsum(s);  T = cumsum(s*P);  w1 = (u_R-u_L+T_tot)/S_tot
//   u_i = u_L + w1*S_{i-1} - T_{i-1};  d = (u - u_data)*node_mask
//   loss = sum d^2;  P^lambda = cumsum(scale*d*interior_mask)
//   wl1 = sum(s*P^lambda)/S_tot;  g = -(h/kappa^2)(w1 - P)(wl1 - P^lambda)
//
// and either writes g (step) or applies n_inner updates kappa -= lr*g with
// kappa held per thread (chain) and writes kappa'.
//
// Design.  One thread owns one scenario column, so row i of every plane is
// contiguous across a warp and each load/store coalesces.  The TPU kernel's
// prefix sums (5 masked sublane roll-adds, or a hi/lo-split bf16 matmul
// against a triangular ones matrix) become one exact running f32 sum per
// thread, accumulated in 8-row blocks (RunSum); both cumsum_via settings of
// the Python API map to this scan.  The per-row constants are read by every
// thread and sit in shared memory, loaded once per block.  Rows are bucketed to NB in {32, 64, 128, 256}:
// rows N..NB-1 act as padding rows (h = 0, masks 0), which leaves every
// prefix total and gradient unchanged.  No cross-thread reduction exists,
// so there are no atomics and results are deterministic.  Lanes b >= B are
// padding: loss 0, gradient 0, kappa' = kappa.
//
// Bound.  A single step reads kappa (4 B) and a streamed u_data (2 or 4 B)
// per element and writes 4 B, against ~40 flop per element: it is bound by
// device-memory bandwidth.  The chain keeps kappa (and the u_data column)
// per thread across n_inner steps, so that traffic is paid once per launch
// while the ~40 flop per element repeat n_inner times; the per-row work is
// then arithmetic on data held on the chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Column layout of the packed (N, kCols) constants block; must match
// difffe_tpu_torch/ops/kernels/fused_grad_cf_kernel.py.
constexpr int kCols = 6;
constexpr int kColHs = 0;  // element width h_e on element rows, 0 on pads
constexpr int kColPf = 1;  // P_e on element rows
constexpr int kColUd = 2;  // shared u_data on node rows (shared mode)
constexpr int kColNm = 3;  // 1 on node rows 0..n-1
constexpr int kColIm = 4;  // 1 on interior node rows 1..n-2
constexpr int kColHk = 5;  // h_e again, used by the gradient
constexpr int kThreads = 256;

// A running f32 sum kept as a total of completed 8-row blocks plus the
// partial sum of the current block: its rounding error grows with N/8 + 8
// terms instead of N, which keeps the 129-257-row buckets at the accuracy
// of torch.cumsum on the same data.
struct RunSum {
  float base = 0.f, part = 0.f;
  __device__ __forceinline__ void add(float x, int i) {
    part += x;
    if ((i & 7) == 7) {
      base += part;
      part = 0.f;
    }
  }
  __device__ __forceinline__ float value() const { return base + part; }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// UNROLL is NB for the small buckets (arrays stay in registers) and 1 for
// the large ones (arrays live in local memory; the build stays short).
template <int NB, int UNROLL, bool STREAM_UD, bool CHAIN, typename UdT>
__global__ void __launch_bounds__(kThreads)
cf_kernel(const float* __restrict__ keT, const UdT* __restrict__ udT,
          const float* __restrict__ cols, float* __restrict__ loss,
          float* __restrict__ out, int N, int Bp, int B, float scale,
          float u_l, float u_r, int n_inner, float lr) {
  __shared__ float c_hs[NB], c_pf[NB], c_ud[NB], c_nm[NB], c_im[NB],
      c_hk[NB];
  for (int i = threadIdx.x; i < NB; i += blockDim.x) {
    const bool row = i < N;
    const float* c = cols + static_cast<size_t>(i) * kCols;
    c_hs[i] = row ? c[kColHs] : 0.f;
    c_pf[i] = row ? c[kColPf] : 0.f;
    c_ud[i] = row ? c[kColUd] : 0.f;
    c_nm[i] = row ? c[kColNm] : 0.f;
    c_im[i] = row ? c[kColIm] : 0.f;
    c_hk[i] = row ? c[kColHk] : 0.f;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bp) return;
  const size_t ld = static_cast<size_t>(Bp);
  if (b >= B) {
    loss[b] = 0.f;
    for (int i = 0; i < N; ++i)
      out[i * ld + b] = CHAIN ? keT[i * ld + b] : 0.f;
    return;
  }

  // ud[] is used only when u_data is streamed; shared u_data is read
  // from shared memory.
  float ke[NB], ud[NB], pl[NB];
#pragma unroll(UNROLL)
  for (int i = 0; i < NB; ++i) {
    ke[i] = i < N ? keT[i * ld + b] : 1.f;
    if (STREAM_UD) ud[i] = i < N ? to_f32(udT[i * ld + b]) : 0.f;
  }

  const float du = u_r - u_l;
  float lsum = 0.f;
#pragma unroll 1
  for (int it = 0; it < n_inner; ++it) {
    // 1. S_tot, T_tot, then w1
    RunSum s_tot, t_tot;
#pragma unroll(UNROLL)
    for (int i = 0; i < NB; ++i) {
      const float s = c_hs[i] * (1.f / ke[i]);
      s_tot.add(s, i);
      t_tot.add(s * c_pf[i], i);
    }
    const float S_tot = s_tot.value();
    const float w1 = (du + t_tot.value()) / S_tot;

    // 2. u, d, the loss and the running P^lambda; 3. tl_tot, then wl1
    RunSum S, T, Pl, tl_tot, loss_sum;
#pragma unroll(UNROLL)
    for (int i = 0; i < NB; ++i) {
      const float u = u_l + (w1 * S.value() - T.value());
      const float d = (u - (STREAM_UD ? ud[i] : c_ud[i])) * c_nm[i];
      loss_sum.add(d * d, i);
      Pl.add(scale * d * c_im[i], i);
      pl[i] = Pl.value();
      const float s = c_hs[i] * (1.f / ke[i]);
      S.add(s, i);
      T.add(s * c_pf[i], i);
      tl_tot.add(s * pl[i], i);
    }
    lsum = loss_sum.value();
    const float wl1 = tl_tot.value() / S_tot;

    // 4. g_e = -(h_e/kappa_e^2)(w1 - P_e)(wl1 - P^lambda_e)
#pragma unroll(UNROLL)
    for (int i = 0; i < NB; ++i) {
      const float inv = 1.f / ke[i];
      const float g = -(c_hk[i] * inv * inv) * (w1 - c_pf[i]) * (wl1 - pl[i]);
      if (CHAIN)
        ke[i] -= lr * g;
      else if (i < N)
        out[i * ld + b] = g;
    }
  }
  loss[b] = lsum;
  if (CHAIN) {
#pragma unroll(UNROLL)
    for (int i = 0; i < NB; ++i)
      if (i < N) out[i * ld + b] = ke[i];
  }
}

template <int NB, int UNROLL, bool CHAIN>
cudaError_t launch_bucket(const float* keT, const void* udT, int ud_kind,
                          const float* cols, float* loss, float* out, int N,
                          int Bp, int B, float scale, float u_l, float u_r,
                          int n_inner, float lr, cudaStream_t stream) {
  const dim3 grid((Bp + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  switch (ud_kind) {
    case 0:
      cf_kernel<NB, UNROLL, false, CHAIN, float><<<grid, block, 0, stream>>>(
          keT, nullptr, cols, loss, out, N, Bp, B, scale, u_l, u_r, n_inner,
          lr);
      break;
    case 1:
      cf_kernel<NB, UNROLL, true, CHAIN, float><<<grid, block, 0, stream>>>(
          keT, static_cast<const float*>(udT), cols, loss, out, N, Bp, B,
          scale, u_l, u_r, n_inner, lr);
      break;
    case 2:
      cf_kernel<NB, UNROLL, true, CHAIN, __nv_bfloat16>
          <<<grid, block, 0, stream>>>(
              keT, static_cast<const __nv_bfloat16*>(udT), cols, loss, out,
              N, Bp, B, scale, u_l, u_r, n_inner, lr);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool CHAIN>
cudaError_t launch(const void* keT, const void* udT, int ud_kind,
                   const void* cols, void* loss, void* out, int N, int Bp,
                   int B, float scale, float u_l, float u_r, int n_inner,
                   float lr, void* stream) {
  const float* k = static_cast<const float*>(keT);
  const float* c = static_cast<const float*>(cols);
  float* l = static_cast<float*>(loss);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 32)
    return launch_bucket<32, 32, CHAIN>(k, udT, ud_kind, c, l, o, N, Bp, B,
                                        scale, u_l, u_r, n_inner, lr, s);
  if (N <= 64)
    return launch_bucket<64, 64, CHAIN>(k, udT, ud_kind, c, l, o, N, Bp, B,
                                        scale, u_l, u_r, n_inner, lr, s);
  if (N <= 128)
    return launch_bucket<128, 1, CHAIN>(k, udT, ud_kind, c, l, o, N, Bp, B,
                                        scale, u_l, u_r, n_inner, lr, s);
  if (N <= 256)
    return launch_bucket<256, 1, CHAIN>(k, udT, ud_kind, c, l, o, N, Bp, B,
                                        scale, u_l, u_r, n_inner, lr, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// ud_kind: 0 = shared u_data (column kColUd of cols, udT unused),
//          1 = streamed float (N, Bp) plane, 2 = streamed bf16 plane.
// Every entry returns cudaGetLastError() after the launch (0 on success).
extern "C" int difffe_cf_step(const void* keT, const void* udT, int ud_kind,
                              const void* cols, void* loss, void* gradT,
                              int N, int Bp, int B, float scale, float u_l,
                              float u_r, void* stream) {
  return static_cast<int>(launch<false>(keT, udT, ud_kind, cols, loss, gradT,
                                        N, Bp, B, scale, u_l, u_r, 1, 0.f,
                                        stream));
}

extern "C" int difffe_cf_chain(const void* keT, const void* udT, int ud_kind,
                               const void* cols, void* loss, void* keT_out,
                               int N, int Bp, int B, float scale, float u_l,
                               float u_r, int n_inner, float lr,
                               void* stream) {
  return static_cast<int>(launch<true>(keT, udT, ud_kind, cols, loss,
                                       keT_out, N, Bp, B, scale, u_l, u_r,
                                       n_inner, lr, stream));
}
