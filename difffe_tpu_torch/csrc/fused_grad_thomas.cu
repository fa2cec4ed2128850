// The fused per-element-kappa 1D grad step by Thomas elimination (kernel
// K6).
//
// Replaces the Pallas TPU kernel of
// difffe_tpu/ops/pallas/fused_grad_thomas_kernel.py: _fused_thomas_kernel
// behind _thomas_pallas.  Per scenario, with element row i coupling nodes
// (i, i+1) and the Dirichlet rows eliminated:
//
//   factor once:  bi_0 = 1 / d_0;  cp_{i-1} = a_i bi_{i-1};
//                 bi_i = 1 / (d_i - a_i cp_{i-1})
//   solve T u = r by forward and back substitution on those factors
//   loss = sum_i (u - u_data)_i^2
//   solve T lambda = scale (u - u_data) on the same factors
//   dkappa_e = -(1/h)(p lambda_e - p lambda_{e+1})(w_e - w_{e+1}),
//   w = mg + p u
//
// with the arithmetic of the plain PyTorch version in
// difffe_tpu_torch/ops/kernels/fused_grad_thomas_kernel.py, each operation
// in its order and rounded on its own (fused_step_common.cuh), so the
// kernel gives that version's bits.
//
// Two routes, which the wrapper's plan (k6_plan) picks from n and the
// dtype.  Both run one scenario a thread (Thomas is O(n) work per scenario
// against PCR's O(n log n), and the batch gives the parallelism; the TPU
// packed scenarios as (N, 8, B/8) so that each row step filled a native
// tile) with the same operations in the same order, so they give the same
// bits.
//
// "reg" (float32, n <= 32): the rows in registers.  The body is compiled
// for a row bucket NB = 16 or 32, the least that holds n, and every row
// loop unrolled with compile-time indices under `i < n` (uniform across
// the warp), so the factors cp and bi and the u and lambda rows are
// register arrays (~3n values live at the peak: lambda's forward values
// take bi's registers as they die).  The per-row constants m, p, m g and
// the coupling -p_{i-1} p_i / h ride in the kernel's parameter struct,
// read from the constant bank with compile-time indices (a launch carries
// its own copy: no race between streams, as a __constant__ table would
// have); a shared F is a per-call device tensor, which the host cannot
// read without a synchronizing copy, so a block stages it once into shared
// memory, read as a broadcast.  A warp owns 32
// consecutive scenarios: one contiguous span of each row-major plane
// (32 (n - 1) kappa values, 32 n of u_data and of a streamed F, each a
// multiple of 16 bytes in f32 and in bf16), staged into the warp's own
// shared memory by 16-byte cp.async, double buffered, so the next tile's
// copy is in flight while this one computes (async_copy.cuh; the ragged
// last tile's end, strided views and unaligned planes by plain loads).  A
// lane reads its scenario's row of a span ([scenario][row]: kappa's n - 1
// = 30 values a row at n = 31 make that a 2-way bank conflict).  The
// gradient goes back through the tile's kappa span, spent by then, as
// 16-byte stores; the loss is one coalesced store.  A persistent grid
// (the card's resident blocks, from the occupancy API) walks the tiles with
// no block barrier in the loop.  1 / x is __frcp_rn(x), IEEE's correctly
// rounded reciprocal: the bits of __fdiv_rn(1, x) in fewer instructions.
//
// "block" (float64, n > 32, or forced): the first design.  A block of `tb`
// scenarios first stages its tiles of kappa (B, n - 1), F and u_data
// (B, n), read as the caller holds them with coalesced loads, into shared
// memory transposed to [row][thread] (pitch tb + 1, so neither the
// transposing writes nor the row reads conflict on banks); a shared F
// (batch stride 0) is read in place.  The factors cp and bi and the u and
// lambda rows (~4n values a scenario, which a runtime n keeps out of
// registers) sit beside them in the same layout.  When 7n (tb + 1) values
// do not fit the block's shared memory for tb >= 32, the factors and
// rows live in a global workspace [row][scenario] (loads coalesce across
// the warp) and the inputs are read in place: n has no limit.  The
// gradient tile is written back through shared memory, coalesced.
//
// Bound: the step must read kappa, u_data and a streamed F and write the
// loss and the gradient once: (n - 1) + n + n + 1 + (n - 1) = 4n - 1
// values a scenario with a streamed F, 3n - 1 with a shared one (92
// values, 368 B at n = 31 in f32).  It does ~47 operations a row, one
// division among them (bi), ~1.6 operations per byte in float32, below the
// card's balance point: bytes bound it.  The first design stalls on its
// serial phases and the shared memory round trips of every row; the reg
// route overlaps a tile's copies with the last tile's recurrences and runs
// them from registers, so the instructions it runs set its pace (the
// step's arithmetic, which the bit-for-bit rule keeps unfused, and the
// unrolled rows' guards and addressing; PERF.md counts them).

#include <cstdint>

#include "async_copy.cuh"
#include "fused_step_common.cuh"

namespace {

constexpr int kMaxBlock = 128;
constexpr int kStaged = 7;  // kappa, u_data, F, cp, bi, u, lambda rows

template <typename T, typename TF, typename TU, bool kShared>
__global__ void __launch_bounds__(kMaxBlock)
thomas_kernel(const T* __restrict__ ke, long long sK,
              const TF* __restrict__ F, long long sF,
              const TU* __restrict__ ud, long long sU,
              const T* __restrict__ cols, T* __restrict__ loss,
              T* __restrict__ grad, T* __restrict__ ws, int B, int n,
              T inv_h, T scale) {
  extern __shared__ unsigned char smem_raw[];
  const int tb = blockDim.x, t = threadIdx.x, ne = n - 1;
  const long long s0 = static_cast<long long>(blockIdx.x) * tb;
  const long long left = static_cast<long long>(B) - s0;
  const int nsc = left < tb ? static_cast<int>(left) : tb;
  const long long g = s0 + t;
  // [row][column] arrays: shared memory (column = thread) or the global
  // workspace (column = scenario)
  const long long pitch =
      kShared ? tb + 1 : static_cast<long long>(gridDim.x) * tb;
  const long long col = kShared ? t : g;
  const long long plane = static_cast<long long>(n) * pitch;
  T* base = kShared ? reinterpret_cast<T*>(smem_raw) : ws;
  T* CP = base;
  T* BI = CP + plane;
  T* U = BI + plane;
  T* Z = U + plane;
  T* KE = Z + plane;  // staged tiles (kShared only)
  T* UD = KE + plane;
  T* FT = UD + plane;

  if (kShared) {
    for (int k = t; k < nsc * ne; k += tb) {
      const int s = k / ne, i = k - s * ne;
      KE[i * pitch + s] = ke[(s0 + s) * sK + i];
    }
    for (int k = t; k < nsc * n; k += tb) {
      const int s = k / n, i = k - s * n;
      UD[i * pitch + s] = load<T>(ud, (s0 + s) * sU + i);
      if (sF != 0) FT[i * pitch + s] = load<T>(F, (s0 + s) * sF + i);
    }
    __syncthreads();
  }

  const T zero = T(0), one = T(1), neg_inv_h = -inv_h;
  const T* cm = cols;
  const T* cp = cols + n;
  const T* cmg = cols + 2 * n;
  auto kap = [&](int i) -> T {
    if (i >= ne) return zero;  // node row n - 1 carries no element
    return kShared ? KE[i * pitch + t] : ke[g * sK + i];
  };
  auto obs = [&](int i) -> T {
    return kShared ? UD[i * pitch + t] : load<T>(ud, g * sU + i);
  };
  auto load_f = [&](int i) -> T {
    if (sF == 0) return load<T>(F, i);
    return kShared ? FT[i * pitch + t] : load<T>(F, g * sF + i);
  };
  auto a_row = [&](int i) -> T {  // a_i = e_{i-1} = -kappa_{i-1}/h p_{i-1} p_i
    return mul(kap(i - 1), mul(mul(neg_inv_h, cp[i - 1]), cp[i]));
  };
  auto at = [&](T* arr, int i) -> T& { return arr[i * pitch + col]; };

  if (t < nsc) {
    // the factorization, with the forward substitution of T u = r
    T bi = quot(one, add(cm[0], mul(mul(cp[0], kap(0)), inv_h)));
    T k_prev = zero, y = zero;
    for (int i = 0; i < n; ++i) {
      const T k_i = kap(i);
      const T mg_next = i < n - 1 ? cmg[i + 1] : zero;
      const T mg_prev = i > 0 ? cmg[i - 1] : zero;
      const T kmg = mul(sub(sub(mul(add(k_prev, k_i), cmg[i]),
                                mul(k_i, mg_next)),
                            mul(k_prev, mg_prev)),
                        inv_h);
      const T r = add(cmg[i], mul(cp[i], sub(load_f(i), kmg)));
      if (i == 0) {
        y = mul(r, bi);
      } else {
        const T a = a_row(i);
        const T d = add(cm[i], mul(mul(cp[i], add(k_prev, k_i)), inv_h));
        const T c = mul(a, bi);
        at(CP, i - 1) = c;
        bi = quot(one, sub(d, mul(a, c)));
        y = mul(sub(r, mul(a, y)), bi);
      }
      at(BI, i) = bi;
      at(U, i) = y;
      k_prev = k_i;
    }
    for (int i = n - 2; i >= 0; --i)
      at(U, i) = sub(at(U, i), mul(at(CP, i), at(U, i + 1)));

    // the loss, with the forward substitution of
    // T lambda = scale (u - u_data)
    T acc = zero, z = zero;
    for (int i = 0; i < n; ++i) {
      const T d = sub(at(U, i), obs(i));
      acc = add(acc, mul(d, d));
      const T rhs = mul(scale, d);
      z = i == 0 ? mul(rhs, at(BI, 0))
                 : mul(sub(rhs, mul(a_row(i), z)), at(BI, i));
      at(Z, i) = z;
    }
    loss[g] = acc;

    // the back substitution of lambda, with the gradient of element e
    T lam_n = at(Z, n - 1), u_n = at(U, n - 1);
    for (int e = n - 2; e >= 0; --e) {
      const T lam_e = sub(at(Z, e), mul(at(CP, e), lam_n));
      const T u_e = at(U, e);
      const T pl = sub(mul(cp[e], lam_e), mul(cp[e + 1], lam_n));
      const T w = sub(add(cmg[e], mul(cp[e], u_e)),
                      add(cmg[e + 1], mul(cp[e + 1], u_n)));
      const T ge = mul(mul(neg_inv_h, pl), w);
      if (kShared)
        KE[e * pitch + t] = ge;  // this thread's kappa column is spent
      else
        grad[g * ne + e] = ge;
      lam_n = lam_e;
      u_n = u_e;
    }
  }

  if (kShared) {
    __syncthreads();
    for (int k = t; k < nsc * ne; k += tb) {
      const int s = k / ne, e = k - s * ne;
      grad[(s0 + s) * ne + e] = KE[e * pitch + s];
    }
  }
}

// Scenarios a block holds and whether its rows fit shared memory.
struct Plan {
  int tb;
  bool shared;
};

Plan plan(int n, int block_lanes, int itemsize) {
  const int cap = block_lanes < kMaxBlock ? block_lanes : kMaxBlock;
  const long long budget = smem_optin_bytes();
  for (int tb = cap;; tb /= 2) {
    const long long bytes =
        static_cast<long long>(kStaged) * n * (tb + 1) * itemsize;
    if (bytes <= budget) return {tb, true};
    if (tb <= 32) return {cap, false};
  }
}

size_t smem_bytes(const Plan& p, int n, int itemsize) {
  return p.shared ? static_cast<size_t>(kStaged) * n * (p.tb + 1) * itemsize
                  : 0;
}

template <typename T, typename TF, typename TU>
int launch_t(const void* ke, long long sK, const void* F, long long sF,
             const void* ud, long long sU, const void* cols, void* loss,
             void* grad, void* ws, int B, int n, int block_lanes,
             double inv_h, double scale, cudaStream_t stream) {
  if (n < 2 || B < 1 || block_lanes < 1) return cudaErrorInvalidValue;
  const Plan p = plan(n, block_lanes, sizeof(T));
  if (!p.shared && ws == nullptr) return cudaErrorInvalidValue;
  const int blocks = (B + p.tb - 1) / p.tb;
  const size_t smem = smem_bytes(p, n, sizeof(T));
  auto args = [&](auto kernel) {
    return launch_with_smem(
        kernel, blocks, p.tb, smem, stream, static_cast<const T*>(ke), sK,
        static_cast<const TF*>(F), sF, static_cast<const TU*>(ud), sU,
        static_cast<const T*>(cols), static_cast<T*>(loss),
        static_cast<T*>(grad), static_cast<T*>(ws), B, n, T(inv_h),
        T(scale));
  };
  if (p.shared) return args(thomas_kernel<T, TF, TU, true>);
  return args(thomas_kernel<T, TF, TU, false>);
}

template <typename T>
int launch(const void* ke, long long sK, const void* F, long long sF,
           int f_code, const void* ud, long long sU, int u_code,
           const void* cols, void* loss, void* grad, void* ws, int B, int n,
           int block_lanes, double inv_h, double scale, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (f_code == 0 && u_code == 0)
    return launch_t<T, T, T>(ke, sK, F, sF, ud, sU, cols, loss, grad, ws, B,
                             n, block_lanes, inv_h, scale, st);
  if (f_code == 0 && u_code == 1)
    return launch_t<T, T, bf16>(ke, sK, F, sF, ud, sU, cols, loss, grad, ws,
                                B, n, block_lanes, inv_h, scale, st);
  if (f_code == 1 && u_code == 1)
    return launch_t<T, bf16, bf16>(ke, sK, F, sF, ud, sU, cols, loss, grad,
                                   ws, B, n, block_lanes, inv_h, scale, st);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The "reg" route
// ---------------------------------------------------------------------------

constexpr int kRegBlock = 128;  // four warps, a tile of 32 scenarios each
constexpr int kRegWarps = kRegBlock / 32;
constexpr int kRegTile = 32;
// at most 168 registers a thread: three blocks, 12 warps, an SM
constexpr int kRegMinBlocks = 3;
constexpr int kRegNodes = 32;  // the largest row bucket NB (16 or 32)
// 1 / x correctly rounded: the bits of quot(1, x)
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// A launch's operands and, by value, the mesh's rows (zero past n).
template <int NB>
struct RegArgs {
  const float* ke;
  long long sK;
  const void* F;  // (n,) shared (sF = 0), or (B, n) rows
  long long sF;
  int f_code;  // storage of a shared F: 0 f32, 1 bf16
  const void* ud;
  long long sU;
  float* loss;
  float* grad;
  int B, n;
  float inv_h, neg_inv_h, scale;
  bool vec_k, vec_u, vec_f, vec_g;  // contiguous and 16-byte aligned
  float m[NB], p[NB], mg[NB];
  float e[NB];  // e_i = (-1/h) p_{i-1} p_i, rounded as the block route's
};

template <typename TU, int FM>
__host__ __device__ void reg_spans(int n, int& span_k, int& span_u,
                                   int& span_f) {
  using TF = typename FStore<FM>::type;
  span_k = round16(kRegTile * (n - 1) * 4);
  span_u = round16(kRegTile * n * static_cast<int>(sizeof(TU)));
  span_f = FM == kFShared
               ? 0
               : round16(kRegTile * n * static_cast<int>(sizeof(TF)));
}

// Shared memory of a block: a shared F's row and each warp's two buffers of
// its tile's kappa, u_data and streamed F spans.
template <int NB, typename TU, int FM>
size_t reg_smem_bytes(int n) {
  int span_k, span_u, span_f;
  reg_spans<TU, FM>(n, span_k, span_u, span_f);
  return round16(NB * 4) +
         static_cast<size_t>(kRegWarps) * 2 * (span_k + span_u + span_f);
}

// One scenario's step from its staged rows: kr its kappa row (n - 1
// values, overwritten with its gradient), ur its u_data row, fr its
// streamed F row or fs the shared one.  Every row loop is unrolled over the
// bucket with compile-time indices, so the factors and rows are registers.
// Returns the loss.
template <int NB, typename TU, typename TF, bool kStreamF>
__device__ __forceinline__ float thomas_rows(const RegArgs<NB>& a, float* kr,
                                             const TU* ur, const TF* fr,
                                             const float* fs, int n) {
  const int ne = n - 1;
  const float inv_h = a.inv_h, neg_inv_h = a.neg_inv_h, scale = a.scale;
  auto kap = [&](int i) -> float {
    return i < ne ? kr[i] : 0.0f;  // node row n - 1 carries no element
  };
  auto f_at = [&](int i) -> float {
    if constexpr (kStreamF)
      return load<float>(fr, i);
    else
      return fs[i];
  };
  float cpv[NB], biv[NB], uv[NB];

  // the factorization, with the forward substitution of T u = r
  float bi = recip(add(a.m[0], mul(mul(a.p[0], kap(0)), inv_h)));
  float k_prev = 0.0f, y = 0.0f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (i < n) {
      const float k_i = kap(i);
      const float mg_next = i < n - 1 ? a.mg[i + 1 < NB ? i + 1 : i] : 0.0f;
      const float mg_prev = i > 0 ? a.mg[i > 0 ? i - 1 : 0] : 0.0f;
      const float kmg = mul(sub(sub(mul(add(k_prev, k_i), a.mg[i]),
                                    mul(k_i, mg_next)),
                                mul(k_prev, mg_prev)),
                            inv_h);
      const float r = add(a.mg[i], mul(a.p[i], sub(f_at(i), kmg)));
      if (i == 0) {
        y = mul(r, bi);
      } else {
        const float ai = mul(k_prev, a.e[i]);  // a_i = kappa_{i-1} e_i
        const float d =
            add(a.m[i], mul(mul(a.p[i], add(k_prev, k_i)), inv_h));
        const float c = mul(ai, bi);
        cpv[i > 0 ? i - 1 : 0] = c;
        bi = recip(sub(d, mul(ai, c)));
        y = mul(sub(r, mul(ai, y)), bi);
      }
      biv[i] = bi;
      uv[i] = y;
      k_prev = k_i;
    }
  }
#pragma unroll
  for (int i = NB - 2; i >= 0; --i)
    if (i <= n - 2) uv[i] = sub(uv[i], mul(cpv[i], uv[i + 1]));

  // the loss, with the forward substitution of T lambda = scale (u -
  // u_data); lambda's forward values take bi's registers
  float acc = 0.0f, z = 0.0f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (i < n) {
      const float d = sub(uv[i], load<float>(ur, i));
      acc = add(acc, mul(d, d));
      const float rhs = mul(scale, d);
      if (i == 0)
        z = mul(rhs, biv[0]);
      else
        z = mul(sub(rhs, mul(mul(kap(i > 0 ? i - 1 : 0), a.e[i]), z)),
                biv[i]);
      biv[i] = z;
    }
  }

  // the back substitution of lambda, with the gradient of element e over
  // the spent kappa row
  float lam_n = 0.0f, u_n = 0.0f;
#pragma unroll
  for (int e = NB - 2; e >= 0; --e) {
    if (e == n - 2) {
      lam_n = biv[e + 1];
      u_n = uv[e + 1];
    }
    if (e <= n - 2) {
      const float lam_e = sub(biv[e], mul(cpv[e], lam_n));
      const float u_e = uv[e];
      const float pl = sub(mul(a.p[e], lam_e), mul(a.p[e + 1], lam_n));
      const float w = sub(add(a.mg[e], mul(a.p[e], u_e)),
                          add(a.mg[e + 1], mul(a.p[e + 1], u_n)));
      kr[e] = mul(mul(neg_inv_h, pl), w);
      lam_n = lam_e;
      u_n = u_e;
    }
  }
  return acc;
}

template <int NB, typename TU, int FM>
__global__ void __launch_bounds__(kRegBlock, kRegMinBlocks)
thomas_reg_kernel(const RegArgs<NB> a) {
  using TF = typename FStore<FM>::type;
  constexpr bool kStreamF = FM != kFShared;
  extern __shared__ __align__(16) unsigned char reg_smem[];
  const int n = a.n, ne = n - 1;
  const long long B = a.B;
  int span_k, span_u, span_f;
  reg_spans<TU, FM>(n, span_k, span_u, span_f);
  const int span = span_k + span_u + span_f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* fs = reinterpret_cast<float*>(reg_smem);  // a shared F, [NB]
  unsigned char* mine = reg_smem + round16(NB * 4) + warp * 2 * span;
  if constexpr (!kStreamF) {
    for (int i = threadIdx.x; i < NB; i += blockDim.x) {
      float v = 0.0f;
      if (i < n)
        v = a.f_code
                ? load<float>(static_cast<const __nv_bfloat16*>(a.F), i)
                : static_cast<const float*>(a.F)[i];
      fs[i] = v;
    }
    __syncthreads();  // once, before the tiles
  }

  const TU* ud = static_cast<const TU*>(a.ud);
  const TF* Fg = static_cast<const TF*>(a.F);
  const long long tiles = (B + kRegTile - 1) / kRegTile;
  const long long step = static_cast<long long>(gridDim.x) * kRegWarps;
  auto kbuf = [&](int b) { return reinterpret_cast<float*>(mine + b * span); };
  auto ubuf = [&](int b) {
    return reinterpret_cast<TU*>(mine + b * span + span_k);
  };
  auto fbuf = [&](int b) {
    return reinterpret_cast<TF*>(mine + b * span + span_k + span_u);
  };
  auto rows_of = [&](long long t) {
    const long long left = B - t * kRegTile;
    return static_cast<int>(left < kRegTile ? left : kRegTile);
  };
  auto prefetch = [&](long long t, int b) {
    if (t < tiles) {
      const long long s0 = t * kRegTile;
      const int rows = rows_of(t);
      stage(kbuf(b), a.ke, s0, rows, ne, a.sK, a.vec_k, lane);
      stage(ubuf(b), ud, s0, rows, n, a.sU, a.vec_u, lane);
      if constexpr (kStreamF)
        stage(fbuf(b), Fg, s0, rows, n, a.sF, a.vec_f, lane);
    }
    cp_async_commit();
  };

  long long tile = static_cast<long long>(blockIdx.x) * kRegWarps + warp;
  prefetch(tile, 0);
  for (int b = 0; tile < tiles; tile += step, b ^= 1) {
    __syncwarp();  // every lane is done with buffer b ^ 1
    prefetch(tile + step, b ^ 1);
    cp_async_wait_prior();
    __syncwarp();  // this tile's spans, from every lane's copies
    float* K = kbuf(b);
    const long long s0 = tile * kRegTile;
    const int rows = rows_of(tile);
    if (lane < rows)
      a.loss[s0 + lane] = thomas_rows<NB, TU, TF, kStreamF>(
          a, K + lane * ne, ubuf(b) + lane * n, fbuf(b) + lane * n, fs, n);
    __syncwarp();  // every lane's gradient row is in the span
    float* G = a.grad + s0 * ne;
    const int count = rows * ne;
    int k = lane;
    if (a.vec_g) {
      const int chunks = count / 4;
      for (int c = lane; c < chunks; c += 32)
        reinterpret_cast<float4*>(G)[c] =
            reinterpret_cast<const float4*>(K)[c];
      k = chunks * 4 + lane;
    }
    for (; k < count; k += 32) G[k] = K[k];
  }
}

template <int NB, typename TU, int FM>
int launch_reg_t(const RegArgs<NB>& a, cudaStream_t st) {
  auto kern = thomas_reg_kernel<NB, TU, FM>;
  const size_t smem = reg_smem_bytes<NB, TU, FM>(a.n);
  const long long tiles =
      (static_cast<long long>(a.B) + kRegTile - 1) / kRegTile;
  const int blocks = persistent_blocks(kern, kRegWarps, smem, tiles);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  return launch_with_smem(kern, blocks, kRegBlock, smem, st, a);
}

template <int NB>
int launch_reg(const RegArgs<NB>& a, int u_code, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int fm = a.sF == 0 ? kFShared : (a.f_code ? kFBf16 : kFF32);
  if (u_code == 0 && fm == kFShared)
    return launch_reg_t<NB, float, kFShared>(a, st);
  if (u_code == 0 && fm == kFF32)
    return launch_reg_t<NB, float, kFF32>(a, st);
  if (u_code == 1 && fm == kFShared)
    return launch_reg_t<NB, bf16, kFShared>(a, st);
  if (u_code == 1 && fm == kFF32)
    return launch_reg_t<NB, bf16, kFF32>(a, st);
  if (u_code == 1 && fm == kFBf16)
    return launch_reg_t<NB, bf16, kFBf16>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Elements of the global workspace a launch needs: 0 when the rows fit
// shared memory, else the four [row][scenario] arrays cp, bi, u, lambda.
extern "C" long long difffe_thomas_workspace(int B, int n, int block_lanes,
                                             int is_double) {
  if (n < 2 || B < 1 || block_lanes < 1) return 0;
  const Plan p = plan(n, block_lanes, is_double ? 8 : 4);
  if (p.shared) return 0;
  const long long blocks = (B + p.tb - 1) / p.tb;
  return 4LL * n * blocks * p.tb;
}

// One fused per-element-kappa grad step for B scenarios of n nodes: ke the
// element values (B, n - 1) rows with batch stride sK; F and u_data (B, n)
// rows with unit stride along n and batch strides sF, sU (0: shared),
// stored as the compute type (code 0) or bf16 (code 1); cols the (3, n)
// block (m, p, m g).  Writes loss (B,) and grad (B, n - 1), contiguous.
// float32, or float64 when `is_double`; `ws` the workspace when
// difffe_thomas_workspace is nonzero.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int difffe_fused_thomas(const void* ke, long long sK,
                                   const void* F, long long sF, int f_code,
                                   const void* ud, long long sU, int u_code,
                                   const void* cols, void* loss, void* grad,
                                   void* ws, int B, int n, int block_lanes,
                                   double inv_h, double scale, int is_double,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(ke, sK, F, sF, f_code, ud, sU, u_code, cols, loss,
                          grad, ws, B, n, block_lanes, inv_h, scale, s);
  return launch<float>(ke, sK, F, sF, f_code, ud, sU, u_code, cols, loss,
                       grad, ws, B, n, block_lanes, inv_h, scale, s);
}

// The "reg" route of the same step: float32 and n <= 32 only, the same
// operands, strides and storage codes as difffe_fused_thomas, and `rows`
// the (3, n) block (m, p, m g) in host memory (it rides in the kernel's
// parameters).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
namespace {

// The reg route's launch in bucket NB: the operands and the mesh's rows
// into the kernel's parameter struct.
template <int NB>
int launch_reg_rows(const void* ke, long long sK, const void* F, long long sF,
                    int f_code, const void* ud, long long sU, int u_code,
                    const void* rows, void* loss, void* grad, int B, int n,
                    double inv_h, double scale, cudaStream_t st) {
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  RegArgs<NB> a{};
  a.ke = static_cast<const float*>(ke);
  a.sK = sK;
  a.F = F;
  a.sF = sF;
  a.f_code = f_code;
  a.ud = ud;
  a.sU = sU;
  a.loss = static_cast<float*>(loss);
  a.grad = static_cast<float*>(grad);
  a.B = B;
  a.n = n;
  a.inv_h = static_cast<float>(inv_h);
  a.neg_inv_h = -a.inv_h;
  a.scale = static_cast<float>(scale);
  a.vec_k = sK == n - 1 && aligned(ke);
  a.vec_u = sU == n && aligned(ud);
  a.vec_f = sF == n && aligned(F);
  a.vec_g = aligned(grad);
  const float* r = static_cast<const float*>(rows);
  for (int i = 0; i < n; ++i) {
    a.m[i] = r[i];
    a.p[i] = r[n + i];
    a.mg[i] = r[2 * n + i];
  }
  // binary32 products, each rounded once: the block route's
  // mul(mul(neg_inv_h, p_{i-1}), p_i)
  for (int i = 1; i < n; ++i) {
    const float t = a.neg_inv_h * a.p[i - 1];
    a.e[i] = t * a.p[i];
  }
  return launch_reg(a, u_code, st);
}

}  // namespace

extern "C" int difffe_fused_thomas_reg(const void* ke, long long sK,
                                       const void* F, long long sF,
                                       int f_code, const void* ud,
                                       long long sU, int u_code,
                                       const void* rows, void* loss,
                                       void* grad, int B, int n, double inv_h,
                                       double scale, void* stream) {
  if (n < 2 || n > kRegNodes || B < 1 || f_code < 0 || f_code > 1 ||
      u_code < 0 || u_code > 1 || (f_code == 1 && u_code == 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 16)
    return launch_reg_rows<16>(ke, sK, F, sF, f_code, ud, sU, u_code, rows,
                               loss, grad, B, n, inv_h, scale, st);
  return launch_reg_rows<kRegNodes>(ke, sK, F, sF, f_code, ud, sU, u_code,
                                    rows, loss, grad, B, n, inv_h, scale, st);
}
