// Warp-tiled asynchronous staging and persistent grids, shared by K6's
// "reg" route (fused_grad_thomas.cu) and K7's "tc" route (tc_step.cuh,
// which K7 in fused_grad_mxu.cu and its ablations in k7_ablation.cu
// include).
//
// A warp owns a tile of consecutive scenarios.  Each (B, n) row-major plane
// gives the tile one contiguous span, which `stage` copies into the warp's
// own shared memory by 16-byte cp.async (plain loads for the ragged end and
// for any other layout); the caller double-buffers the spans, so the next
// tile's copy is in flight while this one computes.  A persistent grid
// (`persistent_blocks`: the card's resident blocks, from the occupancy API)
// walks the tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

#include "fused_step_common.cuh"

namespace {

// How a tile meets F: one row shared by the batch (staged once a block), or
// streamed rows stored as f32 or bf16 (FStore: the stored type).
constexpr int kFShared = 0, kFF32 = 1, kFBf16 = 2;

template <int FM>
struct FStore {
  using type = float;
};
template <>
struct FStore<kFBf16> {
  using type = __nv_bfloat16;
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
// a multiple of 16 bytes where the caller says `vec`), its ragged end and
// any other layout (a shared row: stride 0) by plain loads.
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

// Resident blocks an SM of `kern` at `threads` threads and `smem` bytes,
// asked once per kernel, device and size (0 when the card cannot be asked).
template <typename Kernel>
int resident_blocks(Kernel kern, int threads, size_t smem) {
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
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem) != cudaSuccess)
    return 0;
  known[key] = blocks;
  return blocks;
}

// Blocks of a persistent grid for `tiles` tiles at `warps` warps (a tile
// each) a block: the fewer of what the tiles need and what the card holds
// resident; 0 when the card cannot be asked or holds no block.
template <typename Kernel>
int persistent_blocks(Kernel kern, int warps, size_t smem, long long tiles) {
  if (raise_smem_limit(kern, smem) != cudaSuccess) return 0;
  const int per_sm = resident_blocks(kern, 32 * warps, smem);
  const int sms = device_attribute<cudaDevAttrMultiProcessorCount>();
  if (per_sm <= 0 || sms <= 0) return 0;
  const long long need = (tiles + warps - 1) / warps;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace
