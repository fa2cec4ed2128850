// Helpers shared by the fused 1D grad-step kernels K5a/K5b
// (fused_grad_pcr.cu), K6 (fused_grad_thomas.cu) and K7
// (fused_grad_mxu.cu), and by K8 (ell_apply.cu) for its rounding.
//
// Arithmetic: every product, sum, difference and quotient rounds on its own
// (the _rn intrinsics, which nvcc never contracts into a fused multiply-add),
// so a kernel that applies them in its plain PyTorch version's order gives
// that version's bits, as PyTorch's elementwise ops round each operation.
// Storage: a streamed plane is read as T or as bf16 and widened exactly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <map>
#include <mutex>
#include <utility>

namespace {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float quot(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double quot(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float expo(float x) { return expf(x); }
__device__ __forceinline__ double expo(double x) { return exp(x); }

// storage -> compute type, exact
__device__ __forceinline__ float stored(float x) { return x; }
__device__ __forceinline__ double stored(double x) { return x; }
__device__ __forceinline__ float stored(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, typename S>
__device__ __forceinline__ T load(const S* p, long long i) {
  return static_cast<T>(stored(p[i]));
}

constexpr int kMaxDevices = 64;

// The device attribute `Attr` of the current device (0 when the device
// cannot be queried), asked once per device and attribute.
template <cudaDeviceAttr Attr>
inline int device_attribute() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < kMaxDevices) {
    const int known = cached[dev].load(std::memory_order_relaxed);
    if (known > 0) return known;
  }
  int value = 0;
  if (cudaDeviceGetAttribute(&value, Attr, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) cached[dev].store(value, std::memory_order_relaxed);
  return value;
}

// The most dynamic shared memory one block may use on the current device
// (0 when the device cannot be queried).
inline int smem_optin_bytes() {
  return device_attribute<cudaDevAttrMaxSharedMemoryPerBlockOptin>();
}

// Launch `kernel` with `smem` bytes of dynamic shared memory on `stream`;
// returns cudaGetLastError().  Above the default 48 KB the kernel's limit
// is raised on the current device, once for each kernel, device and larger
// size.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, int blocks, int threads, size_t smem,
                     cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    static std::mutex mu;
    static std::map<std::pair<const void*, int>, size_t> raised;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    size_t& limit = raised[{reinterpret_cast<const void*>(kernel), dev}];
    if (smem > limit) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      limit = smem;
    }
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
