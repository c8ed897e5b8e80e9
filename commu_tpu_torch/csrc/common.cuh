// Shared helpers for the hand-written Hopper kernels of commu_tpu_torch.
//
// Every kernel is templated on its storage type S (float or __nv_bfloat16)
// and computes in float32.  ``rnd<S>`` rounds a float32 value to S and back:
// it marks the places where the JAX reference casts an intermediate to the
// compute dtype, so a bf16 run rounds exactly where the reference does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace commu {

// dtype codes passed from the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// shared memory a block may use on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;
// what an entry point returns where a shape needs more shared memory than a
// block may use (ops/_build.py::launch raises ValueError for it)
constexpr int kRefusedSmem = -1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S>
__device__ __forceinline__ S from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename S>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<S>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Key j's column of head (b, h) among the keys [ring slabs | window] of the
// attention kernels: mem [B, R, H, dh, Tb] holds keys j < M = R * Tb, win
// [B, H, dh, T] the rest.  Returns the address of its head dim 0 and sets
// the stride between head dims.  No __restrict__: the projecting forward
// reads slabs that its own block wrote.
template <typename S>
__device__ __forceinline__ const S* key_column(const S* mem, const S* win, int b, int h, int j,
                                               int H, int dh, int R, int Tb, int T, int M,
                                               int* stride) {
  if (j < M) {
    const int r = j / Tb;
    *stride = Tb;
    return mem + (((static_cast<size_t>(b) * R + r) * H + h) * dh) * Tb + (j - r * Tb);
  }
  *stride = T;
  return win + ((static_cast<size_t>(b) * H + h) * dh) * T + (j - M);
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// default 48 KB; returns the CUDA status of the attribute call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace commu
