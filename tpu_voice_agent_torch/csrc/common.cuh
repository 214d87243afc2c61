// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is `extern "C"`, takes raw device pointers and the
// caller's stream, launches, and returns `cudaGetLastError()` as an int so the
// Python wrapper (ops/_lib.py, loaded with ctypes) can raise on a refused
// launch. Kernels allocate nothing and never synchronise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TVA_NEG_INF (-1e30f)  // the masked-score value of the JAX kernels

#define TVA_DISPATCH_HD(hd, ...)                         \
  switch (hd) {                                          \
    case 16: { constexpr int HD = 16; __VA_ARGS__; break; }   \
    case 32: { constexpr int HD = 32; __VA_ARGS__; break; }   \
    case 48: { constexpr int HD = 48; __VA_ARGS__; break; }   \
    case 64: { constexpr int HD = 64; __VA_ARGS__; break; }   \
    case 128: { constexpr int HD = 128; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;          \
  }

// Activations (and the flat decode kernel's cache) arrive as bf16 (a bf16
// model) or fp32 (an fp32 model such as the distilled intent checkpoint or
// the in-repo Whisper checkpoints); the kernels compute in fp32 either way.
#define TVA_DTYPE_BF16 0
#define TVA_DTYPE_F32 1

__device__ __forceinline__ float tva_ld(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float tva_ld(float x) { return x; }
__device__ __forceinline__ void tva_st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void tva_st(float* p, float x) { *p = x; }

__device__ __forceinline__ float tva_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float tva_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Ask for more than the default 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t tva_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
