// The cache loaders shared by the fp32 decode-attention bodies: the split-key
// body (decode_split.cuh: K2, K3, K5, K10, K12) and the paged body
// (decode_attention.cuh: K6, K8, and K7 / K9 with fp32 queries); the
// quantized tags also name the pools of paged_split.cuh. One vector load of a cache row's chunk
// (`Chunk<TC>::Raw`) is widened to fp32 into shared memory: bf16 and fp32
// caches as they are, a quantized cache (the KV_QUANT tiers, ops/kvquant.py)
// as int * its key row's bf16 scale. That product is exact (|int| <= 127
// times a bf16 scale has at most 15 significant bits), so a widened tile
// equals the plain version's fp32 dequantization and the rest of a body is
// the same for every cache type.
#pragma once

#include "common.cuh"

namespace {

// Quantized cache tags (the KV_QUANT pool): int8 values, or two int4 values
// per byte, the low nibble holding dims [0, hd/2) and the high nibble dims
// [hd/2, hd); either way a bf16 scale per (key row, kv head).
struct QInt8 {};
struct QInt4 {};

// One vector load of a cache row (Raw: N stored elements of type Store),
// widened to fp32 into 16-byte-aligned shared memory. A head's row holds
// HD / PACK stored elements; chunk ch covers stored elements [ch N, ch N + N).
template <typename TC>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  using Store = __nv_bfloat16;
  using Raw = uint4;
  static constexpr bool QUANT = false;
  static constexpr int N = 8, PACK = 1;
  // bf16 -> fp32 is the high half of the fp32 bit pattern; each 32-bit word
  // holds two bf16, the lower address in the low half
  template <int HD>
  __device__ static void widen(const Raw& u, float, float* row, int ch) {
    float4* d = reinterpret_cast<float4*>(row + ch * N);
    d[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    d[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                       __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
  }
};
template <>
struct Chunk<float> {
  using Store = float;
  using Raw = uint4;
  static constexpr bool QUANT = false;
  static constexpr int N = 4, PACK = 1;
  template <int HD>
  __device__ static void widen(const Raw& u, float, float* row, int ch) {
    *reinterpret_cast<float4*>(row + ch * N) = make_float4(
        __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z), __uint_as_float(u.w));
  }
};

// the four signed bytes of a word (lowest address first), times the scale
__device__ __forceinline__ float4 tva_i8x4(unsigned w, float sc) {
  return make_float4((float)((int)(w << 24) >> 24) * sc, (float)((int)(w << 16) >> 24) * sc,
                     (float)((int)(w << 8) >> 24) * sc, (float)((int)w >> 24) * sc);
}
// the sign-extended low (or high) nibbles of a word's four bytes, times the scale
__device__ __forceinline__ float4 tva_lo4x4(unsigned w, float sc) {
  return make_float4((float)((int)(w << 28) >> 28) * sc, (float)((int)(w << 20) >> 28) * sc,
                     (float)((int)(w << 12) >> 28) * sc, (float)((int)(w << 4) >> 28) * sc);
}
__device__ __forceinline__ float4 tva_hi4x4(unsigned w, float sc) {
  return make_float4((float)((int)(w << 24) >> 28) * sc, (float)((int)(w << 16) >> 28) * sc,
                     (float)((int)(w << 8) >> 28) * sc, (float)((int)w >> 28) * sc);
}

// int8: 16 bytes, 16 values. A head's row is HD bytes, a multiple of 16 at
// every head dim the quantized kernels take, so the load is aligned.
template <>
struct Chunk<QInt8> {
  using Store = int8_t;
  using Raw = uint4;
  static constexpr bool QUANT = true;
  static constexpr int N = 16, PACK = 1;
  template <int HD>
  __device__ static void widen(const Raw& u, float sc, float* row, int ch) {
    float4* d = reinterpret_cast<float4*>(row + ch * N);
    d[0] = tva_i8x4(u.x, sc);
    d[1] = tva_i8x4(u.y, sc);
    d[2] = tva_i8x4(u.z, sc);
    d[3] = tva_i8x4(u.w, sc);
  }
};
// int4: 8 bytes, 16 values. A head's row is HD / 2 bytes (24 at hd 48, so a
// head starts at any multiple of 8 bytes): 8-byte loads stay aligned. Byte j
// of chunk ch holds dim 8 ch + j in its low nibble and dim HD / 2 + 8 ch + j
// in its high nibble.
template <>
struct Chunk<QInt4> {
  using Store = int8_t;
  using Raw = uint2;
  static constexpr bool QUANT = true;
  static constexpr int N = 8, PACK = 2;
  template <int HD>
  __device__ static void widen(const Raw& u, float sc, float* row, int ch) {
    float4* lo = reinterpret_cast<float4*>(row + ch * N);
    float4* hi = reinterpret_cast<float4*>(row + HD / 2 + ch * N);
    lo[0] = tva_lo4x4(u.x, sc);
    lo[1] = tva_lo4x4(u.y, sc);
    hi[0] = tva_hi4x4(u.x, sc);
    hi[1] = tva_hi4x4(u.y, sc);
  }
};

}  // namespace
