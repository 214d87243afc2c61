// The decode-attention template body shared by K2, K3, K5 (decode_attention.cu),
// K6, K7 (paged_attention.cu), K8, K9 (paged_attention_quant.cu) and K10
// (decode_attention_quant.cu): T <= 16 query tokens per batch row against a
// KV cache, or a paged KV pool read through block tables; q/o bf16 or fp32
// (TQ), the cache bf16, fp32 or quantized (TC: QInt8, QInt4), arithmetic in
// fp32. Each source instantiates only its own part, so they compile in
// parallel.
//
// Its design: one block per (kv head, batch row). The `group * T` query rows
// of one kv head share every K/V tile, which is read once from device memory
// into shared memory (fp32, 32 keys per tile); the next tile's loads are
// issued into registers before the current tile is computed; 16 warps each
// own a fixed set of query rows (row w + 16 i), keep their running max, sum
// and output accumulator in registers, and read shared memory as float4 so
// one K load feeds every row of the warp. Each block stops at its own row's
// frontier (the largest of its query positions); keys past S load as zeros
// and are masked, and a row with no valid key writes zeros (the TPU kernel's
// `acc / (l or 1)`). With PAGED the tile loader resolves each key row s
// through the row's block table (pool row table[b, s / bs] * bs + s % bs of
// the layer plane), so any block size works and a 32-key tile may straddle
// two pool blocks; the dense instantiations keep a plain row stride.
// A quantized cache (the KV_QUANT pool, ops/kvquant.py) is widened by the
// same loader: it reads the int8 chunk (or the packed int4 chunk) and the
// key row's bf16 scale from the layer's scale plane, at key_row(s) * nkv +
// kvh, and writes int * scale into the fp32 tile. That product is exact
// (|int| <= 127 times a bf16 scale has at most 15 significant bits), so the
// tile equals the plain version's fp32 dequantization and the rest of the
// body is the same for every cache type. The TPU kernels fold the scales
// into the score and probability tiles instead, `(q . k_int) * ks`, which
// differs from this only by fp32 summation order.
// Splitting the key range across blocks (flash-decoding), tensor-core
// products and reading a shared prefix block once per kv head across rows
// are later work.
#pragma once

#include "common.cuh"

namespace {

constexpr int BK = 32;  // keys per tile: one per lane
constexpr int NWARPS = 16;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_T = 16;

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

// The (T * group) query rows of one (kv head, batch row); row r is query
// r / group of q head kvh * group + r % group. Warp w owns rows w + 16 i for
// i < RW. PAGED: keys are read through a block table (K6-K9); the dense
// instantiations (K2/K3/K5/K10) keep a plain row stride, free of the lookup.
// ksc/vsc: the scale planes of a quantized cache (null otherwise), one bf16
// per (cache row, kv head).
template <int HD, int RW, bool PAGED, typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const typename Chunk<TC>::Store* __restrict__ kc,
              const typename Chunk<TC>::Store* __restrict__ vc,
              const __nv_bfloat16* __restrict__ ksc, const __nv_bfloat16* __restrict__ vsc,
              const int* __restrict__ kv_len,
              const int* __restrict__ qpos, const int* __restrict__ table, int bs,
              TQ* __restrict__ o, int T, int S, int nq, int nkv, float scale) {
  constexpr int KP = HD + 4;          // padded K pitch: float4 rows on distinct banks
  constexpr int NC = (HD + 31) / 32;  // output dims per lane
  constexpr int D4 = HD / 4;
  using CK = Chunk<TC>;
  using Store = typename CK::Store;
  constexpr int EPC = CK::N;          // stored elements per chunk
  constexpr int HDP = HD / CK::PACK;  // stored elements per head row
  constexpr int CHUNKS = HDP / EPC;   // chunks per key row
  static_assert(HDP % EPC == 0, "a head's cache row must split into whole chunks");
  constexpr int LOADS = (2 * BK * CHUNKS + THREADS - 1) / THREADS;  // per thread per tile
  const int group = nq / nkv;
  const int rows = T * group;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [rows][HD]
  float* Ks = Qs + rows * HD;       // [BK][KP]
  float* Vs = Ks + BK * KP;         // [BK][HD]
  float* Ps = Vs + BK * HD;         // [NWARPS][RW][BK]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x, b = blockIdx.y;

  for (int i = tid; i < rows * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int h = kvh * group + r % group;
    Qs[i] = tva_ld(q[((size_t)(b * T + r / group) * nq + h) * HD + d]);
  }
  int pos[MAX_T];
  int max_pos = -1;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    pos[t] = -1;
    // a frontier past the cache means every slot (keys >= S are never valid)
    if (t < T) pos[t] = min(kv_len != nullptr ? kv_len[b] - 1 : qpos[b * T + t], S - 1);
    max_pos = max(max_pos, pos[t]);
  }
  const int kend = min(max_pos + 1, S);

  // this warp's rows: frontier, running max / sum, accumulator
  int rpos[RW];
  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NWARPS * i;
    int p = -1;
#pragma unroll
    for (int t = 0; t < MAX_T; ++t)
      if (r < rows && t == r / group) p = pos[t];
    rpos[i] = p;
    m[i] = TVA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // K/V tile loads, staged in registers one tile ahead. Key s of row b is
  // cache row b * S + s, or (paged) pool row table[b, s / bs] * bs + s % bs
  // of the layer plane; a quantized row's scale is at that row * nkv + kvh
  // of the scale plane.
  const size_t row0 = PAGED ? 0 : (size_t)b * S;
  const size_t row_stride = (size_t)nkv * HDP;
  const Store* kbase = kc + (row0 * nkv + kvh) * HDP;
  const Store* vbase = vc + (row0 * nkv + kvh) * HDP;
  const __nv_bfloat16* ksbase = CK::QUANT ? ksc + row0 * nkv + kvh : nullptr;
  const __nv_bfloat16* vsbase = CK::QUANT ? vsc + row0 * nkv + kvh : nullptr;
  const int* trow = PAGED ? table + (size_t)b * (S / bs) : nullptr;
  auto key_row = [&](int s) -> size_t {
    if constexpr (PAGED) return (size_t)trow[s / bs] * bs + s % bs;
    else return (size_t)s;
  };
  typename CK::Raw pre[LOADS];
  float pre_s[LOADS];  // the chunk's row scale (quantized caches only)
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + THREADS * j;  // chunk id over [K rows | V rows]
      pre[j] = typename CK::Raw{};
      pre_s[j] = 0.f;
      if (i < 2 * BK * CHUNKS) {
        const int kv = i / (BK * CHUNKS), rem = i % (BK * CHUNKS);
        const int s = k0 + rem / CHUNKS, ch = rem % CHUNKS;
        if (s < S) {
          const size_t r = key_row(s);
          pre[j] = *reinterpret_cast<const typename CK::Raw*>((kv ? vbase : kbase) +
                                                              r * row_stride + ch * EPC);
          if constexpr (CK::QUANT) pre_s[j] = __bfloat162float((kv ? vsbase : ksbase)[r * nkv]);
        }
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + THREADS * j;
      if (i < 2 * BK * CHUNKS) {
        const int kv = i / (BK * CHUNKS), rem = i % (BK * CHUNKS);
        const int key = rem / CHUNKS, ch = rem % CHUNKS;
        CK::template widen<HD>(pre[j], pre_s[j], kv ? Vs + key * HD : Ks + key * KP, ch);
      }
    }
  };

  if (kend > 0) load_tile(0);
  float* ps = Ps + warp * RW * BK;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile (and Qs is written)
    store_tile();
    __syncthreads();
    if (k0 + BK < kend) load_tile(k0 + BK);  // in flight while this tile computes

    // scores: lane = key k0 + lane, every row of the warp at once
    float dot[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) dot[i][0] = dot[i][1] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * KP);
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 kf = k4[d4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = warp + NWARPS * i;
        if (r < rows) {
          const float4 qf = reinterpret_cast<const float4*>(Qs + r * HD)[d4];
          float& acc_d = dot[i][d4 & 1];
          acc_d = fmaf(qf.x, kf.x, acc_d);
          acc_d = fmaf(qf.y, kf.y, acc_d);
          acc_d = fmaf(qf.z, kf.z, acc_d);
          acc_d = fmaf(qf.w, kf.w, acc_d);
        }
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (warp + NWARPS * i < rows) {
        const float s = key <= rpos[i] ? (dot[i][0] + dot[i][1]) * scale : TVA_NEG_INF;
        const float m_new = fmaxf(m[i], tva_warp_max(s));
        const float p = __expf(s - m_new);
        const float alpha = __expf(m[i] - m_new);
        l[i] = alpha * l[i] + tva_warp_sum(p);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        ps[i * BK + lane] = p;
      }
    }
    __syncwarp();
    // out[r][d] += sum_j p[r][j] * V[j][d], lane owns d = lane + 32 c
#pragma unroll
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float v[4][NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) v[jj][c] = d < HD ? Vs[(4 * j4 + jj) * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (warp + NWARPS * i < rows) {
          const float4 pf = reinterpret_cast<const float4*>(ps + i * BK)[j4];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c] = fmaf(pf.x, v[0][c], acc[i][c]);
            acc[i][c] = fmaf(pf.y, v[1][c], acc[i][c]);
            acc[i][c] = fmaf(pf.z, v[2][c], acc[i][c]);
            acc[i][c] = fmaf(pf.w, v[3][c], acc[i][c]);
          }
        }
      }
    }
    __syncwarp();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NWARPS * i;
    if (r < rows) {
      const int h = kvh * group + r % group;
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      TQ* orow = o + ((size_t)(b * T + r / group) * nq + h) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) tva_st(orow + d, acc[i][c] * inv);
      }
    }
  }
}

template <int HD, int RW, bool PAGED, typename TQ, typename TC>
int launch(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
           const int* kv_len, const int* qpos, const int* table, int bs, void* o, int B, int T,
           int S, int nq, int nkv, float scale, cudaStream_t stream) {
  using Store = typename Chunk<TC>::Store;
  const int rows = T * (nq / nkv);
  const size_t smem =
      sizeof(float) * (rows * HD + BK * (HD + 4) + BK * HD + NWARPS * RW * BK);
  cudaError_t err = tva_allow_smem(decode_kernel<HD, RW, PAGED, TQ, TC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nkv, B);
  decode_kernel<HD, RW, PAGED, TQ, TC><<<grid, THREADS, smem, stream>>>(
      (const TQ*)q, (const Store*)kc, (const Store*)vc, (const __nv_bfloat16*)ksc,
      (const __nv_bfloat16*)vsc, kv_len, qpos, table, bs, (TQ*)o, T, S, nq, nkv, scale);
  return (int)cudaGetLastError();
}

// rows per warp: the smallest of 1, 2, 4, 8, 16 that covers T * group rows
template <int HD, bool PAGED, typename TQ, typename TC>
int launch_rows(const void* q, const void* kc, const void* vc, const void* ksc,
                const void* vsc, const int* kv_len, const int* qpos, const int* tb, int bs,
                void* o, int B, int T, int S, int nq, int nkv, float scale, cudaStream_t st) {
  const int rw = (T * (nq / nkv) + NWARPS - 1) / NWARPS;
#define TVA_LAUNCH(R)                                                                    \
  return launch<HD, R, PAGED, TQ, TC>(q, kc, vc, ksc, vsc, kv_len, qpos, tb, bs, o, B, T, S, \
                                      nq, nkv, scale, st)
  if (rw <= 1) TVA_LAUNCH(1);
  if (rw <= 2) TVA_LAUNCH(2);
  if (rw <= 4) TVA_LAUNCH(4);
  if (rw <= 8) TVA_LAUNCH(8);
  TVA_LAUNCH(16);
#undef TVA_LAUNCH
}

bool bad_shape(int B, int T, int S, int nq, int nkv) {
  return B <= 0 || T <= 0 || T > MAX_T || S <= 0 || nkv <= 0 || nq % nkv != 0 ||
         nq / nkv > 16;
}

// K2/K3 (PAGED false) and K6/K7 (PAGED true): the stacked cache's or the
// pool's layer plane, always bf16.
template <bool PAGED>
int dispatch(const void* q, const void* kc, const void* vc, const int* kv_len, const int* qpos,
             const int* table, int bs, void* o, int B, int T, int S, int nq, int nkv, int hd,
             float scale, int dtype, void* stream) {
  if (bad_shape(B, T, S, nq, nkv) || bs <= 0 || PAGED != (table != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch_rows<HD, PAGED, float, BF>(
                           q, kc, vc, nullptr, nullptr, kv_len, qpos, table, bs, o, B, T, S, nq,
                           nkv, scale, st));
  }
  if (dtype != TVA_DTYPE_BF16) return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return launch_rows<HD, PAGED, BF, BF>(q, kc, vc, nullptr, nullptr, kv_len,
                                                            qpos, table, bs, o, B, T, S, nq, nkv,
                                                            scale, st));
  return (int)cudaErrorInvalidValue;
}

// K8/K9 (PAGED true) and K10 (PAGED false, T = 1): a quantized cache of
// `bits` 8 (int8) or 4 (packed int4) with its bf16 scale planes, built for
// the engines' head dims 32 (test-tiny), 48 (the distilled checkpoint) and
// 64 (tinyllama-1.1b). ONE_ROW: T * group <= 16 rows, one per warp, so only
// that instantiation is built (K10).
template <bool PAGED, bool ONE_ROW, typename TQ, typename TC>
int dispatch_quant_hd(const void* q, const void* kc, const void* vc, const void* ksc,
                      const void* vsc, const int* kv_len, const int* qpos, const int* table,
                      int bs, void* o, int B, int T, int S, int nq, int nkv, int hd, float scale,
                      cudaStream_t st) {
#define TVA_QUANT_HD(H)                                                                         \
  case H:                                                                                      \
    if constexpr (ONE_ROW)                                                                     \
      return launch<H, 1, PAGED, TQ, TC>(q, kc, vc, ksc, vsc, kv_len, qpos, table, bs, o, B, T, \
                                         S, nq, nkv, scale, st);                               \
    else                                                                                       \
      return launch_rows<H, PAGED, TQ, TC>(q, kc, vc, ksc, vsc, kv_len, qpos, table, bs, o, B,  \
                                           T, S, nq, nkv, scale, st);
  switch (hd) {
    TVA_QUANT_HD(32)
    TVA_QUANT_HD(48)
    TVA_QUANT_HD(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TVA_QUANT_HD
}

template <bool PAGED, bool ONE_ROW>
int dispatch_quant(const void* q, const void* kc, const void* vc, const void* ksc,
                   const void* vsc, const int* kv_len, const int* qpos, const int* table, int bs,
                   void* o, int B, int T, int S, int nq, int nkv, int hd, float scale, int bits,
                   int dtype, void* stream) {
  if (bad_shape(B, T, S, nq, nkv) || bs <= 0 || PAGED != (table != nullptr) ||
      ksc == nullptr || vsc == nullptr || (ONE_ROW && T * (nq / nkv) > NWARPS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
#define TVA_QUANT_CALL(TQ, TC)                                                                 \
  return dispatch_quant_hd<PAGED, ONE_ROW, TQ, TC>(q, kc, vc, ksc, vsc, kv_len, qpos, table, bs, \
                                                   o, B, T, S, nq, nkv, hd, scale, st)
  if (bits == 8 && dtype == TVA_DTYPE_F32) TVA_QUANT_CALL(float, QInt8);
  if (bits == 8 && dtype == TVA_DTYPE_BF16) TVA_QUANT_CALL(BF, QInt8);
  if (bits == 4 && dtype == TVA_DTYPE_F32) TVA_QUANT_CALL(float, QInt4);
  if (bits == 4 && dtype == TVA_DTYPE_BF16) TVA_QUANT_CALL(BF, QInt4);
#undef TVA_QUANT_CALL
  return (int)cudaErrorInvalidValue;
}

}  // namespace
