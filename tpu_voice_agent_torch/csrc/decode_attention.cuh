// The paged decode-attention fp32 body: the fp32-query launches of K6, K7
// (paged_attention.cu), K8 and K9 (paged_attention_quant.cu), the distilled
// checkpoint's golden phases. T <= 16 query tokens per batch row against a
// paged KV pool read through block tables; q/o fp32, the pool bf16 or
// quantized (TC: QInt8, QInt4, the loaders of kv_chunk.cuh), arithmetic in
// fp32. Each source instantiates only its own part, so they compile in
// parallel. bf16 queries run the tensor-core split body of paged_split.cuh;
// the dense caches' kernels (K2, K3, K5, K10, K12) the split-key body of
// decode_split.cuh.
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
// `acc / (l or 1)`). The tile loader resolves each key row s through the
// row's block table (pool row table[b, s / bs] * bs + s % bs of the layer
// plane), so any block size works and a 32-key tile may straddle two pool
// blocks. A quantized pool is widened by the same loader: it reads the int8
// chunk (or the packed int4 chunk) and the key row's bf16 scale from the
// layer's scale plane, at the pool row * nkv + kvh. The TPU kernels fold the
// scales into the score and probability tiles instead, `(q . k_int) * ks`,
// which differs from this only by fp32 summation order.
#pragma once

#include "kv_chunk.cuh"

namespace {

constexpr int BK = 32;  // keys per tile: one per lane
constexpr int NWARPS = 16;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_T = 16;

// The (T * group) query rows of one (kv head, batch row); row r is query
// r / group of q head kvh * group + r % group. Warp w owns rows w + 16 i for
// i < RW. Keys are read through the row's block table. ksc/vsc: the scale
// planes of a quantized pool (null otherwise), one bf16 per (pool row, kv
// head).
template <int HD, int RW, typename TQ, typename TC>
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
  // pool row table[b, s / bs] * bs + s % bs of the layer plane; a quantized
  // row's scale is at that row * nkv + kvh of the scale plane.
  const size_t row_stride = (size_t)nkv * HDP;
  const Store* kbase = kc + (size_t)kvh * HDP;
  const Store* vbase = vc + (size_t)kvh * HDP;
  const __nv_bfloat16* ksbase = CK::QUANT ? ksc + kvh : nullptr;
  const __nv_bfloat16* vsbase = CK::QUANT ? vsc + kvh : nullptr;
  const int* trow = table + (size_t)b * (S / bs);
  auto key_row = [&](int s) -> size_t { return (size_t)trow[s / bs] * bs + s % bs; };
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

template <int HD, int RW, typename TQ, typename TC>
int launch(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
           const int* kv_len, const int* qpos, const int* table, int bs, void* o, int B, int T,
           int S, int nq, int nkv, float scale, cudaStream_t stream) {
  using Store = typename Chunk<TC>::Store;
  const int rows = T * (nq / nkv);
  const size_t smem =
      sizeof(float) * (rows * HD + BK * (HD + 4) + BK * HD + NWARPS * RW * BK);
  cudaError_t err = tva_allow_smem(decode_kernel<HD, RW, TQ, TC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nkv, B);
  decode_kernel<HD, RW, TQ, TC><<<grid, THREADS, smem, stream>>>(
      (const TQ*)q, (const Store*)kc, (const Store*)vc, (const __nv_bfloat16*)ksc,
      (const __nv_bfloat16*)vsc, kv_len, qpos, table, bs, (TQ*)o, T, S, nq, nkv, scale);
  return (int)cudaGetLastError();
}

// rows per warp: the smallest of 1, 2, 4, 8, 16 that covers T * group rows
template <int HD, typename TQ, typename TC>
int launch_rows(const void* q, const void* kc, const void* vc, const void* ksc,
                const void* vsc, const int* kv_len, const int* qpos, const int* tb, int bs,
                void* o, int B, int T, int S, int nq, int nkv, float scale, cudaStream_t st) {
  const int rw = (T * (nq / nkv) + NWARPS - 1) / NWARPS;
#define TVA_LAUNCH(R)                                                                           \
  return launch<HD, R, TQ, TC>(q, kc, vc, ksc, vsc, kv_len, qpos, tb, bs, o, B, T, S, nq, nkv, \
                               scale, st)
  if (rw <= 1) TVA_LAUNCH(1);
  if (rw <= 2) TVA_LAUNCH(2);
  if (rw <= 4) TVA_LAUNCH(4);
  if (rw <= 8) TVA_LAUNCH(8);
  TVA_LAUNCH(16);
#undef TVA_LAUNCH
}

bool bad_shape(int B, int T, int S, int nq, int nkv, int bs, const int* table) {
  return B <= 0 || T <= 0 || T > MAX_T || S <= 0 || nkv <= 0 || nq % nkv != 0 ||
         nq / nkv > 16 || bs <= 0 || table == nullptr;
}

// K6/K7 with fp32 queries: the pool's layer plane, always bf16. A template
// (as dispatch_quant_hd), so that only a source that calls it instantiates
// its kernels: every paged source includes this header, and a plain
// function's body would build them in each.
template <int = 0>
int dispatch(const void* q, const void* kc, const void* vc, const int* kv_len, const int* qpos,
             const int* table, int bs, void* o, int B, int T, int S, int nq, int nkv, int hd,
             float scale, void* stream) {
  if (bad_shape(B, T, S, nq, nkv, bs, table)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  TVA_DISPATCH_HD(hd, return launch_rows<HD, float, __nv_bfloat16>(
                             q, kc, vc, nullptr, nullptr, kv_len, qpos, table, bs, o, B, T, S, nq,
                             nkv, scale, st));
  return (int)cudaErrorInvalidValue;
}

// K8/K9 with fp32 queries (paged_quant.cuh): a quantized pool of width TC,
// QInt8 (int8) or QInt4 (packed int4), with its bf16 scale planes, checked by
// the caller (bad_shape, the scale planes set), built for the head dims 32
// (test-tiny), 48 (the distilled checkpoint), 64 (tinyllama-1.1b) and 128
// (llama3-8b, llama3-70b, mixtral-8x7b).
template <typename TC>
int dispatch_quant_hd(const void* q, const void* kc, const void* vc, const void* ksc,
                      const void* vsc, const int* kv_len, const int* qpos, const int* table,
                      int bs, void* o, int B, int T, int S, int nq, int nkv, int hd, float scale,
                      cudaStream_t st) {
#define TVA_QUANT_HD(H)                                                                       \
  case H:                                                                                    \
    return launch_rows<H, float, TC>(q, kc, vc, ksc, vsc, kv_len, qpos, table, bs, o, B, T, \
                                     S, nq, nkv, scale, st);
  switch (hd) {
    TVA_QUANT_HD(32)
    TVA_QUANT_HD(48)
    TVA_QUANT_HD(64)
    TVA_QUANT_HD(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TVA_QUANT_HD
}

}  // namespace
