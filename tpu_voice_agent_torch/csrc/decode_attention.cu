// K2, K3 and K5: decode attention against a KV cache; q/o bf16 or fp32 (TQ),
// the cache bf16 or fp32 (TC), arithmetic in fp32.
//
// Replaces: tpu_voice_agent/ops/decode_attention.py
//   K5 `decode_attention` (`_decode_kernel`, stacked=False; pallas_call at
//      :133): one query token per row over a flat (B, S, nkv, hd) cache, keys
//      [0, kv_len[b]). The Whisper decoder's self-attention (kv_len =
//      frontier + 1) and cross-attention (kv_len = encoder frames) on every
//      T = 1 step.
//   K2 `decode_attention_layer` (`_decode_kernel`, stacked=True; pallas_call
//      at :223): the same on one layer plane of the stacked cache.
//   K3 `decode_block_attention_layer` (`_decode_block_kernel`; pallas_call at
//      :542): T <= 16 queries per row, query i sees slots [0, q_positions[b,i]].
//      Positions may be unordered and may repeat (chain_block pads with
//      duplicates), so each query row carries its own frontier and the tile
//      loop runs to the block's true maximum.
// The JAX package serves K5 and K2 from one kernel body (`stacked=`); here
// one template body serves all three. The TPU picked K2/K3's layer plane by a
// scalar-prefetched index; in eager PyTorch the wrapper passes the plane's own
// pointer (`cache[layer]` is a free contiguous view), so nothing is copied.
// K5 needs no padding of S to a tile multiple: the loop stops at kv_len, keys
// past S load as zeros and are masked, and a row with kv_len 0 writes zeros
// (the TPU kernel's `acc / (l or 1)`).
//
// What bounds it on an H100: at B = 1 the grid is one block per (kv head,
// batch row), 4 blocks on 132 SMs at tinyllama-1.1b and 20 at Whisper
// large-v3 (MHA), so neither the card's memory rate nor its FLOP rate is
// reachable; each block is bound by its own SM's fp32 FMA rate and by load
// latency. A row at context n reads 2 * n * hd * sizeof(TC) bytes of K/V per
// kv head (~0.24 MB at n = 950, hd 64, bf16) and the fast-forward block
// (T = 9, group 8: 72 query rows) does 72 * n * hd * 2 FMAs on it (~8.8 M,
// ~38 us of one SM's 128 fp32 lanes). Whisper's group of 1 leaves one query
// row per block: one warp computes while all 16 stage tiles.
// Its design: the `group * T` query rows of one kv head share every K/V tile,
// which is read once from device memory into shared memory (fp32, 32 keys per
// tile); the next tile's loads are issued into registers before the current
// tile is computed; 16 warps each own a fixed set of query rows (row
// w + 16 i), keep their running max, sum and output accumulator in
// registers, and read shared memory as float4 so one K load feeds every row
// of the warp. Each block stops at its own row's frontier. Splitting the key
// range across blocks (flash-decoding) and tensor-core products are later
// work.
#include "common.cuh"

namespace {

constexpr int BK = 32;  // keys per tile: one per lane
constexpr int NWARPS = 16;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_T = 16;

// One 16-byte load of a cache row (8 bf16 or 4 fp32 values), widened to fp32
// into 16-byte-aligned shared memory.
template <typename TC>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> fp32 is the high half of the fp32 bit pattern; each 32-bit word
  // holds two bf16, the lower address in the low half
  __device__ static void widen(const uint4& u, float* dst) {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    d[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                       __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
  }
};
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& u, float* dst) {
    *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                                                  __uint_as_float(u.z), __uint_as_float(u.w));
  }
};

// The (T * group) query rows of one (kv head, batch row); row r is query
// r / group of q head kvh * group + r % group. Warp w owns rows w + 16 i for
// i < RW.
template <int HD, int RW, typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
              const TC* __restrict__ vc, const int* __restrict__ kv_len,
              const int* __restrict__ qpos, TQ* __restrict__ o, int T, int S, int nq,
              int nkv, float scale) {
  constexpr int KP = HD + 4;          // padded K pitch: float4 rows on distinct banks
  constexpr int NC = (HD + 31) / 32;  // output dims per lane
  constexpr int D4 = HD / 4;
  constexpr int EPC = Chunk<TC>::N;   // cache values per 16-byte chunk
  constexpr int CHUNKS = HD / EPC;    // chunks per key row
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

  // K/V tile loads, staged in registers one tile ahead
  const size_t row_stride = (size_t)nkv * HD;
  const TC* kbase = kc + ((size_t)b * S * nkv + kvh) * HD;
  const TC* vbase = vc + ((size_t)b * S * nkv + kvh) * HD;
  uint4 pre[LOADS];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + THREADS * j;  // chunk id over [K rows | V rows]
      pre[j] = make_uint4(0, 0, 0, 0);
      if (i < 2 * BK * CHUNKS) {
        const int kv = i / (BK * CHUNKS), rem = i % (BK * CHUNKS);
        const int s = k0 + rem / CHUNKS, ch = rem % CHUNKS;
        if (s < S)
          pre[j] = *reinterpret_cast<const uint4*>((kv ? vbase : kbase) + s * row_stride +
                                                   ch * EPC);
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
        Chunk<TC>::widen(pre[j], kv ? Vs + key * HD + ch * EPC : Ks + key * KP + ch * EPC);
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
int launch(const void* q, const void* kc, const void* vc, const int* kv_len, const int* qpos,
           void* o, int B, int T, int S, int nq, int nkv, float scale, cudaStream_t stream) {
  const int rows = T * (nq / nkv);
  const size_t smem =
      sizeof(float) * (rows * HD + BK * (HD + 4) + BK * HD + NWARPS * RW * BK);
  cudaError_t err = tva_allow_smem(decode_kernel<HD, RW, TQ, TC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nkv, B);
  decode_kernel<HD, RW, TQ, TC><<<grid, THREADS, smem, stream>>>(
      (const TQ*)q, (const TC*)kc, (const TC*)vc, kv_len, qpos, (TQ*)o, T, S, nq, nkv, scale);
  return (int)cudaGetLastError();
}

// rows per warp: the smallest of 1, 2, 4, 8, 16 that covers T * group rows
template <int HD, typename TQ>
int launch_rows(const void* q, const void* kc, const void* vc, const int* kv_len,
                const int* qpos, void* o, int B, int T, int S, int nq, int nkv, float scale,
                cudaStream_t st) {
  using BF = __nv_bfloat16;
  const int rw = (T * (nq / nkv) + NWARPS - 1) / NWARPS;
  if (rw <= 1) return launch<HD, 1, TQ, BF>(q, kc, vc, kv_len, qpos, o, B, T, S, nq, nkv, scale, st);
  if (rw <= 2) return launch<HD, 2, TQ, BF>(q, kc, vc, kv_len, qpos, o, B, T, S, nq, nkv, scale, st);
  if (rw <= 4) return launch<HD, 4, TQ, BF>(q, kc, vc, kv_len, qpos, o, B, T, S, nq, nkv, scale, st);
  if (rw <= 8) return launch<HD, 8, TQ, BF>(q, kc, vc, kv_len, qpos, o, B, T, S, nq, nkv, scale, st);
  return launch<HD, 16, TQ, BF>(q, kc, vc, kv_len, qpos, o, B, T, S, nq, nkv, scale, st);
}

bool bad_shape(int B, int T, int S, int nq, int nkv) {
  return B <= 0 || T <= 0 || T > MAX_T || S <= 0 || nkv <= 0 || nq % nkv != 0 ||
         nq / nkv > 16;
}

// K2/K3: the stacked cache's layer plane, always bf16.
int dispatch(const void* q, const void* kc, const void* vc, const int* kv_len, const int* qpos,
             void* o, int B, int T, int S, int nq, int nkv, int hd, float scale, int dtype,
             void* stream) {
  if (bad_shape(B, T, S, nq, nkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch_rows<HD, float>(q, kc, vc, kv_len, qpos, o, B, T, S, nq,
                                                      nkv, scale, st));
  }
  if (dtype != TVA_DTYPE_BF16) return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return launch_rows<HD, __nv_bfloat16>(q, kc, vc, kv_len, qpos, o, B, T, S,
                                                            nq, nkv, scale, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K5: q (B,nq,hd), flat k/v cache (B,S,nkv,hd), kv_len (B,) int32; q, the
// cache and o all of one dtype (TVA_DTYPE_*). T = 1 and a group of at most
// 16 leave one query row per warp at most (RW = 1).
extern "C" int tva_decode_attention(const void* q, const void* kc, const void* vc,
                                    const int* kv_len, void* o, int B, int S, int nq, int nkv,
                                    int hd, float scale, int dtype, void* stream) {
  if (bad_shape(B, 1, S, nq, nkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch<HD, 1, float, float>(q, kc, vc, kv_len, nullptr, o, B, 1,
                                                           S, nq, nkv, scale, st));
  }
  if (dtype == TVA_DTYPE_BF16) {
    TVA_DISPATCH_HD(hd, return launch<HD, 1, BF, BF>(q, kc, vc, kv_len, nullptr, o, B, 1, S, nq,
                                                     nkv, scale, st));
  }
  return (int)cudaErrorInvalidValue;
}

// K2: q (B,nq,hd), k/v plane (B,S,nkv,hd) of the layer, kv_len (B,) int32;
// q and o of one dtype (TVA_DTYPE_*).
extern "C" int tva_decode_attention_layer(const void* q, const void* kc, const void* vc,
                                          const int* kv_len, void* o, int B, int S, int nq,
                                          int nkv, int hd, float scale, int dtype, void* stream) {
  return dispatch(q, kc, vc, kv_len, nullptr, o, B, 1, S, nq, nkv, hd, scale, dtype, stream);
}

// K3: q (B,T,nq,hd), k/v plane (B,S,nkv,hd) of the layer, q_positions (B,T) int32.
extern "C" int tva_decode_block_attention_layer(const void* q, const void* kc, const void* vc,
                                                const int* q_positions, void* o, int B, int T,
                                                int S, int nq, int nkv, int hd, float scale,
                                                int dtype, void* stream) {
  return dispatch(q, kc, vc, nullptr, q_positions, o, B, T, S, nq, nkv, hd, scale, dtype,
                  stream);
}
