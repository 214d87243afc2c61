// K3, K12 and K2: T <= 16 query tokens per batch row (K2: one) against a
// dense bf16 KV cache, with the key range split across the card
// (flash-decoding).
//
// Replaces: tpu_voice_agent/ops/decode_attention.py
//   K3 `decode_block_attention_layer` (`_decode_block_kernel`; pallas_call at
//      :542): query i of row b sees slots [0, q_positions[b, i]] of one layer
//      plane of the stacked cache. Positions may be unordered and may repeat
//      (chain_block pads with duplicates), so each query row carries its own
//      frontier. The ff=8 chain blocks (1, 9), the dense verify blocks
//      (1, 5) and the dense batcher's (8, 9).
//   K12 `decode_block_attention` (`_decode_block_kernel` over a flat cache;
//      pallas_call at :458): K3's function on one flat (B, S, nkv, hd) cache,
//      here the same body with the cache's own pointer.
//   K2 `decode_attention_layer` (`_decode_kernel`, stacked=True; pallas_call
//      at :223): one query token per row over one layer plane, keys
//      [0, kv_len[b]); the ff=0 steps, the dense batcher's T = 1 steps and
//      mixtral's decode. The same body at T = 1 (KVLEN): it reads kv_len
//      itself, so the wrapper builds no position array (one launch a layer),
//      and a row's group of at most 16 query rows gives one row per warp.
//
// What bounds it on an H100: bytes. A (1, 9) block at frontier ~950 of
// tinyllama-1.1b reads ~1 MB of K/V (0.3 us at 3.35 TB/s) and does ~70
// MFLOP; K2's T = 1 step reads the same K/V for 8 query rows a kv head.
// One block per (kv head, batch row) leaves 4 blocks on 132 SMs at B = 1,
// each doing its query rows x ~950 keys on one SM's fp32 FMAs; so the keys
// are split across the card.
//
// The design: the grid is (key splits, kv head, batch row). The wrapper
// picks the chunk of keys a split covers from S, B and nkv alone (no device
// read), so that about two blocks per SM exist when every key is live.
// - A block reads its row's positions (its frontier: the largest of them,
//   clamped to S - 1; K2: kv_len - 1). Splits wholly past the frontier
//   return at once.
// - A live block computes, for every T * group query row of its kv head
//   whose frontier reaches its chunk, the partial (m, l, acc[hd]) over the
//   chunk's keys: K/V tiles of 32 keys widened to fp32 in shared memory
//   (the next tile's loads in flight in registers), lane = key for the
//   scores, lane = output dim for P.V, 16 warps each owning rows
//   w + 16 i, all arithmetic in fp32 (P is not rounded), and writes it to
//   fp32 scratch.
// - Then it takes a ticket on its group's int32 counter (groups of 8
//   splits; __threadfence first). The last split of a group to arrive
//   merges the group's partials into one (M = max m_c, L = sum_c
//   e^(m_c - M) l_c, A = sum_c e^(m_c - M) acc_c, over c in order) and
//   takes a ticket on the (batch row, kv head)'s counter; the last group
//   merger merges the groups the same way and writes A / L. With one
//   group, its merger writes the output. The order of every sum is fixed,
//   so the output is the same bits whichever blocks merge and from run to
//   run; outputs take no atomics. Two levels spread the merge's reads over
//   the groups' SMs: one block reading every split's partials took longer
//   than the splits' own work. Each merging block sets back the counter it
//   read, so one launch a call needs no second kernel and no memset.
// The counters are the wrapper's, TICKETS_PER_SLOT per (batch row, kv
// head), and serve launches on one stream at a time. A row with no valid
// key (a negative position; K2: kv_len 0) writes zeros, as `acc / (l or 1)`
// gives.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TILE = 32;  // keys per tile: one per lane
constexpr int NWARPS = 16;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_T = 16;
constexpr int MAX_GROUP = 16;
constexpr int GROUP = 8;  // splits merged by one block, then groups merged by one
// a merge holds at most GROUP entries of an item in registers, so at most
// GROUP groups of GROUP splits
constexpr int MAX_SPLITS = GROUP * GROUP;
constexpr int TICKETS_PER_SLOT = 1 + GROUP;

// 16 loaded bytes -> fp32 in 16-byte-aligned shared memory: 8 bf16 (bf16 ->
// fp32 is the high half of the fp32 bit pattern; each 32-bit word holds two
// bf16, the lower address in the low half) or 4 fp32
template <typename TQ>
__device__ __forceinline__ void widen(const uint4& u, float* dst);
template <>
__device__ __forceinline__ void widen<bf16>(const uint4& u, float* dst) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  d[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                     __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}
template <>
__device__ __forceinline__ void widen<float>(const uint4& u, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                                                __uint_as_float(u.z), __uint_as_float(u.w));
}

// Query row t of batch row b sees keys [0, frontier]; a frontier past the
// cache means every slot (keys >= S are never valid). KVLEN (K2, T = 1):
// `pos` is kv_len (B,), so the frontier is kv_len[b] - 1; otherwise it is
// q_positions (B, T).
template <bool KVLEN>
__device__ __forceinline__ int frontier(const int* __restrict__ pos, int b, int T, int t, int S) {
  return min(KVLEN ? pos[b] - 1 : pos[b * T + t], S - 1);
}

// Scratch of one launch, fp32: acc [B * nkv][entries][rows][HD], then (m, l)
// [B * nkv][entries][rows]; the entries of a (batch row, kv head) are its
// splits, then one per group of GROUP splits.
template <int HD, int RW, typename TQ, bool KVLEN>
__global__ void __launch_bounds__(THREADS)
split_kernel(const TQ* __restrict__ q, const bf16* __restrict__ kc, const bf16* __restrict__ vc,
             const int* __restrict__ qpos, TQ* __restrict__ o, float* __restrict__ part,
             int* __restrict__ tickets, int T, int S, int nq, int nkv, int chunk, float scale) {
  constexpr int KP = HD + 4;          // padded K pitch: float4 rows on distinct banks
  constexpr int NC = (HD + 31) / 32;  // output dims per lane
  constexpr int D4 = HD / 4;
  constexpr int CHUNKS = HD / 8;      // 16-byte chunks (8 bf16) per key row
  constexpr int LOADS = (2 * TILE * CHUNKS + THREADS - 1) / THREADS;
  const int group = nq / nkv;
  const int rows = T * group;
  const int split = blockIdx.x, nsplit = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int slot = b * nkv + kvh;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [rows][HD]
  float* Ks = Qs + rows * HD;  // [TILE][KP]
  float* Vs = Ks + TILE * KP;  // [TILE][HD]
  float* Ps = Vs + TILE * HD;  // [NWARPS][RW][TILE]
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  int max_pos = -1;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t)
    if (t < T) max_pos = max(max_pos, frontier<KVLEN>(qpos, b, T, t, S));
  // splits that hold a key some row sees; split 0 always runs, so that a
  // (row, kv head) whose rows see no key still gets its zeros
  const int live = max(max_pos, 0) / chunk + 1;
  if (split >= live) return;
  const int c0 = split * chunk;
  const int kend = min(c0 + chunk, max_pos + 1);

  // this warp's rows: frontier, running max / sum, accumulator
  int rpos[RW];
  bool active[RW];
  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NWARPS * i;
    const int p = r < rows ? frontier<KVLEN>(qpos, b, T, r / group, S) : -1;
    rpos[i] = p;
    // a row is active in this split when its frontier reaches the chunk
    active[i] = r < rows && p >= c0;
    m[i] = TVA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // K/V tile loads (key s is cache row b * S + s), staged in registers one
  // tile ahead; keys at or past kend load as zeros and are masked
  const size_t row_stride = (size_t)nkv * HD;
  const bf16* kbase = kc + ((size_t)b * S * nkv + kvh) * HD;
  const bf16* vbase = vc + ((size_t)b * S * nkv + kvh) * HD;
  uint4 pre[LOADS];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + THREADS * j;  // chunk id over [K rows | V rows]
      pre[j] = uint4{};
      if (i < 2 * TILE * CHUNKS) {
        const int kv = i / (TILE * CHUNKS), rem = i % (TILE * CHUNKS);
        const int s = k0 + rem / CHUNKS, ch = rem % CHUNKS;
        if (s < kend)
          pre[j] = *reinterpret_cast<const uint4*>((kv ? vbase : kbase) + s * row_stride +
                                                   ch * 8);
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + THREADS * j;
      if (i < 2 * TILE * CHUNKS) {
        const int kv = i / (TILE * CHUNKS), rem = i % (TILE * CHUNKS);
        const int key = rem / CHUNKS, ch = rem % CHUNKS;
        widen<bf16>(pre[j], (kv ? Vs + key * HD : Ks + key * KP) + ch * 8);
      }
    }
  };

  if (c0 < kend) load_tile(c0);
  // the rows' queries, 16 bytes a load, four loads in flight a thread,
  // widened to fp32 (the first tile's loads are in flight meanwhile)
  {
    constexpr int QV = 16 / sizeof(TQ);  // elements per 16-byte load
    constexpr int VPR = HD / QV;         // loads per row
    const int nvec = rows * VPR;
    for (int i0 = 0; i0 < nvec; i0 += 4 * THREADS) {
      uint4 qv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + tid, r = i / VPR;
        if (i < nvec)
          qv[u] = *reinterpret_cast<const uint4*>(
              q + ((size_t)(b * T + r / group) * nq + kvh * group + r % group) * HD +
              (i % VPR) * QV);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < nvec) widen<TQ>(qv[u], Qs + i * QV);
      }
    }
  }
  float* ps = Ps + warp * RW * TILE;
  for (int k0 = c0; k0 < kend; k0 += TILE) {
    __syncthreads();  // every warp is done with the previous tile (and Qs is written)
    store_tile();
    __syncthreads();
    if (k0 + TILE < kend) load_tile(k0 + TILE);  // in flight while this tile computes

    // scores: lane = key k0 + lane, every active row of the warp at once
    float dot[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) dot[i][0] = dot[i][1] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * KP);
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 kf = k4[d4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (active[i]) {
          const float4 qf = reinterpret_cast<const float4*>(Qs + (warp + NWARPS * i) * HD)[d4];
          float& acc_d = dot[i][d4 & 1];
          acc_d = fmaf(qf.x, kf.x, acc_d);
          acc_d = fmaf(qf.y, kf.y, acc_d);
          acc_d = fmaf(qf.z, kf.z, acc_d);
          acc_d = fmaf(qf.w, kf.w, acc_d);
        }
      }
    }
    // the online softmax of every row of the warp at once: each butterfly
    // step runs over all rows, so the rows' shuffle chains overlap (an
    // inactive row computes on -1e30 and is never written)
    const int key = k0 + lane;
    float sc[RW], red[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      sc[i] = active[i] && key <= rpos[i] ? (dot[i][0] + dot[i][1]) * scale : TVA_NEG_INF;
      red[i] = sc[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < RW; ++i) red[i] = fmaxf(red[i], __shfl_xor_sync(0xffffffffu, red[i], o));
    }
    float alpha[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float m_new = fmaxf(m[i], red[i]);
      sc[i] = __expf(sc[i] - m_new);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      red[i] = sc[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < RW; ++i) red[i] += __shfl_xor_sync(0xffffffffu, red[i], o);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (active[i]) {
        l[i] = alpha[i] * l[i] + red[i];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha[i];
        ps[i * TILE + lane] = sc[i];
      }
    }
    __syncwarp();
    // acc[r][d] += sum_j p[r][j] * V[j][d], lane owns d = lane + 32 c
#pragma unroll
    for (int j4 = 0; j4 < TILE / 4; ++j4) {
      float vv[4][NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) vv[jj][c] = d < HD ? Vs[(4 * j4 + jj) * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (active[i]) {
          const float4 pf = reinterpret_cast<const float4*>(ps + i * TILE)[j4];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c] = fmaf(pf.x, vv[0][c], acc[i][c]);
            acc[i][c] = fmaf(pf.y, vv[1][c], acc[i][c]);
            acc[i][c] = fmaf(pf.z, vv[2][c], acc[i][c]);
            acc[i][c] = fmaf(pf.w, vv[3][c], acc[i][c]);
          }
        }
      }
    }
    __syncwarp();  // ps is rewritten by the next tile
  }

  // this split's partials, for the rows active in it. Scratch entries of a
  // (batch row, kv head): its nsplit splits, then one per merge group.
  const int ngroups_max = (nsplit + GROUP - 1) / GROUP;
  const int nent = nsplit + ngroups_max;
  const size_t nslots = (size_t)gridDim.y * gridDim.z;
  float* part_acc = part;
  float2* part_ml = reinterpret_cast<float2*>(part + nslots * nent * rows * HD);
  const size_t base = (size_t)slot * nent * rows;  // (slot, entry 0, row 0)
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NWARPS * i;
    if (active[i]) {
      const size_t at = base + (size_t)split * rows + r;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) part_acc[at * HD + d] = acc[i][c];
      }
      if (lane == 0) part_ml[at] = make_float2(m[i], l[i]);
    }
  }

  // The merge of row r's entries first .. first + n - 1, in that order:
  // M = max m, L = sum e^(m - M) l, A = sum e^(m - M) acc. Every thread
  // takes float4s of outputs (item = row, dims 4 d4 .. 4 d4 + 3) and loads
  // an item's (m, l) and acc of all n entries at once. INTO_GROUP writes
  // (M, L, A) to entry nsplit + g; otherwise the output, A / (L or 1).
  auto merge = [&](int first, int g, bool into_group) {
    for (int item = tid; item < rows * D4; item += THREADS) {
      const int r = item / D4, d4 = item % D4;
      const int p = frontier<KVLEN>(qpos, b, T, r / group, S);
      const int nr = p >= 0 ? p / chunk + 1 : 0;  // splits holding keys row r sees
      const int n = into_group ? min(max(nr - first, 0), GROUP)
                               : (first == nsplit ? (nr + GROUP - 1) / GROUP : nr);
      float2 mlv[GROUP];
      float4 av[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j < n) {
          const size_t at = base + (size_t)(first + j) * rows + r;
          mlv[j] = __ldcg(part_ml + at);
          av[j] = __ldcg(reinterpret_cast<const float4*>(part_acc + at * HD) + d4);
        }
      }
      float M = TVA_NEG_INF, L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (j < n) M = fmaxf(M, mlv[j].x);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j < n) {
          const float e = __expf(mlv[j].x - M);
          L = fmaf(e, mlv[j].y, L);
          A.x = fmaf(e, av[j].x, A.x);
          A.y = fmaf(e, av[j].y, A.y);
          A.z = fmaf(e, av[j].z, A.z);
          A.w = fmaf(e, av[j].w, A.w);
        }
      }
      if (into_group) {
        if (n > 0) {
          const size_t at = base + (size_t)(nsplit + g) * rows + r;
          reinterpret_cast<float4*>(part_acc + at * HD)[d4] = A;
          if (d4 == 0) part_ml[at] = make_float2(M, L);
        }
      } else {
        const float inv = 1.f / (L == 0.f ? 1.f : L);
        TQ* orow = o + ((size_t)(b * T + r / group) * nq + kvh * group + r % group) * HD + 4 * d4;
        tva_st(orow + 0, A.x * inv);
        tva_st(orow + 1, A.y * inv);
        tva_st(orow + 2, A.z * inv);
        tva_st(orow + 3, A.w * inv);
      }
    }
  };

  // Tickets of this (batch row, kv head): [0] groups merged, [1 + g] splits
  // of group g done. The last split of a group to arrive merges the group;
  // the last group merger merges the groups. Each resets what it counted.
  int* tk = tickets + (size_t)slot * TICKETS_PER_SLOT;
  const int g = split / GROUP;
  const int ngroups = (live + GROUP - 1) / GROUP;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tk + 1 + g, 1) == min(GROUP, live - g * GROUP) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ngroups == 1) {  // one group: its merger writes the output
    merge(0, 0, false);
    if (tid == 0) tk[1] = 0;
    return;
  }
  merge(g * GROUP, g, true);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tk[1 + g] = 0;
    last = atomicAdd(tk, 1) == ngroups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge(nsplit, 0, false);
  if (tid == 0) tk[0] = 0;
}

template <int HD, int RW, typename TQ, bool KVLEN>
int launch(const void* q, const void* kc, const void* vc, const int* qpos, void* o, float* part,
           int* tickets, int B, int T, int S, int nq, int nkv, int chunk, float scale,
           cudaStream_t stream) {
  const int rows = T * (nq / nkv);
  const int nsplit = (S + chunk - 1) / chunk;
  const size_t smem =
      sizeof(float) * (rows * HD + TILE * (HD + 4) + TILE * HD + NWARPS * RW * TILE);
  cudaError_t err = tva_allow_smem(split_kernel<HD, RW, TQ, KVLEN>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nsplit, nkv, B);
  split_kernel<HD, RW, TQ, KVLEN><<<grid, THREADS, smem, stream>>>(
      (const TQ*)q, (const bf16*)kc, (const bf16*)vc, qpos, (TQ*)o, part, tickets, T, S, nq, nkv,
      chunk, scale);
  return (int)cudaGetLastError();
}

// rows per warp: the smallest of 1, 2, 3, 5, 8, 16 that covers T * group
// rows (5: the (1, 9) and (8, 9) blocks' 72 rows at tinyllama's group of 8).
// KVLEN (K2): T = 1 and a group of at most 16, so one row per warp.
template <int HD, typename TQ, bool KVLEN>
int launch_rows(const void* q, const void* kc, const void* vc, const int* qpos, void* o,
                float* part, int* tickets, int B, int T, int S, int nq, int nkv, int chunk,
                float scale, cudaStream_t st) {
#define TVA_LAUNCH(R)                                                                          \
  return launch<HD, R, TQ, KVLEN>(q, kc, vc, qpos, o, part, tickets, B, T, S, nq, nkv, chunk, \
                                  scale, st)
  if constexpr (KVLEN) {
    TVA_LAUNCH(1);
  } else {
    const int rw = (T * (nq / nkv) + NWARPS - 1) / NWARPS;
    if (rw <= 1) TVA_LAUNCH(1);
    if (rw <= 2) TVA_LAUNCH(2);
    if (rw <= 3) TVA_LAUNCH(3);
    if (rw <= 5) TVA_LAUNCH(5);
    if (rw <= 8) TVA_LAUNCH(8);
    TVA_LAUNCH(16);
  }
#undef TVA_LAUNCH
}

template <bool KVLEN>
int dispatch(const void* q, const void* kc, const void* vc, const int* qpos, void* o, void* part,
             void* tickets, int B, int T, int S, int nq, int nkv, int hd, int chunk, float scale,
             int dtype, void* stream) {
  if (B <= 0 || T <= 0 || T > MAX_T || (KVLEN && T != 1) || S <= 0 || nkv <= 0 ||
      nq % nkv != 0 || nq / nkv > MAX_GROUP || chunk <= 0 || chunk % TILE != 0 ||
      (S + chunk - 1) / chunk > MAX_SPLITS || part == nullptr || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* pp = (float*)part;
  int* tk = (int*)tickets;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch_rows<HD, float, KVLEN>(q, kc, vc, qpos, o, pp, tk, B, T, S,
                                                             nq, nkv, chunk, scale, st));
  }
  if (dtype != TVA_DTYPE_BF16) return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return launch_rows<HD, bf16, KVLEN>(q, kc, vc, qpos, o, pp, tk, B, T, S, nq,
                                                          nkv, chunk, scale, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: q (B,T,nq,hd) bf16 or fp32 (TVA_DTYPE_*), k/v plane (B,S,nkv,hd) bf16 of
// the layer, q_positions (B,T) int32; o like q. `chunk`: keys a split
// covers, a multiple of 32, at most 64 splits. `part`: fp32 scratch of
// B * nkv * (splits + ceil(splits / 8)) * T * (nq / nkv) * (hd + 2) floats;
// `tickets`: B * nkv * 9 int32 counters, all 0 (the launch leaves them 0).
extern "C" int tva_decode_block_attention_layer(const void* q, const void* kc, const void* vc,
                                                const int* q_positions, void* o, void* part,
                                                void* tickets, int B, int T, int S, int nq,
                                                int nkv, int hd, int chunk, float scale,
                                                int dtype, void* stream) {
  return dispatch<false>(q, kc, vc, q_positions, o, part, tickets, B, T, S, nq, nkv, hd, chunk,
                         scale, dtype, stream);
}

// K12: the same over a flat k/v cache (B,S,nkv,hd) bf16.
extern "C" int tva_decode_block_attention(const void* q, const void* kc, const void* vc,
                                          const int* q_positions, void* o, void* part,
                                          void* tickets, int B, int T, int S, int nq, int nkv,
                                          int hd, int chunk, float scale, int dtype,
                                          void* stream) {
  return dispatch<false>(q, kc, vc, q_positions, o, part, tickets, B, T, S, nq, nkv, hd, chunk,
                         scale, dtype, stream);
}

// K2: q (B,nq,hd) bf16 or fp32, k/v plane (B,S,nkv,hd) bf16 of the layer,
// kv_len (B,) int32 (query b sees keys [0, kv_len[b])); o like q. `chunk`,
// `part` and `tickets` as K3's at T = 1.
extern "C" int tva_decode_attention_layer(const void* q, const void* kc, const void* vc,
                                          const int* kv_len, void* o, void* part, void* tickets,
                                          int B, int S, int nq, int nkv, int hd, int chunk,
                                          float scale, int dtype, void* stream) {
  return dispatch<true>(q, kc, vc, kv_len, o, part, tickets, B, 1, S, nq, nkv, hd, chunk, scale,
                        dtype, stream);
}
