// The split-key decode-attention template body (flash-decoding) shared by
// K2, K3, K12 (decode_block_attention.cu), K5 (decode_attention.cu) and K10
// (decode_attention_quant.cu): T <= 16 query tokens per batch row against a
// dense (B, S, nkv, hd) KV cache, the key range split across the card. q/o
// bf16 or fp32 (TQ); the cache bf16, fp32 or quantized (TC: the loaders of
// kv_chunk.cuh, with the quantized tiers' bf16 scale planes (B, S, nkv));
// arithmetic in fp32. Each source instantiates only its own part, so they
// compile in parallel.
//
// The design: the grid is (key splits, kv head, batch row). The wrapper
// picks the chunk of keys a split covers from S, B and nkv alone (no device
// read, `key_chunk` in ops/decode_attention.py), so that about two blocks
// per SM exist when every key is live.
// - A block reads its row's positions (its frontier: the largest of them,
//   clamped to S - 1; KVLEN: kv_len - 1). Splits wholly past the frontier
//   return at once.
// - A live block computes, for every T * group query row of its kv head
//   whose frontier reaches its chunk, the partial (m, l, acc[hd]) over the
//   chunk's keys: K/V tiles of 32 keys widened to fp32 in shared memory
//   (the next step's loads in flight in registers), lane = key for the
//   scores, lane = output dim for P.V, all arithmetic in fp32 (P is not
//   rounded).
// - KS = 1: 16 warps each own rows w + 16 i and walk the chunk's tiles one
//   at a time. KS > 1 (warps on keys, for at most 2 rows, as Whisper's
//   group of 1 has): a block of 8 warps in KS sets of 8 / KS; each set owns
//   every row (warp w + (8 / KS) i of the set) and takes every KS-th tile of
//   the chunk with its own (m, l, acc); a step stages KS tiles at once. The
//   sets' partials then merge in shared memory, in set order. Split 0,
//   which always runs, issues its first step's loads before it reads the
//   frontier.
// - KS > 1: a block whose (batch row, kv head) has one live split (a short
//   context) writes the output itself. Otherwise a block writes its partial to
//   fp32 scratch and the two-level, fixed-order ticket merge of
//   split_merge.cuh (shared with the paged body, paged_split.cuh) merges the
//   splits: the output is the same bits from run to run, with no atomics on
//   it. Two levels spread the merge's reads over the groups' SMs: one block
//   reading every split's partials took longer than the splits' own work.
// The counters are the wrapper's, TICKETS_PER_SLOT per (batch row, kv
// head), and serve launches on one stream at a time, as does the scratch. A
// row with no valid key (a negative position; KVLEN: kv_len 0) writes zeros,
// as `acc / (l or 1)` gives.
#pragma once

#include "kv_chunk.cuh"
#include "split_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TILE = 32;  // keys per tile: one per lane
constexpr int NWARPS = 16;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_T = 16;
constexpr int MAX_GROUP = 16;
// The warps-on-keys instantiation: 4 sets of 2 warps (so at most 2 rows) in
// a block of 8 warps, two blocks an SM at 128 registers a thread (a
// 16-warp block fits once: the cross-attention's 160 blocks ran in two
// waves; capped at 64 registers it spilled). Four fp32 K/V tiles of hd 64
// take ~68 KB of shared memory.
constexpr int KEY_SETS = 4;
constexpr int KEY_SET_WARPS = 8;
constexpr int KEY_SETS_MAX_HD = 64;

// Scratch of one launch, fp32: acc [B * nkv][entries][rows][HD], then (m, l)
// [B * nkv][entries][rows]; the entries of a (batch row, kv head) are its
// splits, then one per group of GROUP splits. ksc / vsc: the scale planes of
// a quantized cache (null otherwise), one bf16 per (cache row, kv head).
// The body of both kernels below. KS = 1 is K2 / K3 / K12's body as it was
// before K5 and K10 joined it: the same arithmetic, and within a percent of
// its time on the card.
template <int HD, int RW, int KS, typename TQ, typename TC, bool KVLEN>
__device__ __forceinline__ void split_body(
    const TQ* __restrict__ q, const typename Chunk<TC>::Store* __restrict__ kc,
    const typename Chunk<TC>::Store* __restrict__ vc, const bf16* __restrict__ ksc,
    const bf16* __restrict__ vsc, const int* __restrict__ qpos, TQ* __restrict__ o,
    float* __restrict__ part, int* __restrict__ tickets, int T, int S, int nq, int nkv, int chunk,
    float scale) {
  constexpr int KP = HD + 4;          // padded K pitch: float4 rows on distinct banks
  constexpr int NC = (HD + 31) / 32;  // output dims per lane
  constexpr int D4 = HD / 4;
  using CK = Chunk<TC>;
  using Raw = typename CK::Raw;
  constexpr int HDP = HD / CK::PACK;  // stored elements per head row
  constexpr int CHUNKS = HDP / CK::N;  // vector loads per key row
  static_assert(HDP % CK::N == 0, "a head's cache row must split into whole chunks");
  constexpr int NW = KS > 1 ? KEY_SET_WARPS : NWARPS;  // warps of the block
  constexpr int TH = NW * 32;
  constexpr int TILE_CHUNKS = TILE * CHUNKS;
  constexpr int STEP_CHUNKS = KS * 2 * TILE_CHUNKS;  // [set][K | V][key][chunk]
  constexpr int LOADS = (STEP_CHUNKS + TH - 1) / TH;
  constexpr int WPS = NW / KS;  // warps per key set
  static_assert(KS == 1 || RW == 1, "the warps-on-keys body runs one row a warp");
  const int group = nq / nkv;
  const int rows = T * group;
  const int split = blockIdx.x, nsplit = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int slot = b * nkv + kvh;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [rows][HD]
  float* Ks = Qs + rows * HD;       // [KS][TILE][KP]
  float* Vs = Ks + KS * TILE * KP;  // [KS][TILE][HD]
  float* Ps = Vs + KS * TILE * HD;  // [NW][RW][TILE]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int set = KS > 1 ? warp / WPS : 0, wrow = KS > 1 ? warp % WPS : warp;

  // K/V loads of a step (KS tiles; key s is cache row b * S + s, its scale
  // at that row * nkv + kvh of a scale plane), staged in registers one step
  // ahead; keys at or past kb load as zeros and are masked. The base
  // pointers are formed where the loads are (KS = 1: after the frontier
  // read), so they are not held across it.
  Raw pre[LOADS];
  float pre_s[LOADS];  // the chunk's row scale (quantized caches only)
  auto load_step = [&](int k0, int kb) {
    const size_t row_stride = (size_t)nkv * HDP;
    const size_t row0 = (size_t)b * S * nkv + kvh;
    const typename CK::Store* kbase = kc + row0 * HDP;
    const typename CK::Store* vbase = vc + row0 * HDP;
    const bf16* ksbase = CK::QUANT ? ksc + row0 : nullptr;
    const bf16* vsbase = CK::QUANT ? vsc + row0 : nullptr;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + TH * j;
      pre[j] = Raw{};
      pre_s[j] = 0.f;
      if (i < STEP_CHUNKS) {
        const int ks = KS > 1 ? i / (2 * TILE_CHUNKS) : 0;
        const int rem = KS > 1 ? i % (2 * TILE_CHUNKS) : i;
        const int kv = rem / TILE_CHUNKS, kr = rem % TILE_CHUNKS;
        const int s = k0 + ks * TILE + kr / CHUNKS, ch = kr % CHUNKS;
        if (s < kb) {
          pre[j] = *reinterpret_cast<const Raw*>((kv ? vbase : kbase) + s * row_stride +
                                                 ch * CK::N);
          if constexpr (CK::QUANT)
            pre_s[j] = __bfloat162float((kv ? vsbase : ksbase)[(size_t)s * nkv]);
        }
      }
    }
  };
  // KS > 1 stages only the tiles that hold a key below kend (no set reads
  // the others) and writes zeros for the keys at or past it, which an early
  // load may have read
  auto store_step = [&](int k0, int kend) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + TH * j;
      if (i < STEP_CHUNKS) {
        const int ks = KS > 1 ? i / (2 * TILE_CHUNKS) : 0;
        const int rem = KS > 1 ? i % (2 * TILE_CHUNKS) : i;
        const int kv = rem / TILE_CHUNKS, kr = rem % TILE_CHUNKS;
        const int key = ks * TILE + kr / CHUNKS, ch = kr % CHUNKS;
        if (KS > 1 && k0 + ks * TILE >= kend) continue;
        const bool valid = KS == 1 || k0 + key < kend;
        CK::template widen<HD>(valid ? pre[j] : Raw{}, valid ? pre_s[j] : 0.f,
                               kv ? Vs + key * HD : Ks + key * KP, ch);
      }
    }
  };
  // the rows' queries, 16 bytes a load, four loads in flight a thread,
  // widened to fp32 (the first step's loads are in flight meanwhile)
  auto load_q = [&]() {
    constexpr int QV = 16 / sizeof(TQ);  // elements per 16-byte load
    constexpr int VPR = HD / QV;         // loads per row
    const int nvec = rows * VPR;
    for (int i0 = 0; i0 < nvec; i0 += 4 * TH) {
      uint4 qv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * TH + tid, r = i / VPR;
        if (i < nvec)
          qv[u] = *reinterpret_cast<const uint4*>(
              q + ((size_t)(b * T + r / group) * nq + kvh * group + r % group) * HD +
              (i % VPR) * QV);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * TH + tid;
        if (i < nvec) Chunk<TQ>::template widen<HD>(qv[u], 0.f, Qs + i * QV, 0);
      }
    }
  };

  // KS > 1: split 0, which always runs, issues its first step's loads (up to
  // the chunk's end) and its queries' before it reads the frontier, so the
  // two reads overlap; the rows of the self- and incremental attention's
  // short contexts have no other live split
  const bool early = KS > 1 && split == 0;
  if (early) {
    load_step(0, min(chunk, S));
    load_q();
  }
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
  const int s0 = c0 + set * TILE;  // this set's first key

  // this warp's rows: frontier, running max / sum, accumulator. A row is
  // active in this set when its frontier reaches the set's first key, so
  // its first tile holds a valid key.
  int rpos[RW];
  bool active[RW];
  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = wrow + WPS * i;
    const int p = r < rows ? frontier<KVLEN>(qpos, b, T, r / group, S) : -1;
    rpos[i] = p;
    active[i] = r < rows && p >= s0 && (KS == 1 || s0 < kend);
    m[i] = TVA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  if (!early) {
    if (c0 < kend) load_step(c0, kend);
    load_q();
  }
  float* ps = Ps + warp * RW * TILE;
  const float* Kt = Ks + set * TILE * KP;  // this set's tile of a step
  const float* Vt = Vs + set * TILE * HD;
  for (int k0 = c0; k0 < kend; k0 += KS * TILE) {
    __syncthreads();  // every warp is done with the previous step (and Qs is written)
    store_step(k0, kend);
    __syncthreads();
    if (k0 + KS * TILE < kend) load_step(k0 + KS * TILE, kend);  // in flight while this step computes
    // KS > 1: a set past the chunk's last tile, and a warp that owns no row,
    // wait for the next step
    if (KS > 1 && (k0 + set * TILE >= kend || wrow >= rows)) continue;

    // scores: lane = key k0 + set * TILE + lane, every active row of the warp at once
    float dot[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) dot[i][0] = dot[i][1] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Kt + lane * KP);
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 kf = k4[d4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (active[i]) {
          const float4 qf = reinterpret_cast<const float4*>(Qs + (wrow + WPS * i) * HD)[d4];
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
    const int key = k0 + set * TILE + lane;
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
        for (int jj = 0; jj < 4; ++jj) vv[jj][c] = d < HD ? Vt[(4 * j4 + jj) * HD + d] : 0.f;
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

  // Scratch entries of a (batch row, kv head): its nsplit splits, then one
  // per merge group.
  const int ngroups_max = (nsplit + GROUP - 1) / GROUP;
  const int nent = nsplit + ngroups_max;
  const size_t nslots = (size_t)gridDim.y * gridDim.z;
  float* part_acc = part;
  float2* part_ml = reinterpret_cast<float2*>(part + nslots * nent * rows * HD);
  const size_t base = (size_t)slot * nent * rows;  // (slot, entry 0, row 0)
  auto out_row = [&](int r) {
    return o + ((size_t)(b * T + r / group) * nq + kvh * group + r % group) * HD;
  };

  if constexpr (KS == 1) {
    // this split's partials, for the rows active in it
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + NW * i;
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
  } else {
    // the sets' partials, merged in shared memory in set order (the global
    // merge's arithmetic): this split's partial, or with one live split (a
    // short context's rows) the output, with no scratch and no ticket
    __syncthreads();  // every set is done with its tiles
    float* Ma = Ks;   // [KS][rows][HD], then (m, l) [KS][rows]
    float2* Mml = reinterpret_cast<float2*>(Ma + KS * rows * HD);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = wrow + WPS * i;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) Ma[(set * rows + r) * HD + d] = acc[i][c];
        }
        if (lane == 0) Mml[set * rows + r] = make_float2(m[i], l[i]);
      }
    }
    __syncthreads();
    for (int item = tid; item < rows * D4; item += TH) {
      const int r = item / D4, d4 = item % D4;
      if (live > 1 && frontier<KVLEN>(qpos, b, T, r / group, S) < c0) continue;
      float M = TVA_NEG_INF, L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < KS; ++j) M = fmaxf(M, Mml[j * rows + r].x);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float2 ml = Mml[j * rows + r];
        const float4 a = reinterpret_cast<const float4*>(Ma + (j * rows + r) * HD)[d4];
        const float e = __expf(ml.x - M);
        L = fmaf(e, ml.y, L);
        A.x = fmaf(e, a.x, A.x);
        A.y = fmaf(e, a.y, A.y);
        A.z = fmaf(e, a.z, A.z);
        A.w = fmaf(e, a.w, A.w);
      }
      if (live == 1) {
        const float inv = 1.f / (L == 0.f ? 1.f : L);
        TQ* orow = out_row(r) + 4 * d4;
        tva_st(orow + 0, A.x * inv);
        tva_st(orow + 1, A.y * inv);
        tva_st(orow + 2, A.z * inv);
        tva_st(orow + 3, A.w * inv);
      } else {
        const size_t at = base + (size_t)split * rows + r;
        reinterpret_cast<float4*>(part_acc + at * HD)[d4] = A;
        if (d4 == 0) part_ml[at] = make_float2(M, L);
      }
    }
    if (live == 1) return;
  }

  merge_splits<HD, KVLEN>(qpos, o, part_acc, part_ml, base, tickets, tid, TH, b, T, S, nq, kvh,
                          group, rows, chunk, split, nsplit, live, slot);
}

template <int HD, int RW, typename TQ, typename TC, bool KVLEN>
__global__ void __launch_bounds__(THREADS)
split_kernel(const TQ* __restrict__ q, const typename Chunk<TC>::Store* __restrict__ kc,
             const typename Chunk<TC>::Store* __restrict__ vc, const bf16* __restrict__ ksc,
             const bf16* __restrict__ vsc, const int* __restrict__ qpos, TQ* __restrict__ o,
             float* __restrict__ part, int* __restrict__ tickets, int T, int S, int nq, int nkv,
             int chunk, float scale) {
  split_body<HD, RW, 1, TQ, TC, KVLEN>(q, kc, vc, ksc, vsc, qpos, o, part, tickets, T, S, nq, nkv,
                                       chunk, scale);
}

// The warps-on-keys instantiation: two blocks of 8 warps an SM, so at most
// 128 registers a thread.
template <int HD, typename TQ, typename TC, bool KVLEN>
__global__ void __launch_bounds__(KEY_SET_WARPS * 32, 2)
split_sets_kernel(const TQ* __restrict__ q, const typename Chunk<TC>::Store* __restrict__ kc,
                  const typename Chunk<TC>::Store* __restrict__ vc, const bf16* __restrict__ ksc,
                  const bf16* __restrict__ vsc, const int* __restrict__ qpos,
                  TQ* __restrict__ o, float* __restrict__ part, int* __restrict__ tickets, int T,
                  int S, int nq, int nkv, int chunk, float scale) {
  split_body<HD, 1, KEY_SETS, TQ, TC, KVLEN>(q, kc, vc, ksc, vsc, qpos, o, part, tickets, T, S,
                                             nq, nkv, chunk, scale);
}

template <int HD, int RW, int KS, typename TQ, typename TC, bool KVLEN>
int launch(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
           const int* qpos, void* o, float* part, int* tickets, int B, int T, int S, int nq,
           int nkv, int chunk, float scale, cudaStream_t stream) {
  using Store = typename Chunk<TC>::Store;
  const int rows = T * (nq / nkv);
  const int nsplit = (S + chunk - 1) / chunk;
  constexpr int NW = KS > 1 ? KEY_SET_WARPS : NWARPS;
  // KS > 1 merges the sets' partials in the K / V tiles' space
  static_assert(KS == 1 || NW * RW * (HD + 2) <= KS * TILE * (2 * HD + 4),
                "the sets' partials must fit the tiles' shared memory");
  const size_t smem =
      sizeof(float) * (rows * HD + KS * TILE * (HD + 4) + KS * TILE * HD + NW * RW * TILE);
  dim3 grid(nsplit, nkv, B);
  if constexpr (KS == 1) {
    cudaError_t err = tva_allow_smem(split_kernel<HD, RW, TQ, TC, KVLEN>, smem);
    if (err != cudaSuccess) return (int)err;
    split_kernel<HD, RW, TQ, TC, KVLEN><<<grid, THREADS, smem, stream>>>(
        (const TQ*)q, (const Store*)kc, (const Store*)vc, (const bf16*)ksc, (const bf16*)vsc,
        qpos, (TQ*)o, part, tickets, T, S, nq, nkv, chunk, scale);
  } else {
    static_assert(KS == KEY_SETS && RW == 1, "one warps-on-keys instantiation");
    cudaError_t err = tva_allow_smem(split_sets_kernel<HD, TQ, TC, KVLEN>, smem);
    if (err != cudaSuccess) return (int)err;
    split_sets_kernel<HD, TQ, TC, KVLEN><<<grid, NW * 32, smem, stream>>>(
        (const TQ*)q, (const Store*)kc, (const Store*)vc, (const bf16*)ksc, (const bf16*)vsc,
        qpos, (TQ*)o, part, tickets, T, S, nq, nkv, chunk, scale);
  }
  return (int)cudaGetLastError();
}

// rows per warp: the smallest of 1, 2, 3, 5, 8, 16 that covers T * group
// rows (5: the (1, 9) and (8, 9) blocks' 72 rows at tinyllama's group of 8).
// KVLEN: T = 1 and a group of at most 16, so one row per warp.
template <int HD, typename TQ, typename TC, bool KVLEN>
int launch_rows(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
                const int* qpos, void* o, float* part, int* tickets, int B, int T, int S, int nq,
                int nkv, int chunk, float scale, cudaStream_t st) {
#define TVA_LAUNCH(R)                                                                            \
  return launch<HD, R, 1, TQ, TC, KVLEN>(q, kc, vc, ksc, vsc, qpos, o, part, tickets, B, T, S, \
                                         nq, nkv, chunk, scale, st)
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

// KVLEN (K2, K5, K10): one query row per warp, or with key_sets = KEY_SETS
// the warps-on-keys instantiation (at most KEY_SET_WARPS / KEY_SETS rows,
// head dim at most KEY_SETS_MAX_HD).
template <int HD, typename TQ, typename TC>
int launch_t1(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
              const int* kv_len, void* o, float* part, int* tickets, int B, int S, int nq,
              int nkv, int chunk, int key_sets, float scale, cudaStream_t st) {
  if (key_sets == 1)
    return launch<HD, 1, 1, TQ, TC, true>(q, kc, vc, ksc, vsc, kv_len, o, part, tickets, B, 1, S,
                                          nq, nkv, chunk, scale, st);
  if constexpr (HD <= KEY_SETS_MAX_HD) {
    if (key_sets == KEY_SETS && nq / nkv <= KEY_SET_WARPS / KEY_SETS)
      return launch<HD, 1, KEY_SETS, TQ, TC, true>(q, kc, vc, ksc, vsc, kv_len, o, part, tickets,
                                                   B, 1, S, nq, nkv, chunk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The operands every entry point checks: at most MAX_SPLITS whole-tile
// chunks, scratch and counters given.
bool bad_split(int B, int T, int S, int nq, int nkv, int chunk, const void* part,
               const void* tickets) {
  return B <= 0 || T <= 0 || T > MAX_T || S <= 0 || nkv <= 0 || nq % nkv != 0 ||
         nq / nkv > MAX_GROUP || chunk <= 0 || chunk % TILE != 0 ||
         (S + chunk - 1) / chunk > MAX_SPLITS || part == nullptr || tickets == nullptr;
}

}  // namespace
