// The paged tensor-core body of K6 / K7 (paged_attention.cu) and K8 / K9
// (paged_attention_quant.cu) for bf16 queries, the launches of every bf16
// engine: T <= 16 query tokens per batch row (K6 / K8: one, to kv_len)
// against a paged KV pool read through block tables, the pool bf16 or
// quantized (int8, or packed int4 with bf16 scales per (key row, kv head)),
// the key range split across the card. fp32 queries (the distilled
// checkpoint's golden phases) keep the fp32 body of decode_attention.cuh.
//
// What bounds the work on an H100. At the batched engine's (32, 9)
// fast-forward step (K7, K9) a (batch row, kv head) has 72 query rows against
// ~1,000 keys of hd 64: arithmetic, ~35 us a block on fp32 lanes, while the
// K/V bytes (mostly the shared prompt prefix, which stays in L2) take ~3 us.
// So the products run on the tensor cores, and the key range is split so
// that enough blocks exist once a block's arithmetic has shrunk. At T = 1
// (K6, K8: every fast-forward-0 step) a (row, kv head) has only `group` query
// rows (8 for tinyllama, 4 for mixtral-8x7b): the same bytes and 1/9 of the
// arithmetic, so the time goes to bringing the tiles in; the T = 1 body
// spreads a split's tiles over a block's warps (below).
//
// The design. The grid is (kv head, batch row, key split), the split slowest:
// blocks start split by split, so the blocks reading the same prefix tiles
// run together and the splits past every frontier, which return at once,
// come last (the split-fastest order was the slower of the two on the card
// at the (32, 9) step). The wrapper picks the chunk of keys a split covers
// from the shapes alone (`paged_key_chunk`, `paged_t1_chunk` in
// ops/decode_attention.py), whole 64-key tiles, so that at half-full block
// tables enough live blocks exist to fill the card.
// - A block reads its split's block-table entries once (one global read per
//   pool block of the split, issued beside the positions' read) into shared
//   memory. A tile's pool rows follow from one entry when the block size is
//   a multiple of the tile (the engines' 128: one lookup a tile), else from
//   tile / bs entries (bs 16, 32, 64), any block size still working. Splits
//   past the row's largest position return at once.
// - K7 / K9 (`paged_split_kernel`): the T * group query rows of the kv head,
//   padded to whole 16-row tiles, are one warp each (at most 8 warps: a
//   launch takes at most 128 rows, and the entry point launches a wider
//   block, T * group > 128, in parts of whole queries). Q enters as bf16 A
//   fragments, loaded once.
// - K6 / K8 (`paged_t1_kernel`, warps on keys): a block of KEY_SETS warps,
//   each with the same <= 16 query rows and its own (m, l, output), warp w
//   taking the split's 32-key tiles w, w + KEY_SETS, ... through its own
//   cp.async ring; the warps' partials merge in shared memory in warp order.
//   At a group of at most 8 the 16-row tile's upper 8 rows are dead, so P.V
//   carries P's high part in rows 0-7 and its middle part in rows 8-15 of
//   one A fragment (two products a key step where three parts took three),
//   the two halves of the output summed once at the end.
// - K/V tiles arrive as stored (bf16, int8 or packed int4 bytes, and a
//   quantized pool's scale words) by cp.async, keys past the split's last
//   live key zero-filled. bf16 tiles feed ldmatrix as they are. A quantized
//   tile is widened once a tile to its stored integers in bf16 (|v| <= 127
//   and the int4 nibbles are exact in bf16; no scale is applied), by the
//   whole block (K9: every warp then reads the same bf16 tile, where
//   widening inside each warp's fragments would repeat the work once per 16
//   query rows) or by the warp that owns the tile (K8). int4 widens the low
//   nibbles of a row's bytes to dims [0, hd/2) and the high nibbles to
//   [hd/2, hd), one fragment layout.
// - S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 sums): a bf16 product is
//   exact in fp32, so S is the plain version's up to the order of the sums.
//   A quantized pool's key scale multiplies its score column after the
//   product, (q . k_int) * ks * scale, as the TPU kernel's `_qk_dot` fold
//   does.
// - Each query row has its own frontier; keys past it score -1e30. A warp
//   skips the tiles past the largest frontier of its rows. The running max,
//   sum and output stay in fp32 registers (the sum from the fp32 p).
// - P.V: P enters as three bf16 fragments (hi, mid, lo; `split3_bf16`, as K1
//   does: one or two parts move bf16 decoding, see
//   tests/test_torch_kernel_design.py), a quantized pool's as p * vs per key
//   (`_pv_dot`), against V's bf16 (or widened integers) by ldmatrix.trans; a
//   tile's P.V is summed from 0 and then added to the running output.
// - The split's partials go to fp32 scratch and merge through
//   split_merge.cuh's fixed-order two-level ticket merge (the dense bodies'
//   merge): the same bits from run to run, no atomics on the output. A row
//   with no valid key (K6 / K8: kv_len 0) writes zeros; a T = 1 (row, kv
//   head) whose keys fit one split writes its output without the scratch.
#pragma once

#include <cstdint>
#include <type_traits>

#include "kv_chunk.cuh"
#include "mma.cuh"
#include "split_merge.cuh"

namespace {
namespace paged {

using bf16 = __nv_bfloat16;
constexpr int TILE = 64;      // keys per tile (K7 / K9); splits are whole tiles
constexpr int MAX_WARPS = 8;  // one per 16 query rows
constexpr int MAX_ROWS = 16 * MAX_WARPS;
constexpr int MAX_T = 16;
constexpr int MAX_GROUP = 16;
// The T = 1 key-set body: KEY_SETS warps a block, 32-key tiles a warp
constexpr int KEY_SETS = 4;
constexpr int T1_TILE = 32;

// What a pool row of one kv head holds (TC: bf16, QInt8, QInt4) and how a
// tile of it sits in shared memory.
template <typename TC, int HD>
struct Tile {
  static constexpr bool QUANT = !std::is_same<TC, bf16>::value;
  static constexpr bool INT4 = std::is_same<TC, QInt4>::value;
  static constexpr int ROW = QUANT ? (INT4 ? HD / 2 : HD) : 2 * HD;  // stored bytes
  // 16-byte copies; 8 for int4, whose head rows (24 bytes at hd 48) start at
  // multiples of 8 bytes
  static constexpr int COPY = INT4 ? 8 : 16;
  static constexpr int CPR = ROW / COPY;  // copies a key row
  // bf16 rows (Q, bf16 and widened K/V tiles) padded by 16 bytes, so the 8
  // row addresses of an ldmatrix fall in distinct bank groups at every hd
  static constexpr int P = HD + 8;
  static constexpr int PITCH = QUANT ? ROW : 2 * P;  // bytes of a ring row
  // a ring stage of nk keys: K rows, V rows, then (quantized) the K and V
  // scale words
  static constexpr int stage(int nk) { return 2 * nk * PITCH + (QUANT ? 2 * nk * 4 : 0); }
  // two stages: a third moved nothing on the card, and the smaller blocks
  // (the spec step's 40 rows) fit more of them an SM
  static constexpr int STAGES = 2;
  static constexpr int STAGE = 2 * TILE * PITCH + (QUANT ? 2 * TILE * 4 : 0);
  static_assert(ROW % COPY == 0 && HD % 16 == 0, "whole copies and mma steps a head row");
};

// Byte offsets of the dynamic shared memory: Q [16 mt][P] bf16; the ring;
// (quantized) the widened K, V tile [2][TILE][P] bf16, its scales [2][TILE]
// fp32 and the half of each stage's scale words that holds a row's scale;
// the split's block-table entries.
struct Layout {
  int q, ring, conv, scl, half, tbl, total;
};
template <int HD, typename TC>
__host__ __device__ inline Layout layout(int mt, int n_tbl) {
  using C = Tile<TC, HD>;
  Layout L;
  int at = 0;
  L.q = at;
  at += mt * 16 * C::P * 2;
  L.ring = at;
  at += C::STAGES * C::STAGE;
  L.conv = at;
  at += C::QUANT ? 2 * TILE * C::P * 2 : 0;
  L.scl = at;
  at += C::QUANT ? 2 * TILE * 4 : 0;
  L.half = at;
  at += C::QUANT ? C::STAGES * 2 * TILE : 0;
  at = (at + 15) & ~15;
  L.tbl = at;
  at += 4 * n_tbl;
  L.total = at;
  return L;
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Four unsigned bytes of a word, each a stored value plus `bias`, as bf16
// (two registers, the lowest byte first): each byte under the fp32 exponent
// of 2^23 is 2^23 + byte, less 2^23 + bias the value, exact; the values
// (|v| <= 128) are exact in bf16.
__device__ __forceinline__ void bytes_bf16(uint32_t u, float bias, uint32_t& lo, uint32_t& hi) {
  const float m = 8388608.f + bias;
  lo = pack_bf16(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - m,
                 __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - m);
  hi = pack_bf16(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - m,
                 __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - m);
}
// int8 values (two's complement): byte ^ 0x80 is the value + 128
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  bytes_bf16(w ^ 0x80808080u, 128.f, lo, hi);
}
// the signed low (or high) nibbles of a word's bytes: nibble ^ 8 is the value + 8
__device__ __forceinline__ void lo4x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  bytes_bf16((w & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, lo, hi);
}
__device__ __forceinline__ void hi4x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  bytes_bf16(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, lo, hi);
}

// The pool planes of one launch and the split's block-table entries in
// shared memory: key s of the row is pool row tbl[s / bs - e0] * bs + s % bs.
struct Pool {
  const unsigned char* kc;
  const unsigned char* vc;
  const bf16* ksc;
  const bf16* vsc;
  const int* tbl;
  int e0, bs, nkv, kvh;
  __device__ __forceinline__ int row(int s) const { return tbl[s / bs - e0] * bs + s % bs; }
};

// Copies of keys [k0, k0 + NK) into a ring stage by threads tid of TH: the K
// and V rows as stored, keys at or past kend zero-filled, and (quantized) the
// 4-byte word of a scale plane holding each key's bf16 scale, with the half
// of it that does into `half`. `one_block`: the NK keys lie in one pool block.
template <typename C, int NK>
__device__ __forceinline__ void load_keys(const Pool& pl, unsigned char* stage,
                                          unsigned char* half, int k0, int kend, bool one_block,
                                          int tid, int TH) {
  const int row0 = one_block ? pl.row(k0) : 0;
  for (int i = tid; i < 2 * NK * C::CPR; i += TH) {
    const int kv = i / (NK * C::CPR), rem = i % (NK * C::CPR);
    const int r = rem / C::CPR, c = rem % C::CPR;
    const int s = k0 + r;
    const bool ok = s < kend;
    const int pr = !ok ? 0 : one_block ? row0 + r : pl.row(s);
    const unsigned char* src =
        (kv ? pl.vc : pl.kc) + ((size_t)pr * pl.nkv + pl.kvh) * C::ROW + c * C::COPY;
    const uint32_t dst = smem_u32(stage + (kv * NK + r) * C::PITCH + c * C::COPY);
    if constexpr (C::COPY == 16)
      cp_async16(dst, src, ok);
    else
      cp_async8(dst, src, ok);
  }
  if constexpr (C::QUANT) {
    uint32_t* words = reinterpret_cast<uint32_t*>(stage + 2 * NK * C::PITCH);
    for (int i = tid; i < 2 * NK; i += TH) {
      const int kv = i / NK, r = i % NK, s = k0 + r;
      const bool ok = s < kend;
      const size_t at = ok ? (size_t)(one_block ? row0 + r : pl.row(s)) * pl.nkv + pl.kvh : 0;
      cp_async4(smem_u32(words + i), (kv ? pl.vsc : pl.ksc) + (at & ~(size_t)1), ok);
      half[i] = (unsigned char)(at & 1);
    }
  }
}

// A quantized stage's integers widened to bf16 into `conv` [2][NK][P], its
// scales to fp32 into `scl` [2][NK], by threads tid of TH.
template <typename C, int HD, int NK>
__device__ __forceinline__ void widen_keys(const unsigned char* stage, const unsigned char* half,
                                           bf16* conv, float* scl, int tid, int TH) {
  for (int i = tid; i < 2 * NK * C::CPR; i += TH) {
    const int kv = i / (NK * C::CPR), rem = i % (NK * C::CPR);
    const int r = rem / C::CPR, c = rem % C::CPR;
    const unsigned char* src = stage + (kv * NK + r) * C::PITCH + c * C::COPY;
    bf16* dst = conv + (kv * NK + r) * C::P;
    if constexpr (C::INT4) {
      // 8 bytes: low nibbles dims 8 c .. 8 c + 7, high nibbles hd / 2 + 8 c ..
      const uint2 w = *reinterpret_cast<const uint2*>(src);
      uint4 lo, hi;
      lo4x4_bf16(w.x, lo.x, lo.y);
      lo4x4_bf16(w.y, lo.z, lo.w);
      hi4x4_bf16(w.x, hi.x, hi.y);
      hi4x4_bf16(w.y, hi.z, hi.w);
      *reinterpret_cast<uint4*>(dst + 8 * c) = lo;
      *reinterpret_cast<uint4*>(dst + HD / 2 + 8 * c) = hi;
    } else {
      // 16 bytes: dims 16 c .. 16 c + 15
      const uint4 w = *reinterpret_cast<const uint4*>(src);
      uint4 a, z;
      i8x4_bf16(w.x, a.x, a.y);
      i8x4_bf16(w.y, a.z, a.w);
      i8x4_bf16(w.z, z.x, z.y);
      i8x4_bf16(w.w, z.z, z.w);
      *reinterpret_cast<uint4*>(dst + 16 * c) = a;
      *reinterpret_cast<uint4*>(dst + 16 * c + 8) = z;
    }
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage + 2 * NK * C::PITCH);
  for (int i = tid; i < 2 * NK; i += TH)
    scl[i] = __uint_as_float(half[i] ? words[i] & 0xffff0000u : words[i] << 16);
}

// One warp's 16 query rows (Q as A fragments `qf`) against a tile of NK keys
// from k0 (Kt, Vt: [NK][P] bf16; a quantized pool's widened integers with
// their scales kscl, vscl), in the online softmax (m_r, l_r, oacc) of the
// thread's rows g and g + 8 (frontiers fr). Thread layout of an m16n8
// fragment: lane = 4 g + t holds rows g and g + 8, columns 2t and 2t + 1.
// PACK (at most 8 live rows): rows g + 8 carry P's middle part for row g,
// their output is row g's (summed by the caller), their m and l unused.
template <int HD, bool QUANT, int NK, bool PACK>
__device__ __forceinline__ void attend(uint32_t (&qf)[HD / 16][4], const bf16* Kt,
                                       const bf16* Vt, const float* kscl, const float* vscl,
                                       int k0, const int (&fr)[2], float scale, float (&m_r)[2],
                                       float (&l_r)[2], float (&oacc)[HD / 8][4], int lane) {
  constexpr int P = HD + 8;
  constexpr int KSTEPS = HD / 16;  // k16 steps of Q.K^T
  constexpr int DT = HD / 8;       // n8 tiles of the output
  constexpr int NT = NK / 8;       // n8 tiles of the scores
  constexpr int HR = PACK ? 1 : 2;  // live halves of the fragment's rows
  const int t4 = lane & 3;

  // S = Q K^T: 16 rows x NK keys
  float sacc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];  // keys 16 np + [0, 8) and [8, 16), dims 16 kk + [0, 8) and [8, 16)
      const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(r, smem_u32(Kt + key * P + kk * 16 + (((lane >> 3) & 1) << 3)));
      mma16816(sacc[2 * np], qf[kk], r[0], r[1]);
      mma16816(sacc[2 * np + 1], qf[kk], r[2], r[3]);
    }
  }

  // the key scales, the softmax scale, each row's frontier; online softmax
  float mt[2] = {TVA_NEG_INF, TVA_NEG_INF};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((e >> 1) >= HR) continue;
      const int col = j * 8 + 2 * t4 + (e & 1);
      float s = sacc[j][e];
      if constexpr (QUANT) s *= kscl[col];
      s *= scale;
      if (k0 + col > fr[e >> 1]) s = TVA_NEG_INF;
      sacc[j][e] = s;
      mt[e >> 1] = fmaxf(mt[e >> 1], s);
    }
  }
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < HR; ++hr) {
    mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
    mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
    const float m_new = fmaxf(m_r[hr], mt[hr]);
    alpha[hr] = __expf(m_r[hr] - m_new);
    m_r[hr] = m_new;
  }
  if constexpr (PACK) alpha[1] = alpha[0];
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((e >> 1) >= HR) continue;
      const float p = __expf(sacc[j][e] - m_r[e >> 1]);
      ps[e >> 1] += p;
      // p * vs enters P.V (the stored integers' scale per key)
      if constexpr (QUANT)
        sacc[j][e] = p * vscl[j * 8 + 2 * t4 + (e & 1)];
      else
        sacc[j][e] = p;
    }
  }
#pragma unroll
  for (int hr = 0; hr < HR; ++hr) {
    ps[hr] += __shfl_xor_sync(0xffffffffu, ps[hr], 1);
    ps[hr] += __shfl_xor_sync(0xffffffffu, ps[hr], 2);
    l_r[hr] = alpha[hr] * l_r[hr] + ps[hr];
  }
  // this tile's P V, P as three bf16 A fragments, summed into a fresh
  // accumulator: the tensor cores truncate each sum to fp32, so the tile's
  // terms are kept off the running output's larger exponent
  float tacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) tacc[i][0] = tacc[i][1] = tacc[i][2] = tacc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t pf[3][4];
    split3_bf16(sacc[2 * kk][0], sacc[2 * kk][1], pf, 0);
    split3_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], pf, 2);
    if constexpr (!PACK) {
      split3_bf16(sacc[2 * kk][2], sacc[2 * kk][3], pf, 1);
      split3_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], pf, 3);
    }
    // PACK: rows 0-7 the high part, rows 8-15 the middle part; then the low
    // part in rows 0-7
    const uint32_t hm[4] = {pf[0][0], pf[1][0], pf[0][2], pf[1][2]};
    const uint32_t lo[4] = {pf[2][0], 0u, pf[2][2], 0u};
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t r[4];  // keys 16 kk + [0, 8) and [8, 16), dims 16 dp + [0, 8) and [8, 16)
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldsm_x4_t(r, smem_u32(Vt + key * P + dp * 16 + ((lane >> 4) << 3)));
      if constexpr (PACK) {
        mma16816(tacc[2 * dp], lo, r[0], r[1]);
        mma16816(tacc[2 * dp + 1], lo, r[2], r[3]);
        mma16816(tacc[2 * dp], hm, r[0], r[1]);
        mma16816(tacc[2 * dp + 1], hm, r[2], r[3]);
      } else {
#pragma unroll
        for (int k = 2; k >= 0; --k) {
          mma16816(tacc[2 * dp], pf[k], r[0], r[1]);
          mma16816(tacc[2 * dp + 1], pf[k], r[2], r[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = fmaf(oacc[i][e], alpha[e >> 1], tacc[i][e]);
  }
}

// Q rows [0, 16 mt) of a kv head into shared memory by cp.async (threads tid
// of TH): row r is query r / group of q head kvh * group + r % group; the
// padding rows are zero-filled.
template <int HD>
__device__ __forceinline__ void load_q(const bf16* q, bf16* Qs, int b, int T, int nq, int kvh,
                                       int group, int rows, int mt, int tid, int TH) {
  constexpr int P = HD + 8, CQ = HD / 8;  // 16-byte copies a row
  for (int i = tid; i < mt * 16 * CQ; i += TH) {
    const int r = i / CQ, c = i % CQ;
    const bool ok = r < rows;
    const int rr = ok ? r : 0;
    cp_async16(smem_u32(Qs + r * P + c * 8),
               q + ((size_t)(b * T + rr / group) * nq + kvh * group + rr % group) * HD + c * 8,
               ok);
  }
}

// One launch: queries [0, Tn) of q / q_positions / o, whose rows are T
// queries apart. kc / vc: the
// layer's pool planes (N * bs, nkv, row bytes); ksc / vsc: its scale planes
// (N * bs, nkv) bf16 (quantized pools).
//
// At hd <= 64 the kernel is held to 128 registers (two 8-warp blocks, or
// three of the (32, 9) step's 5 warps, an SM). Unbounded, ptxas gave it 181,
// at which 8 warps fit an SM: one 5-warp block, and the slower step on the
// card. hd 128 (mixtral-8x7b) keeps its registers: 255 with the quantized
// tile too (K9 at hd 128, ptxas: no spills); its shared memory, at most ~102
// KB with 8 warps and the widened tile, stays under the 227 KB opt-in.
template <int HD, typename TC>
__global__ void __launch_bounds__(MAX_WARPS * 32, HD <= 64 ? 2 : 1)
paged_split_kernel(const bf16* __restrict__ q, const unsigned char* __restrict__ kc,
                   const unsigned char* __restrict__ vc, const bf16* __restrict__ ksc,
                   const bf16* __restrict__ vsc, const int* __restrict__ qpos,
                   const int* __restrict__ table, bf16* __restrict__ o, float* __restrict__ part,
                   int* __restrict__ tickets, int T, int Tn, int S, int bs, int max_blocks, int nq,
                   int nkv, int chunk, int n_tbl, float scale) {
  using C = Tile<TC, HD>;
  constexpr int P = C::P, ST = C::STAGES;
  constexpr int KSTEPS = HD / 16;  // k16 steps of Q.K^T
  constexpr int DT = HD / 8;       // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, TH = blockDim.x;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int group = nq / nkv, rows = Tn * group;
  const Layout lay = layout<HD, TC>(TH / 32, n_tbl);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  unsigned char* ring = smem + lay.ring;
  int* tbl = reinterpret_cast<int*>(smem + lay.tbl);

  // The split's keys [c0, cend) lie in pool blocks table[b, e0 .. e0 + ne);
  // those entries are read beside the positions (the two reads overlap).
  const int c0 = split * chunk, cend = min(c0 + chunk, S);
  const int e0 = c0 / bs, ne = (cend - 1) / bs - e0 + 1;
  const int* trow = table + (size_t)b * max_blocks;
  const int ent = tid < ne ? trow[e0 + tid] : 0;
  int max_pos = -1;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t)
    if (t < Tn) max_pos = max(max_pos, frontier<false>(qpos, b, T, t, S));
  // splits that hold a key some row sees; split 0 always runs, so that a
  // (row, kv head) whose rows see no key still gets its zeros
  const int live = max(max_pos, 0) / chunk + 1;
  if (split >= live) return;
  const int kend = min(cend, max_pos + 1);
  const int ntiles = kend > c0 ? (kend - c0 + TILE - 1) / TILE : 0;

  load_q<HD>(q, Qs, b, T, nq, kvh, group, rows, TH / 32, tid, TH);
  if (tid < ne) tbl[tid] = ent;
  for (int i = tid + TH; i < ne; i += TH) tbl[i] = trow[e0 + i];
  __syncthreads();  // the entries are in place

  // A tile lies in one pool block when bs is a multiple of the tile: one
  // lookup a tile.
  const Pool pl{kc, vc, ksc, vsc, tbl, e0, bs, nkv, kvh};
  const bool one_block = bs % TILE == 0;
  auto load_tile = [&](int it) {
    load_keys<C, TILE>(pl, ring + (it % ST) * C::STAGE, smem + lay.half + (it % ST) * 2 * TILE,
                       c0 + it * TILE, kend, one_block, tid, TH);
  };
  // quantized: each tile's integers widened to bf16 into the conv tile, and
  // its scales to fp32
  bf16* conv = reinterpret_cast<bf16*>(smem + lay.conv);
  float* kscl = reinterpret_cast<float*>(smem + lay.scl);
  float* vscl = kscl + TILE;

  // prologue: Q (in group 0) and the first ST - 1 tiles, one group each
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  // this thread's rows, warp * 16 + g and that + 8, and their frontiers; the
  // warp's largest frontier bounds the tiles it computes
  int fr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    fr[h] = r < rows ? frontier<false>(qpos, b, T, r / group, S) : -1;
  }
  int whi = max(fr[0], fr[1]);
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, o2));

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_r[2] = {TVA_NEG_INF, TVA_NEG_INF}, l_r[2] = {0.f, 0.f};
  uint32_t qf[KSTEPS][4];

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<ST - 2>();  // tile it (and Q) landed for this thread's copies
    __syncthreads();          // ... and every thread's; tile it - 1's stage is free
    if (it + ST - 1 < ntiles) load_tile(it + ST - 1);
    cp_async_commit();
    const bf16* Kt;
    const bf16* Vt;
    if constexpr (C::QUANT) {
      widen_keys<C, HD, TILE>(ring + (it % ST) * C::STAGE, smem + lay.half + (it % ST) * 2 * TILE,
                              conv, kscl, tid, TH);
      __syncthreads();
      Kt = conv;
      Vt = conv + TILE * P;
    } else {
      Kt = reinterpret_cast<const bf16*>(ring + (it % ST) * C::STAGE);
      Vt = Kt + TILE * P;
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int r = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4(qf[kk], smem_u32(Qs + r * P + kk * 16 + ((lane >> 4) << 3)));
      }
    }
    const int k0 = c0 + it * TILE;
    if (k0 > whi) continue;  // no row of this warp sees this tile's keys or later ones
    attend<HD, C::QUANT, TILE, false>(qf, Kt, Vt, kscl, vscl, k0, fr, scale, m_r, l_r, oacc,
                                      lane);
  }
  cp_async_wait<0>();  // no copy outlives the block

  // this split's partials, for the rows whose frontier reaches it; then the
  // tickets and merges
  const int nent = nsplit + (nsplit + GROUP - 1) / GROUP;
  const size_t nslots = (size_t)gridDim.x * gridDim.y;
  float* part_acc = part;
  float2* part_ml = reinterpret_cast<float2*>(part + nslots * nent * rows * HD);
  const int slot = b * nkv + kvh;
  const size_t base = (size_t)slot * nent * rows;  // (slot, entry 0, row 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r < rows && fr[h] >= c0) {
      const size_t at = base + (size_t)split * rows + r;
#pragma unroll
      for (int i = 0; i < DT; ++i)
        *reinterpret_cast<float2*>(part_acc + at * HD + i * 8 + 2 * t4) =
            make_float2(oacc[i][2 * h], oacc[i][2 * h + 1]);
      if (t4 == 0) part_ml[at] = make_float2(m_r[h], l_r[h]);
    }
  }
  merge_splits<HD, false>(qpos, o, part_acc, part_ml, base, tickets, tid, TH, b, T, S, nq, kvh,
                          group, rows, chunk, split, nsplit, live, slot);
}

// The T = 1 key-set body's shared memory: Q [16][P] bf16; per warp, its ring
// of T1_STAGES stages of T1_TILE keys and (quantized) its widened tile
// [2][T1_TILE][P] bf16, the tile's scales [2][T1_TILE] fp32 and the stages'
// scale halves; the split's block-table entries. After the tiles, the warps'
// regions hold their partials for the block's merge: (acc [KEY_SETS][rows][HD],
// then (m, l) [KEY_SETS][rows]) fp32.
template <int HD, typename TC>
struct T1 {
  using C = Tile<TC, HD>;
  // hd 128 (mixtral-8x7b) keeps one stage a warp: two would hold one block
  // an SM
  static constexpr int STAGES = HD <= 64 ? 2 : 1;
  static constexpr int STAGE = C::stage(T1_TILE);
  static constexpr int CONV = C::QUANT ? 2 * T1_TILE * C::P * 2 : 0;
  static constexpr int SCL = C::QUANT ? 2 * T1_TILE * 4 : 0;
  static constexpr int HALF = C::QUANT ? STAGES * 2 * T1_TILE : 0;
  static constexpr int WARP = (STAGES * STAGE + CONV + SCL + HALF + 15) & ~15;  // bytes a warp
  static constexpr int Q = 16 * C::P * 2;
  static constexpr int TBL = Q + KEY_SETS * WARP;
  static_assert(KEY_SETS * MAX_GROUP * (HD + 2) * 4 <= KEY_SETS * WARP,
                "the warps' partials fit their regions");
  static constexpr int total(int n_tbl) { return TBL + 4 * n_tbl; }
};

// K6 / K8 with bf16 queries: one query a row (kv_len[b] keys), the rows of a
// kv head (group <= 16) in every warp of a block of KEY_SETS warps; warp w
// takes the split's T1_TILE-key tiles w, w + KEY_SETS, ... PACK: group <= 8.
// At hd <= 64 the kernel is held to 128 registers, room for four blocks an
// SM; their shared memory (76 KB at hd 64) fits three. hd 128 keeps its
// registers (229-247 a thread, the quantized tile's 230-247 too), which fit
// two; the quantized block's ~107 KB of shared memory fits two. paged_t1_chunk
// (ops/decode_attention.py) sizes its splits for those counts.
template <int HD, typename TC, bool PACK>
__global__ void __launch_bounds__(KEY_SETS * 32, HD <= 64 ? 4 : 1)
paged_t1_kernel(const bf16* __restrict__ q, const unsigned char* __restrict__ kc,
                const unsigned char* __restrict__ vc, const bf16* __restrict__ ksc,
                const bf16* __restrict__ vsc, const int* __restrict__ kv_len,
                const int* __restrict__ table, bf16* __restrict__ o, float* __restrict__ part,
                int* __restrict__ tickets, int S, int bs, int max_blocks, int nq, int nkv,
                int chunk, float scale) {
  using C = Tile<TC, HD>;
  using L = T1<HD, TC>;
  constexpr int P = C::P, ST = L::STAGES, NK = T1_TILE, TH = KEY_SETS * 32;
  constexpr int KSTEPS = HD / 16, DT = HD / 8, D4 = HD / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int group = nq / nkv, rows = group;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* mine = smem + L::Q + warp * L::WARP;  // this warp's region
  int* tbl = reinterpret_cast<int*>(smem + L::TBL);

  // the split's keys [c0, cend), their block-table entries, the row's frontier
  const int c0 = split * chunk, cend = min(c0 + chunk, S);
  const int e0 = c0 / bs, ne = (cend - 1) / bs - e0 + 1;
  const int* trow = table + (size_t)b * max_blocks;
  const int ent = tid < ne ? trow[e0 + tid] : 0;
  const int fr_row = frontier<true>(kv_len, b, 1, 0, S);
  const int live = max(fr_row, 0) / chunk + 1;
  if (split >= live) return;
  const int kend = min(cend, fr_row + 1);
  const int ntiles = kend > c0 ? (kend - c0 + NK - 1) / NK : 0;
  const int nmine = ntiles > warp ? (ntiles - warp + KEY_SETS - 1) / KEY_SETS : 0;

  load_q<HD>(q, Qs, b, 1, nq, kvh, group, rows, 1, tid, TH);
  cp_async_commit();
  if (tid < ne) tbl[tid] = ent;
  for (int i = tid + TH; i < ne; i += TH) tbl[i] = trow[e0 + i];
  __syncthreads();  // the entries are in place

  const Pool pl{kc, vc, ksc, vsc, tbl, e0, bs, nkv, kvh};
  const bool one_block = bs % NK == 0;
  unsigned char* half = mine + ST * L::STAGE + L::CONV + L::SCL;
  auto load_tile = [&](int j) {  // the warp's j-th tile
    load_keys<C, NK>(pl, mine + (j % ST) * L::STAGE, half + (j % ST) * 2 * NK,
                     c0 + (warp + j * KEY_SETS) * NK, kend, one_block, lane, 32);
    cp_async_commit();
  };
  if (nmine > 0) load_tile(0);
  cp_async_wait<0>();
  __syncthreads();  // Q (and each warp's first tile) landed

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int r = (lane & 7) + (((lane >> 3) & 1) << 3);
    ldsm_x4(qf[kk], smem_u32(Qs + r * P + kk * 16 + ((lane >> 4) << 3)));
  }
  // every row of the kv head has the row's frontier (the padding rows'
  // outputs are never written)
  const int fr[2] = {fr_row, fr_row};
  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_r[2] = {TVA_NEG_INF, TVA_NEG_INF}, l_r[2] = {0.f, 0.f};
  bf16* conv = reinterpret_cast<bf16*>(mine + ST * L::STAGE);
  float* kscl = reinterpret_cast<float*>(mine + ST * L::STAGE + L::CONV);

  for (int j = 0; j < nmine; ++j) {
    if constexpr (ST == 2) {
      if (j > 0) {
        cp_async_wait<0>();  // tile j landed for this lane's copies
        __syncwarp();        // ... and every lane's; tile j - 1's stage is free
      }
      if (j + 1 < nmine) load_tile(j + 1);  // in flight while tile j computes
    } else if (j > 0) {
      __syncwarp();  // every lane is done with tile j - 1
      load_tile(j);
      cp_async_wait<0>();
      __syncwarp();
    }
    const unsigned char* stage = mine + (j % ST) * L::STAGE;
    const bf16* Kt;
    const bf16* Vt;
    if constexpr (C::QUANT) {
      __syncwarp();  // every lane is done with the previous widened tile
      widen_keys<C, HD, NK>(stage, half + (j % ST) * 2 * NK, conv, kscl, lane, 32);
      __syncwarp();
      Kt = conv;
      Vt = conv + NK * P;
    } else {
      Kt = reinterpret_cast<const bf16*>(stage);
      Vt = Kt + NK * P;
    }
    attend<HD, C::QUANT, NK, PACK>(qf, Kt, Vt, kscl, kscl + NK, c0 + (warp + j * KEY_SETS) * NK,
                                   fr, scale, m_r, l_r, oacc, lane);
  }
  if constexpr (PACK) {  // rows g + 8 held row g's middle part
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      oacc[i][0] += oacc[i][2];
      oacc[i][1] += oacc[i][3];
    }
  }

  // the warps' partials, merged in shared memory in warp order (the global
  // merge's arithmetic): this split's partial, or with one live split the
  // output, with no scratch and no ticket
  __syncthreads();  // every warp is done with its tiles
  float* Ma = reinterpret_cast<float*>(smem + L::Q);
  float2* Mml = reinterpret_cast<float2*>(Ma + KEY_SETS * rows * HD);
#pragma unroll
  for (int h = 0; h < (PACK ? 1 : 2); ++h) {
    const int r = g + 8 * h;
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < DT; ++i)
        *reinterpret_cast<float2*>(Ma + (warp * rows + r) * HD + i * 8 + 2 * t4) =
            make_float2(oacc[i][2 * h], oacc[i][2 * h + 1]);
      if (t4 == 0) Mml[warp * rows + r] = make_float2(m_r[h], l_r[h]);
    }
  }
  __syncthreads();
  const int nent = nsplit + (nsplit + GROUP - 1) / GROUP;
  const size_t nslots = (size_t)gridDim.x * gridDim.y;
  float* part_acc = part;
  float2* part_ml = reinterpret_cast<float2*>(part + nslots * nent * rows * HD);
  const int slot = b * nkv + kvh;
  const size_t base = (size_t)slot * nent * rows;  // (slot, entry 0, row 0)
  for (int item = tid; item < rows * D4; item += TH) {
    const int r = item / D4, d4 = item % D4;
    float M = TVA_NEG_INF, L2 = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < KEY_SETS; ++w) M = fmaxf(M, Mml[w * rows + r].x);
#pragma unroll
    for (int w = 0; w < KEY_SETS; ++w) {
      const float2 ml = Mml[w * rows + r];
      const float4 a = reinterpret_cast<const float4*>(Ma + (w * rows + r) * HD)[d4];
      const float e = __expf(ml.x - M);
      L2 = fmaf(e, ml.y, L2);
      A.x = fmaf(e, a.x, A.x);
      A.y = fmaf(e, a.y, A.y);
      A.z = fmaf(e, a.z, A.z);
      A.w = fmaf(e, a.w, A.w);
    }
    if (live == 1) {
      const float inv = 1.f / (L2 == 0.f ? 1.f : L2);
      bf16* orow = o + ((size_t)b * nq + kvh * group + r) * HD + 4 * d4;
      tva_st(orow + 0, A.x * inv);
      tva_st(orow + 1, A.y * inv);
      tva_st(orow + 2, A.z * inv);
      tva_st(orow + 3, A.w * inv);
    } else {
      const size_t at = base + (size_t)split * rows + r;
      reinterpret_cast<float4*>(part_acc + at * HD)[d4] = A;
      if (d4 == 0) part_ml[at] = make_float2(M, L2);
    }
  }
  if (live == 1) return;
  merge_splits<HD, true>(kv_len, o, part_acc, part_ml, base, tickets, tid, TH, b, 1, S, nq, kvh,
                         group, rows, chunk, split, nsplit, live, slot);
}

// Queries [0, T) of a (B, T) block in launches of at most MAX_ROWS rows
// (whole queries), one after another on the stream: they share the scratch
// and the counters, which each leaves as it found them.
template <int HD, typename TC>
int launch(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
           const int* qpos, const int* table, void* o, float* part, int* tickets, int B, int T,
           int max_blocks, int bs, int nq, int nkv, int chunk, float scale, cudaStream_t stream) {
  const int S = max_blocks * bs, group = nq / nkv;
  const int tn_max = MAX_ROWS / group;
  const int nsplit = (S + chunk - 1) / chunk;
  const int n_tbl = chunk / bs + 2;  // the most entries a split's keys span
  for (int t0 = 0; t0 < T; t0 += tn_max) {
    const int tn = min(tn_max, T - t0);
    const int mt = (tn * group + 15) / 16;
    const size_t smem = layout<HD, TC>(mt, n_tbl).total;
    cudaError_t err = tva_allow_smem(paged_split_kernel<HD, TC>, smem);
    if (err != cudaSuccess) return (int)err;
    const size_t off = (size_t)t0 * nq * HD;
    paged_split_kernel<HD, TC><<<dim3(nkv, B, nsplit), mt * 32, smem, stream>>>(
        (const bf16*)q + off, (const unsigned char*)kc, (const unsigned char*)vc,
        (const bf16*)ksc, (const bf16*)vsc, qpos + t0, table, (bf16*)o + off, part, tickets, T,
        tn, S, bs, max_blocks, nq, nkv, chunk, n_tbl, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int HD, typename TC, bool PACK>
int launch_t1_sets(const void* q, const void* kc, const void* vc, const void* ksc,
                   const void* vsc, const int* kv_len, const int* table, void* o, float* part,
                   int* tickets, int B, int max_blocks, int bs, int nq, int nkv, int chunk,
                   float scale, cudaStream_t stream) {
  const int S = max_blocks * bs;
  const int nsplit = (S + chunk - 1) / chunk;
  const size_t smem = T1<HD, TC>::total(chunk / bs + 2);
  cudaError_t err = tva_allow_smem(paged_t1_kernel<HD, TC, PACK>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_t1_kernel<HD, TC, PACK><<<dim3(nkv, B, nsplit), KEY_SETS * 32, smem, stream>>>(
      (const bf16*)q, (const unsigned char*)kc, (const unsigned char*)vc, (const bf16*)ksc,
      (const bf16*)vsc, kv_len, table, (bf16*)o, part, tickets, S, bs, max_blocks, nq, nkv, chunk,
      scale);
  return (int)cudaGetLastError();
}

// K6 / K8 with bf16 queries: KEY_SETS warps a block on keys, the packed P.V
// at a group of at most 8.
template <int HD, typename TC>
int launch_t1(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
              const int* kv_len, const int* table, void* o, float* part, int* tickets, int B,
              int max_blocks, int bs, int nq, int nkv, int chunk, float scale,
              cudaStream_t stream) {
  if (nq / nkv <= 8)
    return launch_t1_sets<HD, TC, true>(q, kc, vc, ksc, vsc, kv_len, table, o, part, tickets, B,
                                        max_blocks, bs, nq, nkv, chunk, scale, stream);
  return launch_t1_sets<HD, TC, false>(q, kc, vc, ksc, vsc, kv_len, table, o, part, tickets, B,
                                       max_blocks, bs, nq, nkv, chunk, scale, stream);
}

// The operands the body takes: at most MAX_SPLITS whole-tile chunks, scratch
// and counters given.
inline bool bad_shape(int B, int T, int max_blocks, int bs, int nq, int nkv, int chunk,
                      const void* table, const void* part, const void* tickets) {
  if (B <= 0 || T <= 0 || T > MAX_T || max_blocks <= 0 || bs <= 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > MAX_GROUP || chunk <= 0 || chunk % TILE != 0 || table == nullptr ||
      part == nullptr || tickets == nullptr)
    return true;
  return ((long long)max_blocks * bs + chunk - 1) / chunk > MAX_SPLITS;
}

}  // namespace paged
}  // namespace
