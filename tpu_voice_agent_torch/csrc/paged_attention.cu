// K6 and K7: decode attention through block tables into a paged KV pool
// (L, N, bs, nkv, hd) bf16; q/o bf16 or fp32, arithmetic in fp32. The template
// body is in decode_attention.cuh (PAGED = true).
//
// Replaces: tpu_voice_agent/ops/paged_attention.py
//   K6 `paged_attention` (`_paged_kernel`; pallas_call at :147): one query
//      token per row over one layer plane of the pool, keys [0, kv_len[b]);
//      key position p of row b lives at pool block table[b, p / bs], offset
//      p % bs. Every T = 1 decode step of the batched paged engine.
//   K7 `paged_block_attention` (`_paged_block_kernel`; pallas_call at :644):
//      T <= 16 queries per row, query i sees positions [0, q_positions[b, i]]
//      (unordered, possibly repeated); tiles past the row's largest position
//      are skipped. Every fast-forward chain step, a (B, 1 + W) block.
// The TPU picked the layer plane by a scalar-prefetched index and each pool
// block by the BlockSpec index map; here the wrapper passes the plane's own
// pointer and the tile loader resolves each key row through the block table,
// so no contiguous copy of a sequence exists. The lookup is per key row, so
// any block size works (the JAX tests use 16, the engine 128). Unused table
// entries must hold a valid block id (0, the trash block); they are never
// read past the row's frontier.
//
// What bounds it on an H100: the batched engine's B = 32 rows give 128
// blocks of one (row, kv head) each, about one wave on 132 SMs. K6's block
// reads ~0.23 MB of K/V at ~900 keys and is bound by load latency; K7's does
// 72 query rows x ~1,000 keys x 64 x 2 FMAs on one SM's fp32 lanes. Every row
// re-reads the shared prompt prefix's blocks (6 blocks of 128 at the 879-token
// prefix: 32 x the same bytes per kv head). The design (decode_attention.cuh)
// shares each K/V tile across the group x T query rows of a kv head; reading
// a shared prefix block once per kv head across rows, and resolving the table
// once per tile, are later work.
#include "decode_attention.cuh"

// K6: q (B,nq,hd), the layer's pool plane (N*bs,nkv,hd) for k and v, block
// tables (B,max_blocks) int32, kv_len (B,) int32; q and o of one dtype.
extern "C" int tva_paged_attention(const void* q, const void* kc, const void* vc,
                                   const int* table, const int* kv_len, void* o, int B,
                                   int max_blocks, int bs, int nq, int nkv, int hd, float scale,
                                   int dtype, void* stream) {
  if (max_blocks <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, kc, vc, kv_len, nullptr, table, bs, o, B, 1, max_blocks * bs, nq, nkv,
                        hd, scale, dtype, stream);
}

// K7: q (B,T,nq,hd), the layer's pool plane, block tables (B,max_blocks),
// q_positions (B,T) int32.
extern "C" int tva_paged_block_attention(const void* q, const void* kc, const void* vc,
                                         const int* table, const int* q_positions, void* o,
                                         int B, int T, int max_blocks, int bs, int nq, int nkv,
                                         int hd, float scale, int dtype, void* stream) {
  if (max_blocks <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, kc, vc, nullptr, q_positions, table, bs, o, B, T, max_blocks * bs, nq,
                        nkv, hd, scale, dtype, stream);
}
