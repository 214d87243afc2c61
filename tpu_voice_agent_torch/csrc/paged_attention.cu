// K6 and K7: decode attention through block tables into a paged KV pool
// (L, N, bs, nkv, hd) bf16; q/o bf16 or fp32, arithmetic (sums) in fp32. The
// bodies: paged_split.cuh (bf16 q) and decode_attention.cuh (fp32 q).
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
// pointer and the kernels resolve key rows through the block table, so no
// contiguous copy of a sequence exists, and any block size works (the JAX
// tests use 16, the engine 128). Unused table entries must hold a valid block
// id (0, the trash block); they are never read past the row's frontier.
//
// What bounds them on an H100, and the two bodies:
// - K7 with bf16 queries (every bf16 engine's chain steps): arithmetic. The
//   batched engine's (32, 9) block gives each (row, kv head) 72 query rows
//   against ~1,000 keys, ~9 M multiply-adds a (row, kv head) on fp32 lanes,
//   where the whole call's K/V bytes take ~3 us at the HBM rate. It runs the
//   tensor-core split body of paged_split.cuh: Q.K^T and P.V on mma.sync, the
//   key range split across the card, the table read once a split.
// - K6 with bf16 queries (every fast-forward-0 step of a bf16 engine): the
//   same bytes, 1/9 of the arithmetic, so what bounds it is bringing the
//   tiles in. It runs paged_split.cuh's T = 1 body: the key range split
//   finer across the card (`paged_t1_chunk`), each split's tiles spread
//   over the four warps of a block, the warps' partials merged in order.
// - fp32 queries (the distilled checkpoint's golden phases): the fp32 body of
//   decode_attention.cuh, one block per (kv head, batch row) sharing each K/V
//   tile across the kv head's query rows.
#include "decode_attention.cuh"
#include "paged_split.cuh"

// K6: q (B,nq,hd), the layer's pool plane (N*bs,nkv,hd) for k and v, block
// tables (B,max_blocks) int32, kv_len (B,) int32; q and o of one dtype. bf16
// q: the split body at T = 1, `chunk` keys a split (a multiple of 64, at most
// 64 splits), `part` fp32 scratch of B * nkv * (splits + ceil(splits / 8)) *
// group * (hd + 2) floats and `tickets` B * nkv * 9 int32 counters, all 0
// (left 0); fp32 q takes none of them.
extern "C" int tva_paged_attention(const void* q, const void* kc, const void* vc,
                                   const int* table, const int* kv_len, void* o, void* part,
                                   void* tickets, int B, int max_blocks, int bs, int nq, int nkv,
                                   int hd, int chunk, float scale, int dtype, void* stream) {
  if (max_blocks <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == TVA_DTYPE_F32)
    return dispatch(q, kc, vc, kv_len, nullptr, table, bs, o, B, 1, max_blocks * bs, nq, nkv,
                    hd, scale, stream);
  if (dtype != TVA_DTYPE_BF16 ||
      paged::bad_shape(B, 1, max_blocks, bs, nq, nkv, chunk, table, part, tickets))
    return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return paged::launch_t1<HD, __nv_bfloat16>(
                             q, kc, vc, nullptr, nullptr, kv_len, table, o, (float*)part,
                             (int*)tickets, B, max_blocks, bs, nq, nkv, chunk, scale,
                             (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}

// K7: q (B,T,nq,hd), the layer's pool plane, block tables (B,max_blocks),
// q_positions (B,T) int32. bf16 q: the split body, with `chunk` keys a
// split (a multiple of 64, at most 64 splits), `part` fp32 scratch of
// B * nkv * (splits + ceil(splits / 8)) * min(T, 128 / group) * group * (hd + 2)
// floats and `tickets` B * nkv * 9 int32 counters, all 0 (left 0); fp32 q
// takes none of them.
extern "C" int tva_paged_block_attention(const void* q, const void* kc, const void* vc,
                                         const int* table, const int* q_positions, void* o,
                                         void* part, void* tickets, int B, int T, int max_blocks,
                                         int bs, int nq, int nkv, int hd, int chunk, float scale,
                                         int dtype, void* stream) {
  if (max_blocks <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == TVA_DTYPE_F32)
    return dispatch(q, kc, vc, nullptr, q_positions, table, bs, o, B, T, max_blocks * bs, nq,
                    nkv, hd, scale, stream);
  if (dtype != TVA_DTYPE_BF16 ||
      paged::bad_shape(B, T, max_blocks, bs, nq, nkv, chunk, table, part, tickets))
    return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return paged::launch<HD, __nv_bfloat16>(
                             q, kc, vc, nullptr, nullptr, q_positions, table, o, (float*)part,
                             (int*)tickets, B, T, max_blocks, bs, nq, nkv, chunk, scale,
                             (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;
}
