// K3, K12 and K2: T <= 16 query tokens per batch row (K2: one) against a
// dense bf16 KV cache, with the key range split across the card
// (flash-decoding). The body is decode_split.cuh's, at one warp set.
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
// MFLOP; K2's T = 1 step reads the same K/V for 8 query rows a kv head. One
// block per (kv head, batch row) would leave 4 blocks on 132 SMs at B = 1,
// so the split-key body of decode_split.cuh spreads the keys across the
// card; what is left is the latency of one split's few tiles and of the
// two-level merge (a split of 32 keys at tinyllama's single row).
#include "decode_split.cuh"

namespace {

template <bool KVLEN>
int dispatch(const void* q, const void* kc, const void* vc, const int* qpos, void* o, void* part,
             void* tickets, int B, int T, int S, int nq, int nkv, int hd, int chunk, float scale,
             int dtype, void* stream) {
  if (bad_split(B, T, S, nq, nkv, chunk, part, tickets) || (KVLEN && T != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* pp = (float*)part;
  int* tk = (int*)tickets;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch_rows<HD, float, bf16, KVLEN>(
                           q, kc, vc, nullptr, nullptr, qpos, o, pp, tk, B, T, S, nq, nkv, chunk,
                           scale, st));
  }
  if (dtype != TVA_DTYPE_BF16) return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return launch_rows<HD, bf16, bf16, KVLEN>(q, kc, vc, nullptr, nullptr, qpos,
                                                               o, pp, tk, B, T, S, nq, nkv, chunk,
                                                               scale, st));
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
