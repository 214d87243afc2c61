// K2, K3, K5 and K12: decode attention against a dense KV cache; the template
// body is in decode_attention.cuh.
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
//   K12 `decode_block_attention` (`_decode_block_kernel` over a flat cache;
//      pallas_call at :458): K3's function on one flat (B, S, nkv, hd) cache.
//      The JAX package calls it only from its tests; here it is K3's body
//      with the cache's own pointer in place of a layer plane's.
// The JAX package serves K5 and K2 from one kernel body (`stacked=`); here one
// template body serves all three. The TPU picked K2/K3's layer plane by a
// scalar-prefetched index; in eager PyTorch the wrapper passes the plane's own
// pointer (`cache[layer]` is a free contiguous view), so nothing is copied,
// and K12's flat cache is such a plane already.
//
// What bounds it on an H100: at B = 1 the grid is one block per (kv head,
// batch row), 4 blocks on 132 SMs at tinyllama-1.1b and 20 at Whisper
// large-v3 (MHA), so neither the card's memory rate nor its FLOP rate is
// reachable; each block is bound by its own SM's fp32 FMA rate and by load
// latency. A row at context n reads 2 * n * hd * sizeof(TC) bytes of K/V per
// kv head (~0.24 MB at n = 950, hd 64, bf16) and the fast-forward block
// (T = 9, group 8: 72 query rows) does 72 * n * hd * 2 FMAs on it (~8.8 M,
// ~38 us of one SM's 128 fp32 lanes). Whisper's group of 1 leaves one query
// row per block: one warp computes while all 16 stage tiles. What the design
// does about it is in decode_attention.cuh; splitting the key range across
// blocks is the next step.
#include "decode_attention.cuh"

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
    TVA_DISPATCH_HD(hd, return launch<HD, 1, false, float, float>(q, kc, vc, nullptr, nullptr,
                                                                  kv_len, nullptr, nullptr, 1, o,
                                                                  B, 1, S, nq, nkv, scale, st));
  }
  if (dtype == TVA_DTYPE_BF16) {
    TVA_DISPATCH_HD(hd, return launch<HD, 1, false, BF, BF>(q, kc, vc, nullptr, nullptr, kv_len,
                                                            nullptr, nullptr, 1, o, B, 1, S, nq,
                                                            nkv, scale, st));
  }
  return (int)cudaErrorInvalidValue;
}

// K2: q (B,nq,hd), k/v plane (B,S,nkv,hd) of the layer, kv_len (B,) int32;
// q and o of one dtype (TVA_DTYPE_*).
extern "C" int tva_decode_attention_layer(const void* q, const void* kc, const void* vc,
                                          const int* kv_len, void* o, int B, int S, int nq,
                                          int nkv, int hd, float scale, int dtype, void* stream) {
  return dispatch<false>(q, kc, vc, kv_len, nullptr, nullptr, 1, o, B, 1, S, nq, nkv, hd, scale,
                         dtype, stream);
}

// K3: q (B,T,nq,hd), k/v plane (B,S,nkv,hd) of the layer, q_positions (B,T) int32.
extern "C" int tva_decode_block_attention_layer(const void* q, const void* kc, const void* vc,
                                                const int* q_positions, void* o, int B, int T,
                                                int S, int nq, int nkv, int hd, float scale,
                                                int dtype, void* stream) {
  return dispatch<false>(q, kc, vc, nullptr, q_positions, nullptr, 1, o, B, T, S, nq, nkv, hd,
                         scale, dtype, stream);
}

// K12: q (B,T,nq,hd), flat k/v cache (B,S,nkv,hd) bf16, q_positions (B,T) int32.
extern "C" int tva_decode_block_attention(const void* q, const void* kc, const void* vc,
                                          const int* q_positions, void* o, int B, int T, int S,
                                          int nq, int nkv, int hd, float scale, int dtype,
                                          void* stream) {
  return dispatch<false>(q, kc, vc, nullptr, q_positions, nullptr, 1, o, B, T, S, nq, nkv, hd,
                         scale, dtype, stream);
}
