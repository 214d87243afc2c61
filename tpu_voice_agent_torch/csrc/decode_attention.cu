// K2 and K5: decode attention against a dense KV cache, one query token per
// row; the template body is in decode_attention.cuh. K3 and K12 (a block of
// T <= 16 queries) moved to decode_block_attention.cu, which splits the key
// range across the card.
//
// Replaces: tpu_voice_agent/ops/decode_attention.py
//   K5 `decode_attention` (`_decode_kernel`, stacked=False; pallas_call at
//      :133): one query token per row over a flat (B, S, nkv, hd) cache, keys
//      [0, kv_len[b]). The Whisper decoder's self-attention (kv_len =
//      frontier + 1) and cross-attention (kv_len = encoder frames) on every
//      T = 1 step.
//   K2 `decode_attention_layer` (`_decode_kernel`, stacked=True; pallas_call
//      at :223): the same on one layer plane of the stacked cache.
// The JAX package serves K5 and K2 from one kernel body (`stacked=`); here one
// template body serves both. The TPU picked K2's layer plane by a
// scalar-prefetched index; in eager PyTorch the wrapper passes the plane's own
// pointer (`cache[layer]` is a free contiguous view), so nothing is copied.
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
// blocks, as decode_block_attention.cu does for K3, is the next step here.
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
