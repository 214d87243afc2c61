// K5: decode attention against a flat KV cache, one query token per row; the
// template body is in decode_attention.cuh. K3 and K12 (a block of T <= 16
// queries) and K2 (T = 1 over a layer plane of the stacked cache) moved to
// decode_block_attention.cu, which splits the key range across the card.
//
// Replaces: tpu_voice_agent/ops/decode_attention.py
//   K5 `decode_attention` (`_decode_kernel`, stacked=False; pallas_call at
//      :133): one query token per row over a flat (B, S, nkv, hd) cache, keys
//      [0, kv_len[b]). The Whisper decoder's self-attention (kv_len =
//      frontier + 1) and cross-attention (kv_len = encoder frames) on every
//      T = 1 step.
// The JAX package serves K5 and K2 (`decode_attention_layer`) from one kernel
// body (`stacked=`); here K2 runs decode_block_attention.cu's split body.
//
// What bounds it on an H100: at B = 1 the grid is one block per (kv head,
// batch row), 20 blocks on 132 SMs at Whisper large-v3 (MHA), so neither the
// card's memory rate nor its FLOP rate is reachable; each block is bound by
// its own SM's fp32 FMA rate and by load latency. A row at context n reads
// 2 * n * hd * sizeof(TC) bytes of K/V per kv head. Whisper's group of 1
// leaves one query row per block: one warp computes while all 16 stage
// tiles. What the design does about it is in decode_attention.cuh;
// splitting the key range across blocks, as decode_block_attention.cu does
// for K2 and K3, is the next step here.
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
