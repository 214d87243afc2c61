// K5: decode attention against a flat KV cache, one query token per row,
// with the key range split across the card: decode_split.cuh's body at
// T = 1 (KVLEN) on a bf16 or fp32 cache.
//
// Replaces: tpu_voice_agent/ops/decode_attention.py
//   K5 `decode_attention` (`_decode_kernel`, stacked=False; pallas_call at
//      :133): one query token per row over a flat (B, S, nkv, hd) cache, keys
//      [0, kv_len[b]). The Whisper decoder's self-attention (kv_len =
//      frontier + 1) and cross-attention (kv_len = encoder frames) on every
//      T = 1 step, 64 launches a large-v3 step.
// The JAX package serves K5 and K2 (`decode_attention_layer`) from one kernel
// body (`stacked=`); here both run the split body, K2 from
// decode_block_attention.cu.
//
// What bounds it on an H100: a row at context n reads 2 * n * hd *
// sizeof(TC) bytes of K/V per kv head, 2.56 MB at large-v3's
// cross-attention (20 heads of 64, n = 500: 0.8 us at 3.35 TB/s), and does
// 4 n hd FLOP a head. One block per (kv head, batch row) gave 20 blocks on
// 132 SMs, each walking 16 tiles on one warp (Whisper's group of 1 leaves
// one query row a kv head). Split, the cross-attention runs 160 blocks of
// 64 keys; the self-attention's 33 of 448 keys and the incremental buffer's
// 75 of 1500 fall in one split a head, which then writes the output itself
// (no scratch, no ticket). With a group of at most 2, the wrapper takes the
// warps-on-keys instantiation (key_sets = KEY_SETS): blocks of 8 warps, two
// an SM, in four sets that take a split's tiles side by side and merge in
// shared memory, so a split's tiles do not run one after another on one
// warp; split 0 loads its first tiles before it reads kv_len. What is left
// is latency: a block's load of its tiles, and at the cross shape the
// group merge.
#include "decode_split.cuh"

// K5: q (B,nq,hd), flat k/v cache (B,S,nkv,hd), kv_len (B,) int32; q, the
// cache and o all of one dtype (TVA_DTYPE_*), q 16-byte aligned. `chunk`,
// `part` and `tickets` as K2's (decode_block_attention.cu); `key_sets` 1, or
// KEY_SETS at a group of at most 2 and a head dim of at most 64.
extern "C" int tva_decode_attention(const void* q, const void* kc, const void* vc,
                                    const int* kv_len, void* o, void* part, void* tickets, int B,
                                    int S, int nq, int nkv, int hd, int chunk, int key_sets,
                                    float scale, int dtype, void* stream) {
  if (bad_split(B, 1, S, nq, nkv, chunk, part, tickets)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* pp = (float*)part;
  int* tk = (int*)tickets;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch_t1<HD, float, float>(q, kc, vc, nullptr, nullptr, kv_len, o,
                                                           pp, tk, B, S, nq, nkv, chunk, key_sets,
                                                           scale, st));
  }
  if (dtype == TVA_DTYPE_BF16) {
    TVA_DISPATCH_HD(hd, return launch_t1<HD, bf16, bf16>(q, kc, vc, nullptr, nullptr, kv_len, o,
                                                         pp, tk, B, S, nq, nkv, chunk, key_sets,
                                                         scale, st));
  }
  return (int)cudaErrorInvalidValue;
}
