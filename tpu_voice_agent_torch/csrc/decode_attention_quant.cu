// K10: T = 1 decode attention against a dense quantized KV cache: values
// (B, S, nkv, hdp) int8, hdp = hd (int8) or hd / 2 (two int4 values a byte),
// bf16 scales (B, S, nkv); q/o bf16 or fp32, arithmetic in fp32. The
// template body is in decode_attention.cuh (PAGED = false, the quantized
// tile loader that K8 and K9 use).
//
// Replaces: tpu_voice_agent/ops/decode_attention.py `decode_attention_quant`
// (`_decode_kernel_quant`; pallas_call at :722): K5 over the quantized
// cache, keys [0, kv_len[b]). In the JAX package no engine calls it; its
// body shares the packed-dot arithmetic of the paged kernels, and here it
// is the dense instantiation of their loader.
//
// What bounds it on an H100: as K2 at B = 1, one block per (kv head, row),
// so load latency and one SM's fp32 lanes, not the card's memory rate; the
// cache moves 66 (int8) or 34 (int4) bytes per (position, kv head) in place
// of bf16's 128.
#include "decode_attention.cuh"

// K10: q (B,nq,hd), k/v values (B,S,nkv,hdp) int8, k/v scales (B,S,nkv)
// bf16, kv_len (B,) int32; bits 8 or 4; q and o of one dtype. A group of at
// most 16 leaves one query row per warp (RW = 1).
extern "C" int tva_decode_attention_quant(const void* q, const void* kc, const void* vc,
                                          const void* ksc, const void* vsc, const int* kv_len,
                                          void* o, int B, int S, int nq, int nkv, int hd,
                                          float scale, int bits, int dtype, void* stream) {
  return dispatch_quant<false, true>(q, kc, vc, ksc, vsc, kv_len, nullptr, nullptr, 1, o, B, 1,
                                     S, nq, nkv, hd, scale, bits, dtype, stream);
}
