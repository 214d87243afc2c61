// K10: T = 1 decode attention against a dense quantized KV cache: values
// (B, S, nkv, hdp) int8, hdp = hd (int8) or hd / 2 (two int4 values a byte),
// bf16 scales (B, S, nkv); q/o bf16 or fp32, arithmetic in fp32. The body
// is decode_split.cuh's at T = 1 (KVLEN), with the quantized loaders of
// kv_chunk.cuh: a tile holds int * scale, exact, so it equals the plain
// version's fp32 dequantization.
//
// Replaces: tpu_voice_agent/ops/decode_attention.py `decode_attention_quant`
// (`_decode_kernel_quant`; pallas_call at :722): K5 over the quantized
// cache, keys [0, kv_len[b]). In the JAX package no engine calls it; its
// body shares the packed-dot arithmetic of the paged kernels.
//
// What bounds it on an H100: bytes, 66 (int8) or 34 (int4) a (position, kv
// head) in place of bf16's 128, and the scales' one 2-byte load per 16-value
// chunk. One block per (kv head, row) gave 4 blocks at tinyllama's B = 1,
// each walking 30 tiles; split, kv_len 944 of a 2048 cache runs 120 blocks
// of one 32-key tile each, so what is left is latency: one tile's load and
// the two-level merge.
#include "decode_split.cuh"

namespace {

template <typename TQ, typename TC>
int dispatch_hd(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc,
                const int* kv_len, void* o, float* part, int* tickets, int B, int S, int nq,
                int nkv, int hd, int chunk, int key_sets, float scale, cudaStream_t st) {
  // the engines' head dims: test-tiny 32, the distilled checkpoint 48,
  // tinyllama-1.1b 64
#define TVA_QUANT_HD(H)                                                                         \
  case H:                                                                                      \
    return launch_t1<H, TQ, TC>(q, kc, vc, ksc, vsc, kv_len, o, part, tickets, B, S, nq, nkv, \
                                chunk, key_sets, scale, st);
  switch (hd) {
    TVA_QUANT_HD(32)
    TVA_QUANT_HD(48)
    TVA_QUANT_HD(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TVA_QUANT_HD
}

}  // namespace

// K10: q (B,nq,hd) 16-byte aligned, k/v values (B,S,nkv,hdp) int8, k/v
// scales (B,S,nkv) bf16, kv_len (B,) int32; bits 8 or 4; q and o of one
// dtype. `chunk`, `part`, `tickets` and `key_sets` as K5's.
extern "C" int tva_decode_attention_quant(const void* q, const void* kc, const void* vc,
                                          const void* ksc, const void* vsc, const int* kv_len,
                                          void* o, void* part, void* tickets, int B, int S,
                                          int nq, int nkv, int hd, int chunk, int key_sets,
                                          float scale, int bits, int dtype, void* stream) {
  if (bad_split(B, 1, S, nq, nkv, chunk, part, tickets) || ksc == nullptr || vsc == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* pp = (float*)part;
  int* tk = (int*)tickets;
#define TVA_QUANT_CALL(TQ, TC)                                                                  \
  return dispatch_hd<TQ, TC>(q, kc, vc, ksc, vsc, kv_len, o, pp, tk, B, S, nq, nkv, hd, chunk, \
                             key_sets, scale, st)
  if (bits == 8 && dtype == TVA_DTYPE_F32) TVA_QUANT_CALL(float, QInt8);
  if (bits == 8 && dtype == TVA_DTYPE_BF16) TVA_QUANT_CALL(bf16, QInt8);
  if (bits == 4 && dtype == TVA_DTYPE_F32) TVA_QUANT_CALL(float, QInt4);
  if (bits == 4 && dtype == TVA_DTYPE_BF16) TVA_QUANT_CALL(bf16, QInt4);
#undef TVA_QUANT_CALL
  return (int)cudaErrorInvalidValue;
}
