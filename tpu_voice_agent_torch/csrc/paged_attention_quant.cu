// K8 and K9: decode attention through block tables into the quantized paged
// KV pool (KV_QUANT=int8|int4): values (L, N, bs, nkv, hdp) int8, hdp = hd
// (int8) or hd / 2 (two int4 values a byte), with bf16 scale planes
// (L, N, bs, nkv) indexed like the pool; q/o bf16 or fp32, arithmetic in
// fp32. The template body is in decode_attention.cuh (PAGED = true, the
// quantized tile loader).
//
// Replaces: tpu_voice_agent/ops/paged_attention.py
//   K8 `paged_attention_quant` (`_paged_kernel_quant`; pallas_call at :333):
//      K6 over the quantized pool. Every T = 1 decode step of the batched
//      paged engine under KV_QUANT (fast-forward 0).
//   K9 `paged_block_attention_quant` (`_paged_block_kernel_quant`;
//      pallas_call at :834): K7 over the quantized pool, per-query
//      frontiers. Every fast-forward chain step under KV_QUANT, a (B, 1 + W)
//      block.
// The TPU kernels keep the stored integers in the dots and fold each key
// row's scale into the score tile (after q . k_int) and the probability tile
// (before p . v_int), splitting an int4 row's dots into its two nibble
// halves (`_qk_dot` / `_pv_dot`, :168-207). Here the loader widens int *
// scale into the fp32 tile, which is exact, so the kernels equal the plain
// versions' fp32 dequantization up to fp32 summation order; the int4 loader
// writes the low nibbles of a byte run to dims [0, hd/2) and the high
// nibbles to [hd/2, hd).
//
// What bounds it on an H100: as K6 / K7, whose design this is. The pool
// moves 66 (int8) or 34 (int4) bytes per (position, kv head) in place of
// bf16's 128, so the bytes bound falls by those ratios; the kernels stay
// bound by load latency (K8) and by one SM's fp32 FMA rate (K9), as K6 and
// K7 are. Reading the scales costs one 2-byte load per 16-value chunk.
#include "decode_attention.cuh"

// K8: q (B,nq,hd), the layer's pool planes (N*bs,nkv,hdp) int8 for k and v
// and their scale planes (N*bs,nkv) bf16, block tables (B,max_blocks)
// int32, kv_len (B,) int32; bits 8 or 4; q and o of one dtype.
extern "C" int tva_paged_attention_quant(const void* q, const void* kc, const void* vc,
                                         const void* ksc, const void* vsc, const int* table,
                                         const int* kv_len, void* o, int B, int max_blocks,
                                         int bs, int nq, int nkv, int hd, float scale, int bits,
                                         int dtype, void* stream) {
  if (max_blocks <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_quant<true, false>(q, kc, vc, ksc, vsc, kv_len, nullptr, table, bs, o, B, 1,
                                     max_blocks * bs, nq, nkv, hd, scale, bits, dtype, stream);
}

// K9: q (B,T,nq,hd), the layer's pool and scale planes, block tables
// (B,max_blocks), q_positions (B,T) int32; bits 8 or 4.
extern "C" int tva_paged_block_attention_quant(const void* q, const void* kc, const void* vc,
                                               const void* ksc, const void* vsc,
                                               const int* table, const int* q_positions, void* o,
                                               int B, int T, int max_blocks, int bs, int nq,
                                               int nkv, int hd, float scale, int bits, int dtype,
                                               void* stream) {
  if (max_blocks <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_quant<true, false>(q, kc, vc, ksc, vsc, nullptr, q_positions, table, bs, o, B,
                                     T, max_blocks * bs, nq, nkv, hd, scale, bits, dtype, stream);
}
