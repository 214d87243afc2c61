// K8 and K9: decode attention through block tables into the quantized paged
// KV pool (KV_QUANT=int8|int4): values (L, N, bs, nkv, hdp) int8, hdp = hd
// (int8) or hd / 2 (two int4 values a byte), with bf16 scale planes
// (L, N, bs, nkv) indexed like the pool; q/o bf16 or fp32, sums in fp32. The
// bodies: paged_split.cuh (bf16 q) and decode_attention.cuh with the
// quantized tile loader of kv_chunk.cuh (fp32 q).
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
// halves (`_qk_dot` / `_pv_dot`, :168-207).
// - K9 with bf16 queries (the bf16 engines under KV_QUANT) runs the
//   tensor-core split body of paged_split.cuh, which keeps that fold: the
//   stored integers widened to bf16 (exact) in the products, each key's
//   scale on its score column after Q.K^T and on its probability column
//   before P.V. What bounds it on an H100 is arithmetic, as K7's; the pool
//   moves 66 (int8) or 34 (int4) bytes per (position, kv head) in place of
//   bf16's 128 at hd 64, and 130 or 66 in place of 256 at hd 128.
// - K8 with bf16 queries (every fast-forward-0 step under KV_QUANT) runs the
//   same body's T = 1 kernel, as K6 does: the key range split finer across
//   the card, a split's tiles spread over four warps, each warp widening its
//   own tile's integers once, the same fold.
// - fp32 queries (the distilled checkpoint) run the fp32 body of
//   decode_attention.cuh: its loader widens int * scale into the fp32 tile,
//   which is exact, so they equal the plain versions' fp32 dequantization up
//   to fp32 summation order; the int4 loader writes the low nibbles of a byte
//   run to dims [0, hd/2) and the high nibbles to [hd/2, hd).
// The bodies at one pool width are paged_quant.cuh's `paged_quant<TC>`. This
// source builds the int8 pool's and checks every call; the int4 pool's build
// in paged_attention_quant_int4.cu, beside it (nvcc compiles a source on one
// core, and the widths were the longest compile of the library).
#include "paged_quant.cuh"

// the int4 pool's bodies (paged_attention_quant_int4.cu)
int tva_paged_quant_int4(const TvaPagedQuant& a);

namespace {

// The checks of a K8 / K9 call, then its body at the pool's width (`bits` 8
// or 4). bf16 q: `chunk`, `part` and `tickets` as K6's / K7's; the scale
// planes 4-byte aligned.
int paged_quant_call(const TvaPagedQuant& a, int bits) {
  if (a.max_blocks <= 0 || a.table == nullptr || a.ksc == nullptr || a.vsc == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.dtype == TVA_DTYPE_F32) {
    if (bad_shape(a.B, a.T, a.max_blocks * a.bs, a.nq, a.nkv, a.bs, a.table))
      return (int)cudaErrorInvalidValue;
  } else if (a.dtype != TVA_DTYPE_BF16 ||
             paged::bad_shape(a.B, a.T, a.max_blocks, a.bs, a.nq, a.nkv, a.chunk, a.table, a.part,
                              a.tickets)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bits == 8) return paged_quant<QInt8>(a);
  if (bits == 4) return tva_paged_quant_int4(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K8: q (B,nq,hd), the layer's pool planes (N*bs,nkv,hdp) int8 for k and v
// and their scale planes (N*bs,nkv) bf16, block tables (B,max_blocks)
// int32, kv_len (B,) int32; bits 8 or 4; q and o of one dtype. bf16 q:
// `chunk`, `part` and `tickets` as K6's; the scale planes 4-byte aligned.
extern "C" int tva_paged_attention_quant(const void* q, const void* kc, const void* vc,
                                         const void* ksc, const void* vsc, const int* table,
                                         const int* kv_len, void* o, void* part, void* tickets,
                                         int B, int max_blocks, int bs, int nq, int nkv, int hd,
                                         int chunk, float scale, int bits, int dtype,
                                         void* stream) {
  const TvaPagedQuant a{q, kc, vc, ksc, vsc, table, kv_len, nullptr, o, part, tickets, B, 1,
                        max_blocks, bs, nq, nkv, hd, chunk, dtype, scale, (cudaStream_t)stream};
  return paged_quant_call(a, bits);
}

// K9: q (B,T,nq,hd), the layer's pool and scale planes, block tables
// (B,max_blocks), q_positions (B,T) int32; bits 8 or 4. bf16 q: `chunk`,
// `part` and `tickets` as K7's; the scale planes 4-byte aligned.
extern "C" int tva_paged_block_attention_quant(const void* q, const void* kc, const void* vc,
                                               const void* ksc, const void* vsc,
                                               const int* table, const int* q_positions, void* o,
                                               void* part, void* tickets, int B, int T,
                                               int max_blocks, int bs, int nq, int nkv, int hd,
                                               int chunk, float scale, int bits, int dtype,
                                               void* stream) {
  const TvaPagedQuant a{q, kc, vc, ksc, vsc, table, nullptr, q_positions, o, part, tickets, B,
                        T, max_blocks, bs, nq, nkv, hd, chunk, dtype, scale,
                        (cudaStream_t)stream};
  return paged_quant_call(a, bits);
}
