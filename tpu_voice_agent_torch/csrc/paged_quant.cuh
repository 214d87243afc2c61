// The bodies of K8 and K9 (paged_attention_quant.cu) at one width of the
// quantized pool, TC = QInt8 or QInt4: bf16 queries run the tensor-core split
// body of paged_split.cuh (K8 its T = 1 kernel), fp32 queries the fp32 body
// of decode_attention.cuh with kv_chunk.cuh's quantized loader. Each width is
// instantiated by its own source (paged_attention_quant.cu: int8,
// paged_attention_quant_int4.cu: int4), so the two compile in parallel.
#pragma once

#include "decode_attention.cuh"
#include "paged_split.cuh"

// One K8 / K9 call, already checked by the entry point: q (B,T,nq,hd) (K8:
// T = 1), the layer's pool planes and their bf16 scale planes, the block
// tables, kv_len (K8) or q_positions (K9, kv_len null), o; bf16 q's split
// `chunk`, `part` and `tickets`.
struct TvaPagedQuant {
  const void *q, *kc, *vc, *ksc, *vsc;
  const int *table, *kv_len, *q_positions;
  void *o, *part, *tickets;
  int B, T, max_blocks, bs, nq, nkv, hd, chunk, dtype;
  float scale;
  cudaStream_t stream;
};

namespace {

// the head dims the quantized kernels are built for: 32 (test-tiny), 48 (the
// distilled checkpoint), 64 (tinyllama-1.1b) and 128 (llama3-8b, llama3-70b,
// mixtral-8x7b)
template <typename TC>
int paged_quant(const TvaPagedQuant& a) {
  if (a.dtype == TVA_DTYPE_F32)
    return dispatch_quant_hd<TC>(a.q, a.kc, a.vc, a.ksc, a.vsc, a.kv_len, a.q_positions,
                                 a.table, a.bs, a.o, a.B, a.T, a.max_blocks * a.bs, a.nq, a.nkv,
                                 a.hd, a.scale, a.stream);
#define TVA_PAGED_QUANT_HD(H)                                                                    \
  case H:                                                                                       \
    if (a.kv_len != nullptr)                                                                    \
      return paged::launch_t1<H, TC>(a.q, a.kc, a.vc, a.ksc, a.vsc, a.kv_len, a.table, a.o,     \
                                     (float*)a.part, (int*)a.tickets, a.B, a.max_blocks, a.bs, \
                                     a.nq, a.nkv, a.chunk, a.scale, a.stream);                 \
    return paged::launch<H, TC>(a.q, a.kc, a.vc, a.ksc, a.vsc, a.q_positions, a.table, a.o,     \
                                (float*)a.part, (int*)a.tickets, a.B, a.T, a.max_blocks, a.bs,  \
                                a.nq, a.nkv, a.chunk, a.scale, a.stream);
  switch (a.hd) {
    TVA_PAGED_QUANT_HD(32)
    TVA_PAGED_QUANT_HD(48)
    TVA_PAGED_QUANT_HD(64)
    TVA_PAGED_QUANT_HD(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TVA_PAGED_QUANT_HD
}

}  // namespace
