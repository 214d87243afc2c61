// K3, K12 and K2 with fp32 queries (the distilled checkpoint, the fp32
// twins): decode_split.cuh's body at TQ = float over the bf16 cache, for the
// entry points of decode_block_attention.cu, which check the call first. A
// source of its own so that it compiles beside the bf16-query half (nvcc
// compiles a source on one core).
//
// Replaces: tpu_voice_agent/ops/decode_attention.py, K3, K12 and K2
// (pallas_call at :542, :458 and :223) on fp32 activations; see
// decode_block_attention.cu.
#include "decode_split.cuh"

// kvlen: K2 (qpos holds kv_len, T = 1), else K3 / K12 (qpos the query
// positions).
int tva_decode_rows_f32(bool kvlen, const void* q, const void* kc, const void* vc,
                        const int* qpos, void* o, float* part, int* tickets, int B, int T, int S,
                        int nq, int nkv, int hd, int chunk, float scale, cudaStream_t st) {
  if (kvlen) {
    TVA_DISPATCH_HD(hd, return launch_rows<HD, float, bf16, true>(q, kc, vc, nullptr, nullptr,
                                                                  qpos, o, part, tickets, B, T, S,
                                                                  nq, nkv, chunk, scale, st));
  }
  TVA_DISPATCH_HD(hd, return launch_rows<HD, float, bf16, false>(q, kc, vc, nullptr, nullptr, qpos,
                                                                 o, part, tickets, B, T, S, nq,
                                                                 nkv, chunk, scale, st));
  return (int)cudaErrorInvalidValue;
}
