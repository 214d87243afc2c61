// K3, K12 and K2 with fp32 queries over an fp32 cache: decode_split.cuh's
// body at TQ = TC = float, for the entry points of decode_block_attention.cu,
// which check the call first. The long-session planner on fp32 weights (the
// in-repo distilled checkpoint behind BRAIN_BACKEND=planner-distilled) keeps
// its cache in the activations' type, as the JAX planner does: the ring
// prefill writes it so. A source of its own so that it compiles beside the
// other two halves.
//
// Replaces: tpu_voice_agent/ops/decode_attention.py, K3, K12 and K2
// (pallas_call at :542, :458 and :223) over an fp32 cache; see
// decode_block_attention.cu. Bound by bytes as the bf16 cache is, at twice
// its bytes a key.
#include "decode_split.cuh"

// kvlen: K2 (qpos holds kv_len, T = 1), else K3 / K12 (qpos the query
// positions).
int tva_decode_rows_f32kv(bool kvlen, const void* q, const void* kc, const void* vc,
                          const int* qpos, void* o, float* part, int* tickets, int B, int T,
                          int S, int nq, int nkv, int hd, int chunk, float scale,
                          cudaStream_t st) {
  if (kvlen) {
    TVA_DISPATCH_HD(hd, return launch_rows<HD, float, float, true>(q, kc, vc, nullptr, nullptr,
                                                                   qpos, o, part, tickets, B, T,
                                                                   S, nq, nkv, chunk, scale,
                                                                   st));
  }
  TVA_DISPATCH_HD(hd, return launch_rows<HD, float, float, false>(q, kc, vc, nullptr, nullptr,
                                                                  qpos, o, part, tickets, B, T,
                                                                  S, nq, nkv, chunk, scale, st));
  return (int)cudaErrorInvalidValue;
}
