// K8 and K9 over the int4 pool (KV_QUANT=int4): paged_quant.cuh's bodies at
// QInt4, for the entry points of paged_attention_quant.cu, which check the
// call first. A source of its own so that it compiles beside the int8 pool's
// (nvcc compiles a source on one core).
//
// Replaces: tpu_voice_agent/ops/paged_attention.py, K8 and K9 (pallas_call
// at :333 and :834) at `bits=4`; see paged_attention_quant.cu.
#include "paged_quant.cuh"

int tva_paged_quant_int4(const TvaPagedQuant& a) { return paged_quant<QInt4>(a); }
