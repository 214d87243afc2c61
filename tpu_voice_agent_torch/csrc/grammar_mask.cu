// K4: fused grammar mask -> argmax -> FSM advance, and K11: grammar mask ->
// argmax; one block per row, one template body (ADVANCE true for K4).
//
// Replaces: tpu_voice_agent/ops/grammar_mask.py
//   K4 `masked_argmax_advance` (`_argmax_advance_kernel`, pallas_call at :268);
//   K11 `masked_argmax` (`_argmax_kernel`, pallas_call at :107), which the
//      speculative verify step reaches through `masked_argmax_block` (:319):
//      every (row, draft position) of a (B, 1+K) verify block is one kernel
//      row with its own FSM state, so the block's masked greedy picks are one
//      launch of B * (1+K) rows.
// Same contract for both: the entry state is clamped to >= 0; masked logits
// score -1e30 (so a fully masked row picks token 0, the first -1e30); ties go
// to the first index; K4's next state is table[state, col_id[tok]] (class 0 is
// the all-dead column, so a dead pick advances to -1 for the engine's poison
// gate). NaN logits never win a comparison, so they cannot fault the kernel;
// the poison gate discards the row.
//
// What bounds it on an H100: bytes, and launch latency. Per row it reads V
// logits (4 B) and one V-byte mask row (619 tokens: ~3 KB) and writes two
// ints: ~1 us of device memory traffic, so the launch dominates; K11's verify
// block at B = 32, 1+K = 5 is 160 rows, ~0.5 MB, still below a launch. Its
// design: the state row of the dense mask is read beside the logits by the same
// coalesced loop (the TPU streamed both through scalar-prefetch index maps),
// each thread keeps its first best, a warp shuffle then a shared-memory pass
// reduce (value desc, index asc), and one thread writes the token (K4: after
// its two table reads). Nothing V-sized is written back.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <bool ADVANCE>
__global__ void __launch_bounds__(THREADS)
argmax_kernel(const float* __restrict__ logits, const int* __restrict__ state,
                      const unsigned char* __restrict__ mask, const int* __restrict__ table,
                      const int* __restrict__ col_id, int* __restrict__ tok_out,
                      int* __restrict__ next_out, int V, int C) {
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  const int b = blockIdx.x;
  const int st = max(state[b], 0);
  const float* lrow = logits + (size_t)b * V;
  const unsigned char* mrow = mask + (size_t)st * V;

  float best = -INFINITY;
  int idx = INT_MAX;
  for (int v = threadIdx.x; v < V; v += THREADS) {
    const float x = mrow[v] ? lrow[v] : TVA_NEG_INF;
    if (x > best) {  // strict: keeps this thread's first occurrence
      best = x;
      idx = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    better(best, idx, ov, oi);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) better(best, idx, sv[w], si[w]);
    const int tok = idx == INT_MAX ? 0 : idx;
    tok_out[b] = tok;
    if constexpr (ADVANCE) next_out[b] = table[(size_t)st * C + col_id[tok]];
  }
}

}  // namespace

// logits (B,V) f32, state (B,) int32, mask (S,V) bool, table (S,C) int32,
// col_id (V,) int32 -> tok (B,), next (B,) int32.
extern "C" int tva_masked_argmax_advance(const float* logits, const int* state,
                                         const unsigned char* mask, const int* table,
                                         const int* col_id, int* tok, int* next, int B, int V,
                                         int C, void* stream) {
  if (B <= 0 || V <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  argmax_kernel<true><<<B, THREADS, 0, (cudaStream_t)stream>>>(logits, state, mask, table,
                                                                col_id, tok, next, V, C);
  return (int)cudaGetLastError();
}

// K11: logits (R,V) f32, state (R,) int32, mask (S,V) bool -> tok (R,) int32.
extern "C" int tva_masked_argmax(const float* logits, const int* state,
                                 const unsigned char* mask, int* tok, int R, int V,
                                 void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  argmax_kernel<false><<<R, THREADS, 0, (cudaStream_t)stream>>>(logits, state, mask, nullptr,
                                                                 nullptr, tok, nullptr, V, 0);
  return (int)cudaGetLastError();
}
