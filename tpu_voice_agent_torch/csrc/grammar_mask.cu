// K4: fused grammar mask -> argmax -> FSM advance, and K11: grammar mask ->
// argmax; one warp per row, one template body (ADVANCE true for K4).
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
// What bounds it on an H100: latency. Per row it reads V logits (4 B), one
// V-byte mask row and (K4) V class ids and the state's C-int table row, and
// writes two ints: ~4 KB at the intent grammar's V = 619, C = 310, a
// nanosecond of device memory time. So the launch and the chain of dependent
// memory reads set its time. That grammar's tables (35,449 states: a 21.9 MB
// mask and a 44 MB table) exceed the 50 MB L2, and a decoding row moves to a
// new state every step, so each dependent read may be a trip to HBM.
// Its design:
// - one warp per row, several rows a block (the host picks the rows a block
//   from R: ops/grammar_mask.py argmax_geometry); no shared-memory pass and
//   no __syncthreads.
// - lane l takes elements l, l+32, ... and starts all its loads before its
//   first compare: the logits and (K4) the class ids, which do not depend on
//   the state, beside the state; once the state is in, (K4) its table row by
//   cp.async into shared memory and its mask row. So one dependent hop
//   follows the state, and none waits on the reduction.
// - V up to MAX_PER_LANE * 32 takes a fully unrolled count a lane (N, a
//   multiple of 4 picked on the host); past it a strided loop of UNROLL loads
//   a lane in flight. Every load is bounded by V (the last state's mask row
//   ends its allocation) and the table row by C.
// - each lane keeps its first best (strict >), then a shuffle tree reduces
//   (value desc, index asc) and carries K4's class with the pick, as the TPU
//   kernel carries tile_cls. K4 reads nothing from global memory after the
//   reduction: lane 0 writes the token and table_row[class].
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ROWS = 8;       // warps (rows) a block at most
constexpr int MAX_PER_LANE = 24;  // the unrolled path's elements a lane: V <= 768
constexpr int UNROLL = 8;         // the strided loop's loads of each kind in flight a lane

// (value desc, index asc). Strict: NaN never wins, an equal pair stays.
__device__ __forceinline__ bool beats(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

// No "memory" clobber, so the logits' loads need not wait behind the copies
// (the wait before the table row is read orders memory).
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// K4: the state's table row into this warp's shared slot, no registers held.
// Unrolled: a plain loop's serial branches hold back the loads behind it, and
// fetching the row ahead then costs more than reading one entry after the
// reduction.
__device__ __forceinline__ void fetch_table_row(int* trow, const int* row, int C, int lane) {
#pragma unroll 4
  for (int j = lane; j < C; j += 32) cp_async4(trow + j, row + j);
}

// A batch of K elements of one lane (v = base + 32 k): every load started, then
// the compares in index order, keeping the first best.
template <bool ADVANCE, int K>
__device__ __forceinline__ void scan(const float* __restrict__ lrow,
                                     const unsigned char* __restrict__ mrow,
                                     const int* __restrict__ col_id, int base, int V,
                                     float& best, int& idx, int& cls) {
  float x[K];
  int c[K];
  unsigned char m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = base + 32 * k;
    x[k] = v < V ? lrow[v] : -INFINITY;
    if constexpr (ADVANCE) c[k] = v < V ? col_id[v] : 0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = base + 32 * k;
    m[k] = v < V ? mrow[v] : 0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = base + 32 * k;
    const float s = m[k] ? x[k] : TVA_NEG_INF;
    if (v < V && s > best) {
      best = s;
      idx = v;
      if constexpr (ADVANCE) cls = c[k];
    }
  }
}

// N > 0: V <= 32 N, one unrolled batch; N == 0: the strided loop.
template <bool ADVANCE, int N>
__global__ void __launch_bounds__(MAX_ROWS * 32)
argmax_warp_kernel(const float* __restrict__ logits, const int* __restrict__ state,
                   const unsigned char* __restrict__ mask, const int* __restrict__ table,
                   const int* __restrict__ col_id, int* __restrict__ tok_out,
                   int* __restrict__ next_out, int R, int V, int C) {
  extern __shared__ int trows[];  // K4: one C-int table row a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;  // the whole warp: nothing below syncs the block
  const int st = max(state[r], 0);
  const float* lrow = logits + (size_t)r * V;
  const unsigned char* mrow = mask + (size_t)st * V;
  int* trow = trows + warp * C;

  float best = -INFINITY;
  int idx = INT_MAX, cls = 0;
  int cls0 = 0;  // K4: token 0's class, the pick when no entry beat -inf
  if constexpr (ADVANCE) {
    if (lane == 0) cls0 = col_id[0];
    fetch_table_row(trow, table + (size_t)st * C, C, lane);
  }
  if constexpr (N > 0) {
    scan<ADVANCE, N>(lrow, mrow, col_id, lane, V, best, idx, cls);
  } else {
    for (int base = lane; base < V; base += 32 * UNROLL)
      scan<ADVANCE, UNROLL>(lrow, mrow, col_id, base, V, best, idx, cls);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, idx, o);
    int oc = 0;
    if constexpr (ADVANCE) oc = __shfl_xor_sync(FULL, cls, o);
    if (beats(ov, oi, best, idx)) {
      best = ov;
      idx = oi;
      if constexpr (ADVANCE) cls = oc;
    }
  }
  if constexpr (ADVANCE) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();  // every lane's part of the table row lands before lane 0 reads it
  }
  if (lane == 0) {
    const bool none = idx == INT_MAX;  // every entry legal and -inf (or NaN): token 0
    tok_out[r] = none ? 0 : idx;
    if constexpr (ADVANCE) next_out[r] = trow[none ? cls0 : cls];
  }
}

template <bool ADVANCE>
int launch(const float* logits, const int* state, const unsigned char* mask, const int* table,
           const int* col_id, int* tok, int* next, int R, int V, int C, int rows, int per_lane,
           cudaStream_t stream) {
  if (R <= 0 || V <= 0 || (ADVANCE && C <= 0) || rows < 1 || rows > MAX_ROWS ||
      per_lane < 0 || per_lane > MAX_PER_LANE || per_lane % 4 != 0 ||
      (per_lane > 0 && 32 * per_lane < V))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ADVANCE ? (size_t)rows * C * sizeof(int) : 0;
  const dim3 grid((R + rows - 1) / rows), block(rows * 32);
  auto go = [&](auto kernel) {
    const cudaError_t e = tva_allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, block, smem, stream>>>(logits, state, mask, table, col_id, tok, next, R, V,
                                          C);
    return (int)cudaGetLastError();
  };
  switch (per_lane) {
    case 0: return go(argmax_warp_kernel<ADVANCE, 0>);
    case 4: return go(argmax_warp_kernel<ADVANCE, 4>);
    case 8: return go(argmax_warp_kernel<ADVANCE, 8>);
    case 12: return go(argmax_warp_kernel<ADVANCE, 12>);
    case 16: return go(argmax_warp_kernel<ADVANCE, 16>);
    case 20: return go(argmax_warp_kernel<ADVANCE, 20>);
    default: return go(argmax_warp_kernel<ADVANCE, 24>);
  }
}

}  // namespace

// logits (B,V) f32, state (B,) int32, mask (S,V) bool, table (S,C) int32,
// col_id (V,) int32 -> tok (B,), next (B,) int32; rows a block and the
// elements a lane (0: the strided loop) from ops/grammar_mask.py
// argmax_geometry.
extern "C" int tva_masked_argmax_advance(const float* logits, const int* state,
                                         const unsigned char* mask, const int* table,
                                         const int* col_id, int* tok, int* next, int B, int V,
                                         int C, int rows, int per_lane, void* stream) {
  return launch<true>(logits, state, mask, table, col_id, tok, next, B, V, C, rows, per_lane,
                      (cudaStream_t)stream);
}

// K11: logits (R,V) f32, state (R,) int32, mask (S,V) bool -> tok (R,) int32.
extern "C" int tva_masked_argmax(const float* logits, const int* state,
                                 const unsigned char* mask, int* tok, int R, int V, int rows,
                                 int per_lane, void* stream) {
  return launch<false>(logits, state, mask, nullptr, nullptr, tok, nullptr, R, V, 0, rows,
                       per_lane, (cudaStream_t)stream);
}
