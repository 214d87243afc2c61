// The merge of the split-key attention bodies: the dense caches' split body
// (decode_split.cuh: K2, K3, K5, K10, K12) and the paged tensor-core body
// (paged_split.cuh: K7 and K9 with bf16 queries). A block of split `split`
// has written its partials (m, l, acc) to fp32 scratch; it takes a ticket on
// its group's int32 counter (groups of GROUP splits, __threadfence first).
// The last split of a group to arrive merges the group's partials into one
// (M = max m_c, L = sum_c e^(m_c - M) l_c, A = sum_c e^(m_c - M) acc_c, over c
// in order) and takes a ticket on the (batch row, kv head)'s counter; the last
// group merger merges the groups the same way and writes A / L. With one
// group, its merger writes the output. The order of every sum is fixed, so
// the output is the same bits whichever blocks merge and from run to run;
// outputs take no atomics. Each merging block sets back the counter it read,
// so a launch needs no second kernel and no memset.
#pragma once

#include "common.cuh"

namespace {

constexpr int GROUP = 8;  // splits merged by one block, then groups merged by one
// a merge holds at most GROUP entries of an item in registers, so at most
// GROUP groups of GROUP splits
constexpr int MAX_SPLITS = GROUP * GROUP;
constexpr int TICKETS_PER_SLOT = 1 + GROUP;

// Query row t of batch row b sees keys [0, frontier]; a frontier past the
// cache means every slot (keys >= S are never valid). KVLEN (T = 1): `pos`
// is kv_len (B,), so the frontier is kv_len[b] - 1; otherwise it is
// q_positions (B, T).
template <bool KVLEN>
__device__ __forceinline__ int frontier(const int* __restrict__ pos, int b, int T, int t, int S) {
  return min(KVLEN ? pos[b] - 1 : pos[b * T + t], S - 1);
}

// The tickets and merges of one block, after its partials are written.
// Scratch of one launch, fp32: acc [B * nkv][entries][rows][HD], then (m, l)
// [B * nkv][entries][rows]; the entries of a (batch row, kv head) are its
// nsplit splits, then one per group of GROUP splits; `base` is the slot's
// (entry 0, row 0). Query row r is query r / group (stride T of q_positions
// and o) of q head kvh * group + r % group. `live`: the slot's splits that
// hold a key some row sees; a row r reads the partials of the splits
// holding a key it sees, frontier / chunk + 1 of them (none for a negative
// frontier, which writes zeros, as `acc / (l or 1)` gives). TH threads.
template <int HD, bool KVLEN, typename TQ>
__device__ __forceinline__ void merge_splits(const int* __restrict__ qpos, TQ* __restrict__ o,
                                             float* __restrict__ part_acc,
                                             float2* __restrict__ part_ml, size_t base,
                                             int* __restrict__ tickets, int tid, int TH, int b,
                                             int T, int S, int nq, int kvh, int group, int rows,
                                             int chunk, int split, int nsplit, int live,
                                             int slot) {
  constexpr int D4 = HD / 4;
  __shared__ int last;
  auto out_row = [&](int r) {
    return o + ((size_t)(b * T + r / group) * nq + kvh * group + r % group) * HD;
  };

  // The merge of row r's entries first .. first + n - 1, in that order:
  // M = max m, L = sum e^(m - M) l, A = sum e^(m - M) acc. Every thread
  // takes float4s of outputs (item = row, dims 4 d4 .. 4 d4 + 3) and loads
  // an item's (m, l) and acc of all n entries at once. INTO_GROUP writes
  // (M, L, A) to entry nsplit + g; otherwise the output, A / (L or 1).
  auto merge = [&](int first, int g, bool into_group) {
    for (int item = tid; item < rows * D4; item += TH) {
      const int r = item / D4, d4 = item % D4;
      const int p = frontier<KVLEN>(qpos, b, T, r / group, S);
      const int nr = p >= 0 ? p / chunk + 1 : 0;  // splits holding keys row r sees
      const int n = into_group ? min(max(nr - first, 0), GROUP)
                               : (first == nsplit ? (nr + GROUP - 1) / GROUP : nr);
      float2 mlv[GROUP];
      float4 av[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j < n) {
          const size_t at = base + (size_t)(first + j) * rows + r;
          mlv[j] = __ldcg(part_ml + at);
          av[j] = __ldcg(reinterpret_cast<const float4*>(part_acc + at * HD) + d4);
        }
      }
      float M = TVA_NEG_INF, L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (j < n) M = fmaxf(M, mlv[j].x);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j < n) {
          const float e = __expf(mlv[j].x - M);
          L = fmaf(e, mlv[j].y, L);
          A.x = fmaf(e, av[j].x, A.x);
          A.y = fmaf(e, av[j].y, A.y);
          A.z = fmaf(e, av[j].z, A.z);
          A.w = fmaf(e, av[j].w, A.w);
        }
      }
      if (into_group) {
        if (n > 0) {
          const size_t at = base + (size_t)(nsplit + g) * rows + r;
          reinterpret_cast<float4*>(part_acc + at * HD)[d4] = A;
          if (d4 == 0) part_ml[at] = make_float2(M, L);
        }
      } else {
        const float inv = 1.f / (L == 0.f ? 1.f : L);
        TQ* orow = out_row(r) + 4 * d4;
        tva_st(orow + 0, A.x * inv);
        tva_st(orow + 1, A.y * inv);
        tva_st(orow + 2, A.z * inv);
        tva_st(orow + 3, A.w * inv);
      }
    }
  };

  // Tickets of this (batch row, kv head): [0] groups merged, [1 + g] splits
  // of group g done. The last split of a group to arrive merges the group;
  // the last group merger merges the groups. Each resets what it counted.
  int* tk = tickets + (size_t)slot * TICKETS_PER_SLOT;
  const int g = split / GROUP;
  const int ngroups = (live + GROUP - 1) / GROUP;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tk + 1 + g, 1) == min(GROUP, live - g * GROUP) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ngroups == 1) {  // one group: its merger writes the output
    merge(0, 0, false);
    if (tid == 0) tk[1] = 0;
    return;
  }
  merge(g * GROUP, g, true);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tk[1 + g] = 0;
    last = atomicAdd(tk, 1) == ngroups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge(nsplit, 0, false);
  if (tid == 0) tk[0] = 0;
}

}  // namespace
