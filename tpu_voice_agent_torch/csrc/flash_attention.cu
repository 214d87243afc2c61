// K1: blockwise online-softmax GQA attention (flash attention); q/k/v/o all
// bf16 or all fp32.
//
// Replaces: tpu_voice_agent/ops/flash_attention.py `flash_attention`
// (`_flash_kernel`, pallas_call at :158). Same semantics: q (B,T,nq,hd),
// k/v (B,S,nkv,hd) in their native layouts, kv head = h / (nq/nkv), scores
// in fp32, masked entries -1e30 (causal: key > query; any mode: key >=
// kv_len), running (max, sum, acc) per query row, out = acc / (l or 1).
//
// What bounds it on an H100: at the 1024-token prefix prefill (32 q heads,
// hd 64, causal) the work is ~4.3 GFLOP per layer against ~4 MB of q/k/v/o,
// so it is compute-bound (989 TFLOP/s on the bf16 tensor cores: 4.3 us).
//
// bf16 inputs (the tinyllama / mixtral prefill, the Whisper large-v3
// encoder) run the tensor-core body `tc::flash_kernel`:
// - One block of 4 warps per (64-query tile, q head, batch row); each warp
//   owns 16 query rows. The grid puts the q heads of one kv head next to
//   each other (blockIdx.x), so their blocks read the same K/V tiles from
//   L2, and the causal mode hands out the heaviest (last) q tiles first.
// - Q, K and V stay bf16 in shared memory, as stored, rows padded by 16
//   bytes so that the 8 row addresses of every ldmatrix fall in distinct
//   bank groups (the padding works at every head dim, 48 included, where an
//   XOR swizzle needs a power-of-two row). K/V tiles of 64 keys arrive by
//   16-byte cp.async copies into a ring of 3 stages (2 at hd 128): tile
//   i + 2 is in flight while tile i computes. Rows past the last key the
//   tile can use are zero-filled by the copy, not read.
// - S = Q.K^T and P.V run on mma.sync m16n8k16 (bf16 operands, fp32
//   accumulators in registers); Q's fragments are loaded once, K's with
//   ldmatrix, V's with ldmatrix.trans. The online softmax runs on the score
//   fragments in registers, fp32 throughout. A tile's P.V is summed from 0
//   and then added to the running output (O = alpha O + P.V in one FMA):
//   the tensor cores truncate each fp32 sum, so products summed onto the
//   larger running output would lose low bits toward 0 tile after tile.
// - P enters the second product as three bf16 fragments, hi = bf16(p),
//   mid = bf16(p - hi), lo = bf16(p - hi - mid), ~24 significant bits: the
//   fp32 probabilities of the plain version, up to fp32 rounding. Rounding
//   p once to bf16 (SDPA's way) misses the bf16 tolerance by up to ~9x
//   where a few-key row's output cancels to near 0; hi + mid (~16 bits)
//   holds it but leaves ~10x as many bf16 outputs one ulp off the plain
//   version's as fp32 arithmetic does, enough to move the bf16 decoding
//   that reads the prefix's k/v past the spec parting gate
//   (tests/test_torch_kernel_design.py emulates the three). l is summed
//   from the fp32 p.
// - Tiles wholly above the causal diagonal or at/after kv_len are never
//   loaded; only the tiles that reach the diagonal or kv_len are masked.
// mma.sync rather than wgmma: its 16-row fragments serve every head dim
// here (48 included) from one body; the 64-row wgmma tile with its
// shared-memory descriptors and TMA loads is the next step.
//
// fp32 inputs (the in-repo Whisper checkpoints at hd 16, the distilled
// intent model, the fp32-activation phases) keep the first version's body,
// `flash_attention_kernel<HD, float>`, unchanged: the products on the fp32
// CUDA cores, q/k/v tiles staged in shared memory with a padded pitch, one
// block per (64-query tile, q head, batch row). Its results are bit for bit
// those the golden recordings and fp32 parting gates were taken with; TF32
// tensor cores would not hold the fp32 tolerance.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int SUBS = 4;

template <int HD, typename TI>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                       const TI* __restrict__ v, TI* __restrict__ o,
                       int T, int S, int nq, int nkv, int kv_len, int causal, float scale) {
  constexpr int QP = HD + 1;  // padded pitch (bank spread)
  constexpr int PP = BK + 1;
  constexpr int KPT = BK / SUBS;  // scores per thread per tile
  constexpr int DPT = HD / SUBS;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QP]
  float* Ks = Qs + BQ * QP;     // [BK][QP]
  float* Vs = Ks + BK * QP;     // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][PP]

  const int tid = threadIdx.x;
  const int row = tid / SUBS;
  const int sub = tid % SUBS;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, t = q0 + r;
    Qs[r * QP + d] = t < T ? tva_ld(q[((size_t)(b * T + t) * nq + h) * HD + d]) : 0.f;
  }

  const int qpos = q0 + row;
  float m = TVA_NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  // last key any row of this tile may see
  int kend = min(kv_len, S);
  if (causal) kend = min(kend, q0 + BQ);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written, first time)
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = ((size_t)(b * S + s) * nkv + kvh) * HD + d;
        kx = tva_ld(k[off]);
        vx = tva_ld(v[off]);
      }
      Ks[r * QP + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float sc[KPT];
    float mt = TVA_NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + SUBS * j;
      const float* qr = Qs + row * QP;
      const float* kr = Ks + c * QP;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kpos = k0 + c;
      const bool valid = kpos < kv_len && (!causal || qpos >= kpos);
      sc[j] = valid ? dot * scale : TVA_NEG_INF;
      mt = fmaxf(mt, sc[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = __expf(sc[j] - m_new);
      Ps[row * PP + sub + SUBS * j] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float alpha = __expf(m - m_new);
    l = alpha * l + ps;
    m = m_new;
    __syncwarp();  // the row's four threads share Ps[row]
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[row * PP + c];
      const float* vr = Vs + c * HD + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[SUBS * i], acc[i]);
    }
  }

  if (qpos < T) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    TI* orow = o + ((size_t)(b * T + qpos) * nq + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) tva_st(orow + sub + SUBS * i, acc[i] * inv);
  }
}

template <int HD, typename TI>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int nq,
           int nkv, int kv_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  cudaError_t err = tva_allow_smem(flash_attention_kernel<HD, TI>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, nq, B);
  flash_attention_kernel<HD, TI><<<grid, THREADS, smem, stream>>>(
      (const TI*)q, (const TI*)k, (const TI*)v, (TI*)o, T, S, nq, nkv, kv_len, causal, scale);
  return (int)cudaGetLastError();
}


namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;   // queries per block, 16 per warp
constexpr int BKV = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int HD>
struct Cfg {
  static constexpr int P = HD + 8;  // row pitch in bf16: rows 16 bytes apart in bank space
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr size_t SMEM = sizeof(bf16) * P * (BQ + 2 * BKV * STAGES);
};

// Thread layout of an m16n8 fragment: lane = 4 g + t holds rows g and g + 8,
// columns 2t and 2t + 1 (accumulator e: row g + 8 (e / 2), column 2t + e % 2).
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, int T, int S, int nq, int nkv, int kv_len, int causal,
             float scale) {
  using C = Cfg<HD>;
  constexpr int P = C::P, ST = C::STAGES;
  constexpr int KSTEPS = HD / 16;  // k16 steps of Q.K^T
  constexpr int DT = HD / 8;       // n8 tiles of the output
  constexpr int NT = BKV / 8;      // n8 tiles of the scores
  constexpr int CPR = HD / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][P]
  bf16* KVs = Qs + BQ * P;                       // stage s: K [BKV][P], then V [BKV][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const int kvh = h / (nq / nkv);
  const size_t qstride = (size_t)nq * HD, kstride = (size_t)nkv * HD;
  const bf16* qb = q + ((size_t)b * T * nq + h) * HD;
  const bf16* kb = k + ((size_t)b * S * nkv + kvh) * HD;
  const bf16* vb = v + ((size_t)b * S * nkv + kvh) * HD;

  const int kvl = min(kv_len, S);
  const int kend = causal ? min(kvl, q0 + BQ) : kvl;  // last key any row of this tile sees
  const int ntiles = kend > 0 ? (kend + BKV - 1) / BKV : 0;

  // 64 rows from row r0 of src (row stride `stride`) into dst; rows at or
  // past `nvalid` are zero-filled
  auto load_rows = [&](bf16* dst, const bf16* src, size_t stride, int r0, int nvalid) {
#pragma unroll
    for (int i = tid; i < 64 * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r0 + r < nvalid;
      cp_async16(smem_u32(dst + r * P + c * 8), src + (size_t)(ok ? r0 + r : 0) * stride + c * 8,
                 ok);
    }
  };
  auto load_tile = [&](int tile) {
    bf16* ks = KVs + (tile % ST) * 2 * BKV * P;
    load_rows(ks, kb, kstride, tile * BKV, kend);
    load_rows(ks + BKV * P, vb, kstride, tile * BKV, kend);
  };

  if (ntiles > 0) load_rows(Qs, qb, qstride, q0, T);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();  // group s (group 0 carries Q too); empty past the last tile
  }

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_r[2] = {TVA_NEG_INF, TVA_NEG_INF}, l_r[2] = {0.f, 0.f};
  uint32_t qf[KSTEPS][4];
  const int row_lo = q0 + warp * 16 + g;  // this thread's rows: row_lo and row_lo + 8

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<ST - 2>();  // tile it (and Q) landed for this thread's copies
    __syncthreads();          // ... and every thread's; tile it - 1's stage is free
    if (it + ST - 1 < ntiles) load_tile(it + ST - 1);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int r = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4(qf[kk], smem_u32(Qs + r * P + kk * 16 + ((lane >> 4) << 3)));
      }
    }
    const bf16* Ks = KVs + (it % ST) * 2 * BKV * P;
    const bf16* Vs = Ks + BKV * P;

    // S = Q K^T: 16 rows x 64 keys per warp
    float sacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];  // keys 16 np + [0, 8) and [8, 16), dims 16 kk + [0, 8) and [8, 16)
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(r, smem_u32(Ks + key * P + kk * 16 + (((lane >> 3) & 1) << 3)));
        mma16816(sacc[2 * np], qf[kk], r[0], r[1]);
        mma16816(sacc[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale, mask the diagonal / kv_len tile, online softmax in registers
    const int k0 = it * BKV;
    const bool masked = k0 + BKV > kvl || (causal && k0 + BKV - 1 > q0 + warp * 16);
    float mt[2] = {TVA_NEG_INF, TVA_NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[j][e] * scale;
        if (masked) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qrow = row_lo + (e >> 1) * 8;
          if (!(key < kvl && (!causal || qrow >= key))) s = TVA_NEG_INF;
        }
        sacc[j][e] = s;
        mt[e >> 1] = fmaxf(mt[e >> 1], s);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
      const float m_new = fmaxf(m_r[hr], mt[hr]);
      alpha[hr] = __expf(m_r[hr] - m_new);
      m_r[hr] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sacc[j][e] - m_r[e >> 1]);
        sacc[j][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      ps[hr] += __shfl_xor_sync(0xffffffffu, ps[hr], 1);
      ps[hr] += __shfl_xor_sync(0xffffffffu, ps[hr], 2);
      l_r[hr] = alpha[hr] * l_r[hr] + ps[hr];
    }
    // this tile's P V, P as three bf16 A fragments (lo, mid, hi), summed into
    // a fresh accumulator: the tensor cores truncate each sum to fp32, so the
    // tile's terms are kept off the running output's larger exponent
    float tacc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) tacc[i][0] = tacc[i][1] = tacc[i][2] = tacc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pf[3][4];
      split3_bf16(sacc[2 * kk][0], sacc[2 * kk][1], pf, 0);
      split3_bf16(sacc[2 * kk][2], sacc[2 * kk][3], pf, 1);
      split3_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], pf, 2);
      split3_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], pf, 3);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t r[4];  // keys 16 kk + [0, 8) and [8, 16), dims 16 dp + [0, 8) and [8, 16)
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(r, smem_u32(Vs + key * P + dp * 16 + ((lane >> 4) << 3)));
#pragma unroll
        for (int k = 2; k >= 0; --k) {
          mma16816(tacc[2 * dp], pf[k], r[0], r[1]);
          mma16816(tacc[2 * dp + 1], pf[k], r[2], r[3]);
        }
      }
    }
    // O = alpha O + this tile's P V, one fp32 rounding
#pragma unroll
    for (int i = 0; i < DT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][e] = fmaf(oacc[i][e], alpha[e >> 1], tacc[i][e]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qrow = row_lo + hr * 8;
    if (qrow < T) {
      const float inv = 1.f / (l_r[hr] == 0.f ? 1.f : l_r[hr]);
      bf16* orow = o + ((size_t)(b * T + qrow) * nq + h) * HD + 2 * t4;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
            __floats2bfloat162_rn(oacc[i][2 * hr] * inv, oacc[i][2 * hr + 1] * inv);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int nq,
           int nkv, int kv_len, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = tva_allow_smem(flash_kernel<HD>, Cfg<HD>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq, (T + BQ - 1) / BQ, B);
  flash_kernel<HD><<<grid, THREADS, Cfg<HD>::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, T, S, nq, nkv, kv_len, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B,T,nq,hd), k/v (B,S,nkv,hd), o like q; all of one dtype (TVA_DTYPE_*).
// The bf16 path takes 16-byte-aligned operands (the wrapper checks).
extern "C" int tva_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                   int T, int S, int nq, int nkv, int hd, int kv_len, int causal,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || nkv <= 0 || nq % nkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == TVA_DTYPE_F32) {
    TVA_DISPATCH_HD(hd, return launch<HD, float>(q, k, v, o, B, T, S, nq, nkv, kv_len, causal,
                                                 scale, st));
  }
  if (dtype != TVA_DTYPE_BF16) return (int)cudaErrorInvalidValue;
  TVA_DISPATCH_HD(hd, return tc::launch<HD>(q, k, v, o, B, T, S, nq, nkv, kv_len, causal, scale,
                                            st));
  return (int)cudaErrorInvalidValue;
}
