// K1: blockwise online-softmax GQA attention (flash attention); q/k/v/o all
// bf16 or all fp32, arithmetic in fp32.
//
// Replaces: tpu_voice_agent/ops/flash_attention.py `flash_attention`
// (`_flash_kernel`, pallas_call at :158). Same semantics: q (B,T,nq,hd),
// k/v (B,S,nkv,hd) in their native layouts, kv head = h / (nq/nkv), scores
// in fp32, masked entries -1e30 (causal: key > query; any mode: key >=
// kv_len), running (max, sum, acc) per query row, out = acc / (l or 1).
//
// What bounds it on an H100: at the 1024-token prefix prefill (32 q heads,
// hd 64, causal) the work is ~4.3 GFLOP per layer against ~4 MB of q/k/v/o,
// so it is compute-bound; this first version runs the products on the fp32
// CUDA cores (67 TFLOP/s peak), not the tensor cores. Its design: one block
// per (64-query tile, q head, batch row), a loop over 64-key tiles inside the
// block (the TPU's sequential grid axis), tiles wholly above the diagonal or
// at/after kv_len never loaded, q/k/v tiles staged once in shared memory as
// fp32 with a padded pitch so the four threads of a query row and the eight
// rows of a warp hit distinct banks. Scores never reach device memory.
// Tensor-core (wgmma) tiles are later work.
#include "common.cuh"

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

}  // namespace

// q (B,T,nq,hd), k/v (B,S,nkv,hd), o like q; all of one dtype (TVA_DTYPE_*).
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
  TVA_DISPATCH_HD(hd, return launch<HD, __nv_bfloat16>(q, k, v, o, B, T, S, nq, nkv, kv_len,
                                                       causal, scale, st));
  return (int)cudaErrorInvalidValue;
}
