// K13: grouped matmul, out[i] = x[i] @ w[tile_expert[i / tm]] -- (M, f).
//
// Replaces: tpu_voice_agent/ops/grouped_matmul.py `grouped_matmul`
//   (`_gmm_kernel`, pallas_call at :97). The MoE feed-forward's grouped
//   dispatch (models/llama.py `_moe_ffn_grouped`) sorts token-expert
//   assignments by expert and pads each expert's run to a multiple of the
//   row tile tm (a power of two in [8, 128]), so every row tile belongs to
//   ONE expert; three launches per MoE layer (gate, up, down).
// x (M, d) bf16 or fp32, rows expert-sorted and tile-padded; w (E, d, f)
// bf16, fp32, or an int8 leaf {q (E, d, f) int8, s (E, 1, f) fp32}, for which
// the tile loader forms bf16(bf16(q) * bf16(s)) per element: `_w`'s
// materialized value bit for bit (the bf16 x bf16 product is exact in fp32
// and rounds once), without writing the (E, d, f) bf16 copy per call.
// Products and sums are fp32; the result is cast to x's dtype.
//
// The TPU grid was (M/tm, f/tn, d/tk) with the expert id in scalar prefetch
// and an fp32 scratch accumulator carried along the sequential k axis. Here a
// block owns one (row tile, 128-column tile) of the output, reads its own
// tile_expert entry, and loops over d inside the block with the fp32 sum in
// registers. x and w tiles are staged through shared memory, the next
// stage's global loads in flight while the current one is multiplied: a
// warp reads one weight row's 128 columns as one contiguous run (4 weights
// a thread: 4, 8 or 16 bytes) and writes them to shared memory without bank
// conflicts; x rows go as 16-byte loads on the tensor-core path; scalar
// loads take a ragged or misaligned edge.
//
// What bounds it on an H100. At decode (Tt*K = 2 assignments, tm 8, 9 row
// tiles) it is bytes: each row tile streams its expert's (d, f) plane once,
// 58.7 MB int8 at mixtral-8x7b, for 8 rows of work; the int8 leaf is read
// as int8 (1 byte a weight) and widened in registers, and 7 of the 9 tiles
// are the zero tail clipped to expert E-1 (the interface's, see ROADMAP.md).
// At prefill (tm 128, up to 24 tiles) it is operations. bf16 activations
// take the tensor cores (wmma 16x16x16, bf16 operands, fp32 accumulators) at
// every tm, so decode, too, spends its instructions on loads and not on
// FMAs; fp32 activations or weights take fp32 FMAs on the CUDA cores (a
// 128-row tile gives each thread a 16 x 4 register tile).
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BN = 128;  // output columns a block owns
constexpr int BK = 32;   // depth of one shared-memory stage
constexpr int THREADS = 256;

#define TVA_W_INT8 2  // w_dtype beside TVA_DTYPE_BF16 / TVA_DTYPE_F32

template <int WT> struct WTraits;  // the stored weight type
template <> struct WTraits<TVA_DTYPE_BF16> { using T = __nv_bfloat16; };
template <> struct WTraits<TVA_DTYPE_F32> { using T = float; };
template <> struct WTraits<TVA_W_INT8> { using T = int8_t; };

// Storage of VEC adjacent weights of one row (4 x int8, bf16 or fp32).
constexpr int VEC = 4;
template <int BYTES> struct VecOf;
template <> struct VecOf<4> { using T = unsigned int; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<16> { using T = uint4; };

// A thread's share of one KD x BN weight stage: VEC adjacent columns of
// PASSES rows. A warp covers one row's 128 columns, so its global loads are
// one contiguous run and its shared-memory stores one contiguous 512-byte
// (fp32) or 256-byte (bf16) row segment: no bank conflicts. Columns past f
// and rows past d read as 0.
template <int WT, int KD>
struct WTile {
  using T = typename WTraits<WT>::T;
  using Raw = typename VecOf<VEC * sizeof(T)>::T;
  static constexpr int ROWS = THREADS / (BN / VEC);  // rows one pass covers
  static constexpr int PASSES = KD / ROWS;
  Raw raw[PASSES];

  __device__ __forceinline__ void load(const T* __restrict__ plane, int k0, int c0, int d, int f,
                                       bool vec_ok) {
    const int n = c0 + (threadIdx.x % (BN / VEC)) * VEC;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int k = k0 + i * ROWS + threadIdx.x / (BN / VEC);
      if (k < d && vec_ok && n + VEC <= f) {
        raw[i] = *reinterpret_cast<const Raw*>(plane + (size_t)k * f + n);
      } else {
        T* v = reinterpret_cast<T*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          v[j] = (k < d && n + j < f) ? plane[(size_t)k * f + n + j] : T(0.f);
      }
    }
  }

  // The weight value as the plain version sees it: the element itself, or
  // for an int8 leaf bf16(q * bf16(s)) (scale: the column's bf16 scale).
  __device__ __forceinline__ static float value(T q, float scale) {
    if constexpr (WT == TVA_W_INT8) {
      return __bfloat162float(__float2bfloat16((float)q * scale));
    } else {
      (void)scale;
      return tva_ld(q);
    }
  }

  // Stage into shared memory as ST (float or bf16), row-major with leading
  // dimension LD; `ss` holds the block's BN column scales (int8 only).
  template <typename ST, int LD>
  __device__ __forceinline__ void store(ST* ws, const float* ss) const {
    const int nn = (threadIdx.x % (BN / VEC)) * VEC;
    float sc[VEC] = {};
    if constexpr (WT == TVA_W_INT8) {
      const float4 s4 = *reinterpret_cast<const float4*>(ss + nn);
      sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
    }
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int kk = i * ROWS + threadIdx.x / (BN / VEC);
      const T* v = reinterpret_cast<const T*>(&raw[i]);
      if constexpr (sizeof(ST) == 4) {
        float x[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[j] = value(v[j], sc[j]);
        *reinterpret_cast<float4*>(ws + kk * LD + nn) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
        __nv_bfloat162 lo, hi;
        if constexpr (WT == TVA_W_INT8) {  // _w's product, rounded once
          lo = __floats2bfloat162_rn((float)v[0] * sc[0], (float)v[1] * sc[1]);
          hi = __floats2bfloat162_rn((float)v[2] * sc[2], (float)v[3] * sc[3]);
        } else {
          lo = *reinterpret_cast<const __nv_bfloat162*>(v);
          hi = *reinterpret_cast<const __nv_bfloat162*>(v + 2);
        }
        uint2 packed;
        packed.x = *reinterpret_cast<unsigned int*>(&lo);
        packed.y = *reinterpret_cast<unsigned int*>(&hi);
        *reinterpret_cast<uint2*>(ws + kk * LD + nn) = packed;
      }
    }
  }
};

// The block's column scales, rounded to bf16 as `_w` rounds them.
template <int WT>
__device__ __forceinline__ void load_scales(float* ss, const float* __restrict__ scale, int e,
                                            int c0, int f) {
  if constexpr (WT == TVA_W_INT8) {
    for (int j = threadIdx.x; j < BN; j += THREADS) {
      const int n = c0 + j;
      ss[j] = n < f ? __bfloat162float(__float2bfloat16(scale[(size_t)e * f + n])) : 0.f;
    }
  }
}

// ---------------------------------------------------------------- FMA path
// fp32 activations or fp32 weights, any tm. RB = tm rows a block; 8 row
// groups x 32 column groups of threads, each thread RB/8 rows x 4 adjacent
// columns.
template <typename XT, int WT, int RB>
__global__ void __launch_bounds__(THREADS)
gmm_fma_kernel(const XT* __restrict__ x, const typename WTraits<WT>::T* __restrict__ w,
               const float* __restrict__ scale, const int* __restrict__ tile_expert,
               XT* __restrict__ out, int d, int f, int tm, bool vec_ok) {
  constexpr int TR = RB / 8;
  constexpr int XPT = (RB * BK + THREADS - 1) / THREADS;  // x elements a thread loads
  __shared__ float xs[BK][RB + 1];                        // transposed x tile
  __shared__ __align__(16) float ws[BK][BN];
  __shared__ __align__(16) float ss[BN];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int r0 = blockIdx.y * RB, c0 = blockIdx.x * BN;
  const int e = tile_expert[r0 / tm];
  const auto* plane = w + (size_t)e * d * f;
  load_scales<WT>(ss, scale, e, c0, f);

  WTile<WT, BK> wc;
  float xr[XPT];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * THREADS, r = c / BK, k = k0 + c % BK;
      xr[i] = (c < RB * BK && k < d) ? tva_ld(x[(size_t)(r0 + r) * d + k]) : 0.f;
    }
  };
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_x(0);
  wc.load(plane, 0, c0, d, f, vec_ok);
  for (int k0 = 0; k0 < d; k0 += BK) {
    __syncthreads();  // ss is ready; the previous stage's reads are done
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if (c < RB * BK) xs[c % BK][c / BK] = xr[i];
    }
    wc.template store<float, BN>(&ws[0][0], ss);
    __syncthreads();
    if (k0 + BK < d) {  // the next stage's loads fly during this one's FMAs
      load_x(k0 + BK);
      wc.load(plane, k0 + BK, c0, d, f, vec_ok);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float xv = xs[kk][ty + 8 * i];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const size_t row = (size_t)(r0 + ty + 8 * i) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c0 + tx * 4 + j;
      if (n < f) tva_st(out + row + n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- tensor cores
// bf16 activations with bf16 or int8 weights: the same function (bf16 x bf16
// products are exact in fp32, the sum stays fp32) on wmma 16x16x16
// fragments. A block owns min(tm, RB) rows of one row tile: RB = tm, except
// tm 8, which runs 16-row fragments whose rows 8-15 are zero (the next tile
// may belong to another expert). 8 warps in WM x WN, each a (RB/WM) x
// (BN/WN) warp tile. Two stages of global loads are in flight (register
// double buffering) while one is multiplied: at decode the kernel waits on
// memory, not on arithmetic. The int8 leaf takes 64-deep stages (32 for
// bf16), so each thread keeps as many weight bytes in flight either way.
template <int WT, int RB>
__global__ void __launch_bounds__(THREADS)
gmm_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                const typename WTraits<WT>::T* __restrict__ w, const float* __restrict__ scale,
                const int* __restrict__ tile_expert, __nv_bfloat16* __restrict__ out, int d,
                int f, int tm, bool vec_ok, bool xvec_ok) {
  using namespace nvcuda;
  constexpr int WM = RB >= 32 ? 2 : 1, WN = 8 / WM;
  constexpr int FM = RB / WM / 16, FN = BN / WN / 16;
  constexpr int KD = WT == TVA_W_INT8 ? 2 * BK : BK;  // depth of a stage
  constexpr int XLD = KD + 8, WLD = BN + 8;  // padded rows (multiples of 8 elements)
  constexpr int XCH = RB * KD / 8;           // 16-byte x chunks a stage
  constexpr int XPT = (XCH + THREADS - 1) / THREADS;
  __shared__ __align__(32) __nv_bfloat16 xs[RB * XLD];
  __shared__ __align__(32) __nv_bfloat16 ws[KD * WLD];
  __shared__ __align__(32) float cs[8][16 * 16];  // one fragment a warp, for the epilogue
  __shared__ __align__(16) float ss[BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int rows = tm < RB ? tm : RB;
  const int r0 = blockIdx.y * rows, c0 = blockIdx.x * BN;
  const int e = tile_expert[r0 / tm];
  const auto* plane = w + (size_t)e * d * f;
  load_scales<WT>(ss, scale, e, c0, f);

  struct Stage {
    WTile<WT, KD> w;
    uint4 x[XPT];
  };
  auto load = [&](Stage& st, int k0) {
    st.w.load(plane, k0, c0, d, f, vec_ok);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * THREADS, r = c / (KD / 8), k = k0 + (c % (KD / 8)) * 8;
      if (c >= XCH) continue;
      const __nv_bfloat16* src = x + (size_t)(r0 + r) * d + k;
      if (r < rows && xvec_ok && k + 8 <= d) {
        st.x[i] = *reinterpret_cast<const uint4*>(src);
      } else {
        __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&st.x[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = (r < rows && k + j < d) ? src[j] : __float2bfloat16(0.f);
      }
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // stage k0 from its registers into shared memory, refill those registers
  // with stage k0 + 2 KD, multiply stage k0
  auto step = [&](Stage& st, int k0) {
    __syncthreads();  // ss is ready; the previous stage's reads are done
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if (c < XCH)
        *reinterpret_cast<uint4*>(&xs[(c / (KD / 8)) * XLD + (c % (KD / 8)) * 8]) = st.x[i];
    }
    st.w.template store<__nv_bfloat16, WLD>(ws, ss);
    __syncthreads();
    if (k0 + 2 * KD < d) load(st, k0 + 2 * KD);
#pragma unroll
    for (int kk = 0; kk < KD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * FM * 16 + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::load_matrix_sync(b, ws + kk * WLD + wn * FN * 16 + j * 16, WLD);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  };
  Stage s0, s1;
  load(s0, 0);
  if (KD < d) load(s1, KD);
  for (int k0 = 0; k0 < d; k0 += 2 * KD) {
    step(s0, k0);
    if (k0 + KD < d) step(s1, k0 + KD);
  }
  // epilogue: each fragment through the warp's scratch, masked at column f
  // and at the block's rows
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rb = wm * FM * 16 + i * 16, cb = c0 + wn * FN * 16 + j * 16;
      for (int t = lane; t < 256; t += 32) {
        const int n = cb + t % 16, r = rb + t / 16;
        if (n < f && r < rows) out[(size_t)(r0 + r) * f + n] = __float2bfloat16(cs[warp][t]);
      }
      __syncwarp();
    }
  }
}

template <typename XT, int WT>
int launch_fma(const void* x, const void* w, const float* scale, const int* te, void* out, int M,
               int d, int f, int tm, bool vec_ok, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, M / tm);
  const auto* xp = static_cast<const XT*>(x);
  const auto* wp = static_cast<const typename WTraits<WT>::T*>(w);
  auto* op = static_cast<XT*>(out);
  switch (tm) {
    case 8: gmm_fma_kernel<XT, WT, 8><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok); break;
    case 16: gmm_fma_kernel<XT, WT, 16><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok); break;
    case 32: gmm_fma_kernel<XT, WT, 32><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok); break;
    case 64: gmm_fma_kernel<XT, WT, 64><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok); break;
    case 128: gmm_fma_kernel<XT, WT, 128><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int WT>
int launch_wmma(const void* x, const void* w, const float* scale, const int* te, void* out, int M,
                int d, int f, int tm, bool vec_ok, bool xvec_ok, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, M / tm);  // a block per row tile
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const typename WTraits<WT>::T*>(w);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (tm) {
    case 8:  // 16-row fragments, rows 8-15 zero
    case 16: gmm_wmma_kernel<WT, 16><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok, xvec_ok); break;
    case 32: gmm_wmma_kernel<WT, 32><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok, xvec_ok); break;
    case 64: gmm_wmma_kernel<WT, 64><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok, xvec_ok); break;
    case 128: gmm_wmma_kernel<WT, 128><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, op, d, f, tm, vec_ok, xvec_ok); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, d), w (E, d, f) [+ scale (E, 1, f) fp32 for w_dtype 2, int8],
// tile_expert (M / tm,) int32 -> out (M, f) in x's dtype. M is a multiple of
// tm, a power of two in [8, 128]; tile_expert entries lie in [0, E).
// x_dtype: 0 bf16, 1 fp32; w_dtype: 0 bf16, 1 fp32, 2 int8.
extern "C" int tva_grouped_matmul(const void* x, const void* w, const float* scale,
                                  const int* tile_expert, void* out, int M, int d, int f, int tm,
                                  int x_dtype, int w_dtype, void* stream) {
  if (M <= 0 || d <= 0 || f <= 0 || tm < 8 || tm > 128 || (tm & (tm - 1)) || M % tm)
    return (int)cudaErrorInvalidValue;
  if (w_dtype == TVA_W_INT8 && scale == nullptr) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const int wsize = w_dtype == TVA_W_INT8 ? 1 : (w_dtype == TVA_DTYPE_BF16 ? 2 : 4);
  // vector loads of VEC weights need rows aligned to VEC elements
  const bool vec_ok = f % VEC == 0 && reinterpret_cast<uintptr_t>(w) % (VEC * wsize) == 0;
  const bool xvec_ok = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_dtype == TVA_DTYPE_BF16) {
    switch (w_dtype) {
      case TVA_DTYPE_BF16:
        return launch_wmma<TVA_DTYPE_BF16>(x, w, scale, tile_expert, out, M, d, f, tm, vec_ok, xvec_ok, s);
      case TVA_W_INT8:
        return launch_wmma<TVA_W_INT8>(x, w, scale, tile_expert, out, M, d, f, tm, vec_ok, xvec_ok, s);
      case TVA_DTYPE_F32:
        return launch_fma<__nv_bfloat16, TVA_DTYPE_F32>(x, w, scale, tile_expert, out, M, d, f, tm, vec_ok, s);
    }
  } else if (x_dtype == TVA_DTYPE_F32) {
    switch (w_dtype) {
      case TVA_DTYPE_BF16:
        return launch_fma<float, TVA_DTYPE_BF16>(x, w, scale, tile_expert, out, M, d, f, tm, vec_ok, s);
      case TVA_W_INT8:
        return launch_fma<float, TVA_W_INT8>(x, w, scale, tile_expert, out, M, d, f, tm, vec_ok, s);
      case TVA_DTYPE_F32:
        return launch_fma<float, TVA_DTYPE_F32>(x, w, scale, tile_expert, out, M, d, f, tm, vec_ok, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
