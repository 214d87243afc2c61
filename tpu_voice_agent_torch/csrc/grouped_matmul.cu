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
// the kernel forms bf16(bf16(q) * bf16(s)) per element: `_w`'s materialized
// value bit for bit (the bf16 x bf16 product is exact in fp32 and rounds
// once), without writing the (E, d, f) bf16 copy per call. Products and sums
// are fp32; the result is cast to x's dtype. `live_rows` (null: every row):
// the layout's live row count on the device; the tiles at or past it are the
// zero tail that the layout clips to expert E-1, and their blocks write
// zeros and return without reading a weight.
//
// What bounds it on an H100. At decode (one token, top-2: tm 8, 2 live row
// tiles) and at the ff=8 block (tm 32, up to 8 live tiles) it is bytes:
// each live tile streams its expert's (d, f) plane, 58.7 MB as int8 at
// mixtral-8x7b, for 8 or 32 rows of work. At the prefix prefill (tm 128,
// 24 tiles) it is operations: 2 * 3072 * 4096 * 14336 per projection.
//
// The design, for bf16 activations (`tc_kernel`):
// - The product is taken transposed, out^T = w^T x^T: the weight columns are
//   the MMA's M, the tile's tm rows of x its N, so tm 8 fills mma.sync's
//   m16n8k16 and nothing is padded. A block of 4 warps owns 128 output
//   columns of one row tile; each warp 32 of them and all tm rows (fp32
//   accumulators in registers). At tm 128 (the prefill, bound by
//   operations) the 4 warps issue wgmma m64n128k16 as one warpgroup, A from
//   the same registers, x read by the tensor cores from shared memory (rows
//   of 128 bytes, 128-byte swizzle); at tm 8-64 (bound by bytes) each warp
//   runs mma.sync with x's fragments by ldmatrix.
// - Weights and x reach shared memory by 16-byte cp.async copies into a
//   ring of 3-4 stages of 64-deep slices (int8 as stored, 1 byte a weight:
//   24-27 KB in flight a block at decode), so the loads of later stages fly
//   while one stage is multiplied. Weight rows are padded (144 / 272 bytes)
//   so a warp's fragment loads fall on distinct banks.
// - A warp builds its weight fragments (the MMA's A operand) in registers
//   straight from the staged tile: two int8 weights of one column become a
//   bf16 pair by one byte permute, two bit masks and a bf16x2 FMA (q
//   exactly), and a second FMA times the column's bf16 scale rounds q * s
//   once (`widen_i8x2`); a bf16 weight is taken as it is. Thread (g, t) of
//   a warp holds A rows g and g + 8 of its two 16-column tiles; they are
//   mapped to the 4 adjacent columns 4g .. 4g + 3, so one 32-bit (int8) or
//   64-bit (bf16) load per depth row feeds both tiles, and the epilogue
//   writes 4 adjacent outputs. The bf16 and int8 forms share the tiles, the
//   mapping and the summation order, so the int8 leaf equals the dense form
//   on `_w`'s values bit for bit.
// - Split-K (the decode step, tm 8): the depth is cut into `splits` ranges
//   chosen on the host from the shapes; a block writes its fp32 partial
//   tile to scratch, takes a ticket on the (row tile, column tile)'s
//   counter, and the last of its splits to arrive sums the partials in
//   split order, casts and writes the tile, and sets the counter back to 0.
//   The same bits run to run; no atomics on the output.
// fp32 activations or fp32 weights (mixtral-test's fp32 engines) keep the
// first version's body (`gmm_fma_kernel`): fp32 FMAs on the CUDA cores, a
// 128-row tile giving each thread a 16 x 4 register tile.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

#define TVA_W_INT8 2  // w_dtype beside TVA_DTYPE_BF16 / TVA_DTYPE_F32

template <int WT> struct WTraits;  // the stored weight type
template <> struct WTraits<TVA_DTYPE_BF16> { using T = __nv_bfloat16; };
template <> struct WTraits<TVA_DTYPE_F32> { using T = float; };
template <> struct WTraits<TVA_W_INT8> { using T = int8_t; };

// The block's column scales, rounded to bf16 as `_w` rounds them.
template <int WT>
__device__ __forceinline__ void load_scales(float* ss, const float* __restrict__ scale, int e,
                                            int c0, int f, int n) {
  if constexpr (WT == TVA_W_INT8) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int c = c0 + j;
      ss[j] = c < f ? __bfloat162float(__float2bfloat16(scale[(size_t)e * f + c])) : 0.f;
    }
  }
}

// ---------------------------------------------------------------- FMA path
// fp32 activations or fp32 weights, any tm. RB = tm rows a block; 8 row
// groups x 32 column groups of threads, each thread RB/8 rows x 4 adjacent
// columns. x and w tiles are staged through shared memory, the next stage's
// global loads in flight while the current one is multiplied.
namespace simt {

constexpr int BN = 128;  // output columns a block owns
constexpr int BK = 32;   // depth of one shared-memory stage
constexpr int THREADS = 256;

// Storage of VEC adjacent weights of one row (4 x int8, bf16 or fp32).
constexpr int VEC = 4;
template <int BYTES> struct VecOf;
template <> struct VecOf<4> { using T = unsigned int; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<16> { using T = uint4; };

// A thread's share of one BK x BN weight stage: VEC adjacent columns of
// PASSES rows. A warp covers one row's 128 columns, so its global loads are
// one contiguous run and its shared-memory stores one contiguous 512-byte
// row segment: no bank conflicts. Columns past f and rows past d read as 0.
template <int WT>
struct WTile {
  using T = typename WTraits<WT>::T;
  using Raw = typename VecOf<VEC * sizeof(T)>::T;
  static constexpr int ROWS = THREADS / (BN / VEC);  // rows one pass covers
  static constexpr int PASSES = BK / ROWS;
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

  // Stage into shared memory as fp32, row-major with leading dimension BN;
  // `ss` holds the block's BN column scales (int8 only).
  __device__ __forceinline__ void store(float* ws, const float* ss) const {
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
      float x[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = value(v[j], sc[j]);
      *reinterpret_cast<float4*>(ws + kk * BN + nn) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
};

template <typename XT, int WT, int RB>
__global__ void __launch_bounds__(THREADS)
gmm_fma_kernel(const XT* __restrict__ x, const typename WTraits<WT>::T* __restrict__ w,
               const float* __restrict__ scale, const int* __restrict__ tile_expert,
               const int* __restrict__ live_rows, XT* __restrict__ out, int d, int f, int tm,
               bool vec_ok) {
  constexpr int TR = RB / 8;
  constexpr int XPT = (RB * BK + THREADS - 1) / THREADS;  // x elements a thread loads
  __shared__ float xs[BK][RB + 1];                        // transposed x tile
  __shared__ __align__(16) float ws[BK][BN];
  __shared__ __align__(16) float ss[BN];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int r0 = blockIdx.y * RB, c0 = blockIdx.x * BN;
  if (live_rows != nullptr && r0 >= *live_rows) {  // the zero tail: no weight is read
    for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
      const int c = c0 + i % BN;
      if (c < f) tva_st(out + (size_t)(r0 + i / BN) * f + c, 0.f);
    }
    return;
  }
  const int e = tile_expert[r0 / tm];
  const auto* plane = w + (size_t)e * d * f;
  load_scales<WT>(ss, scale, e, c0, f, BN);

  WTile<WT> wc;
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
    wc.store(&ws[0][0], ss);
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

template <typename XT, int WT>
int launch(const void* x, const void* w, const float* scale, const int* te, const int* live,
           void* out, int M, int d, int f, int tm, bool vec_ok, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, M / tm);
  const auto* xp = static_cast<const XT*>(x);
  const auto* wp = static_cast<const typename WTraits<WT>::T*>(w);
  auto* op = static_cast<XT*>(out);
  switch (tm) {
    case 8: gmm_fma_kernel<XT, WT, 8><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, live, op, d, f, tm, vec_ok); break;
    case 16: gmm_fma_kernel<XT, WT, 16><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, live, op, d, f, tm, vec_ok); break;
    case 32: gmm_fma_kernel<XT, WT, 32><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, live, op, d, f, tm, vec_ok); break;
    case 64: gmm_fma_kernel<XT, WT, 64><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, live, op, d, f, tm, vec_ok); break;
    case 128: gmm_fma_kernel<XT, WT, 128><<<grid, THREADS, 0, stream>>>(xp, wp, scale, te, live, op, d, f, tm, vec_ok); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;  // output columns a block owns: 4 warps x 32
constexpr int BK = 64;   // depth of one ring stage
constexpr int THREADS = 128;
constexpr int XP = BK * 2 + 16;  // x row pitch in bytes (64 bf16 + 16)

template <int WT, int TM>
struct Cfg {
  static constexpr bool WG = TM == 128;                // wgmma; else mma.sync
  static constexpr int WB = WT == TVA_W_INT8 ? 1 : 2;  // bytes a stored weight
  static constexpr int WP = BM * WB + 16;              // weight row pitch in bytes
  static constexpr int W_BYTES = BK * WP;
  // x: rows of XP bytes (ldmatrix), or for wgmma rows of 128 bytes (the 64
  // depths) whose 16-byte chunks are XOR-swizzled by row % 8 (the 128-byte
  // swizzle), 1024-byte aligned: W_BYTES is a multiple of 1024 either way
  static constexpr int X_BYTES = WG ? TM * BK * 2 : TM * XP;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STAGES = WG ? (WB == 1 ? 4 : 3) : 4;
  // stages loaded ahead: wgmma reads a stage asynchronously, so the ring
  // keeps one stage more between the one read and the one written
  static constexpr int AHEAD = WG ? STAGES - 2 : STAGES - 1;
  // + column scales, + slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE + BM * (int)sizeof(float) + (WG ? 1024 : 0);
  static constexpr int NF = TM / 8;                    // n8 fragments: the tile's rows
};

// wgmma (sm_90a): one warpgroup, D (64x128 fp32) += A (64x16 bf16, registers:
// warp w holds rows 16w .. 16w + 15 as mma.sync's A fragment) * B (16x128
// bf16, shared memory, K-major, 128-byte swizzle: 8-row groups 1024 bytes
// apart). D's layout per warp is mma.sync's m16n8 accumulator, repeated over
// 16 column groups of 8. `addr`: the group's first row plus 2 bytes a depth.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  constexpr uint64_t SBO = 1024, SWIZZLE_128B = 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | 1ull << 16 | (SBO >> 4) << 32 | SWIZZLE_128B << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// accumulate: 0 overwrites D with A * B (the tile's first product), 1 adds to it
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
// pins a register's value at this point: the accumulators stay where wgmma
// writes them, with no copies between the asynchronous products
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// Byte I of wa and of wb, int8 weights q of one column, as the bf16 pair
// (low half from wa) bf16(q * s), sp: the column's bf16 scale in both halves.
// 128 + (q & 127) is a bf16 with q's low 7 bits as its mantissa; -128, or
// -256 where q's sign bit is set, is -128 with that bit as its exponent's
// lowest: their sum is q exactly, and one bf16 FMA rounds q * s once, as
// `_w` does (the -0 addend leaves the product as it is).
template <int I>
__device__ __forceinline__ uint32_t widen_i8x2(uint32_t wa, uint32_t wb, uint32_t sp) {
  const uint32_t h = __byte_perm(wa, wb, I | (4 + I) << 8);  // the bytes at bits 0 and 16
  const uint32_t mag = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t neg_off = (h & 0x00800080u) | 0xC300C300u;
  const uint32_t q = fma_bf16x2(mag, 0x3F803F80u, neg_off);  // mag * 1 - off
  return fma_bf16x2(q, sp, 0x80008000u);
}

// The A fragments of one 16-deep step for this warp's two 16-column tiles,
// from the stage's weight rows k .. k + 15 (row pitch WP): tile j, register
// (0, 1, 2, 3) = (row g, k 2t..2t+1), (row g + 8, k 2t..), (row g, k 2t+8..),
// (row g + 8, k 2t+8..) with rows g, g + 8 of tile j at columns 4g + 2j,
// 4g + 2j + 1 of the warp's 32.
template <int WT, int WP>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const uint8_t* wk, int lane,
                                       const uint32_t (&sp)[4]) {
  const int g = lane / 4, t = lane % 4;
  if constexpr (WT == TVA_W_INT8) {
    const uint8_t* p = wk + 2 * t * WP + 4 * g;  // 4 int8 columns 4g .. 4g + 3
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + WP);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 8 * WP);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 9 * WP);
    a[0][0] = widen_i8x2<0>(w0, w1, sp[0]);
    a[0][1] = widen_i8x2<1>(w0, w1, sp[1]);
    a[0][2] = widen_i8x2<0>(w2, w3, sp[0]);
    a[0][3] = widen_i8x2<1>(w2, w3, sp[1]);
    a[1][0] = widen_i8x2<2>(w0, w1, sp[2]);
    a[1][1] = widen_i8x2<3>(w0, w1, sp[3]);
    a[1][2] = widen_i8x2<2>(w2, w3, sp[2]);
    a[1][3] = widen_i8x2<3>(w2, w3, sp[3]);
  } else {
    (void)sp;
    const uint8_t* p = wk + 2 * t * WP + 8 * g;  // 4 bf16 columns 4g .. 4g + 3
    const uint2 r0 = *reinterpret_cast<const uint2*>(p);
    const uint2 r1 = *reinterpret_cast<const uint2*>(p + WP);
    const uint2 r2 = *reinterpret_cast<const uint2*>(p + 8 * WP);
    const uint2 r3 = *reinterpret_cast<const uint2*>(p + 9 * WP);
    // (low halves, high halves) of two words: columns 4g + 2j, 4g + 2j + 1
    a[0][0] = __byte_perm(r0.x, r1.x, 0x5410);
    a[0][1] = __byte_perm(r0.x, r1.x, 0x7632);
    a[0][2] = __byte_perm(r2.x, r3.x, 0x5410);
    a[0][3] = __byte_perm(r2.x, r3.x, 0x7632);
    a[1][0] = __byte_perm(r0.y, r1.y, 0x5410);
    a[1][1] = __byte_perm(r0.y, r1.y, 0x7632);
    a[1][2] = __byte_perm(r2.y, r3.y, 0x5410);
    a[1][3] = __byte_perm(r2.y, r3.y, 0x7632);
  }
}

// grid (column tiles, row tiles, splits); `chunk` depth a split covers (a
// multiple of BK); part / tickets: the split-K scratch and counters (null
// with one split).
template <int WT, int TM>
__global__ void __launch_bounds__(THREADS)
tc_kernel(const bf16* __restrict__ x, const typename WTraits<WT>::T* __restrict__ w,
          const float* __restrict__ scale, const int* __restrict__ tile_expert,
          const int* __restrict__ live_rows, bf16* __restrict__ out, float* __restrict__ part,
          int* __restrict__ tickets, int d, int f, int chunk, bool w_vec, bool x_vec) {
  using C = Cfg<WT, TM>;
  using WS = typename WTraits<WT>::T;
  constexpr int NF = C::NF, WP = C::WP, STAGES = C::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw;
  if constexpr (C::WG) smem += (1024 - smem_u32(smem_raw) % 1024) % 1024;
  float* ss = reinterpret_cast<float*>(smem + STAGES * C::STAGE);
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * BM, r0 = blockIdx.y * TM;
  const int split = blockIdx.z, nsplit = gridDim.z;

  if (live_rows != nullptr && r0 >= *live_rows) {  // the zero tail: no weight is read
    if (split == 0) {
      for (int i = tid; i < TM * BM; i += THREADS) {
        const int c = c0 + i % BM;
        if (c < f) out[(size_t)(r0 + i / BM) * f + c] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  const int e = tile_expert[blockIdx.y];
  const WS* plane = w + (size_t)e * d * f;
  const int kbeg = split * chunk, kend = min(d, kbeg + chunk);
  const int nk = (kend - kbeg + BK - 1) / BK;
  load_scales<WT>(ss, scale, e, c0, f, BM);

  // One stage: BK weight rows x BM columns and TM x rows x BK depth, 16 bytes
  // a copy; a chunk that is ragged (past d or f) or off the 16-byte grid is
  // read element by element and stored directly, zeros past the edge.
  auto load_stage = [&](int slot, int k0) {
    uint8_t* ws = smem + slot * C::STAGE;
    uint8_t* xs = ws + C::W_BYTES;
    constexpr int WCH = BM * C::WB / 16;  // 16-byte chunks a weight row
    constexpr int WE = 16 / C::WB;        // weights a chunk
#pragma unroll
    for (int j = 0; j < BK * WCH / THREADS; ++j) {
      const int i = tid + j * THREADS, r = i / WCH, cc = i % WCH;
      const int k = k0 + r, c = c0 + cc * WE;
      uint8_t* dst = ws + r * WP + cc * 16;
      if (w_vec && k < kend && c + WE <= f) {
        cp_async16(smem_u32(dst), plane + (size_t)k * f + c, true);
      } else {
        WS* v = reinterpret_cast<WS*>(dst);
#pragma unroll
        for (int u = 0; u < WE; ++u)
          v[u] = (k < kend && c + u < f) ? plane[(size_t)k * f + c + u] : WS(0.f);
      }
    }
    constexpr int XCH = TM * (BK / 8);  // 16-byte chunks of the x tile
#pragma unroll
    for (int j = 0; j < (XCH + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      if (XCH % THREADS != 0 && i >= XCH) break;
      const int r = i / (BK / 8), k = k0 + (i % (BK / 8)) * 8;
      const bf16* src = x + (size_t)(r0 + r) * d + k;
      const int kc = i % (BK / 8);
      uint8_t* dst = C::WG ? xs + r * 128 + ((kc ^ (r % 8)) << 4) : xs + r * XP + kc * 16;
      if (x_vec && k + 8 <= kend) {
        cp_async16(smem_u32(dst), src, true);
      } else {
        bf16* v = reinterpret_cast<bf16*>(dst);
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = k + u < kend ? src[u] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[2][NF][4];  // wgmma's first product overwrites them; mma.sync adds to 0
  auto fence_acc = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) fence_operand(acc[j][n][v]);
  };
  if constexpr (!C::WG) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][n][v] = 0.f;
  }

  constexpr int AHEAD = C::AHEAD;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nk) load_stage(s, kbeg + s * BK);
    cp_async_commit();
  }
  uint32_t sp[4] = {0, 0, 0, 0};  // this thread's four columns' bf16 scales, in pairs
  uint32_t a[2][2][4];                 // A fragments, two sets (wgmma reads them late)
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<AHEAD - 1>();
    if constexpr (C::WG) fence_proxy_async();  // the copies are visible to wgmma's reads
    __syncthreads();  // stage `it` has landed for every thread; the slot below is free
    if constexpr (WT == TVA_W_INT8) {
      if (it == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // ss holds bf16 values: the high halves are exact
          const uint32_t b = __float_as_uint(ss[warp * 32 + 4 * g + i]) >> 16;
          sp[i] = b | b << 16;
        }
      }
    }
    if (it + AHEAD < nk) load_stage((it + AHEAD) % STAGES, kbeg + (it + AHEAD) * BK);
    cp_async_commit();
    const uint8_t* ws = smem + (it % STAGES) * C::STAGE;
    const uint32_t xs = smem_u32(ws + C::W_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t (&af)[2][4] = a[(kk / 16) % 2];
      if constexpr (C::WG) {
        wgmma_wait<1>();  // the group that read this set of A two steps ago is done
        load_a<WT, WP>(af, ws + kk * WP + warp * 32 * C::WB, lane, sp);
        fence_acc();
        wgmma_fence();
        const uint64_t desc = wgmma_desc(xs + kk * 2);  // depths kk .. kk + 15
        const int accumulate = it > 0 || kk > 0;
        wgmma_m64n128k16(reinterpret_cast<float(&)[64]>(acc[0]), af[0], desc, accumulate);
        wgmma_m64n128k16(reinterpret_cast<float(&)[64]>(acc[1]), af[1], desc, accumulate);
        wgmma_commit();
        fence_acc();
      } else if constexpr (NF == 1) {
        load_a<WT, WP>(af, ws + kk * WP + warp * 32 * C::WB, lane, sp);
        // lanes 0-7: rows 0-7 at depth kk; lanes 8-15: rows 0-7 at kk + 8
        uint32_t b[2];
        ldsm_x2(b, xs + (lane % 8) * XP + (kk + 8 * ((lane / 8) % 2)) * 2);
        mma16816(acc[0][0], af[0], b[0], b[1]);
        mma16816(acc[1][0], af[1], b[0], b[1]);
      } else {
        load_a<WT, WP>(af, ws + kk * WP + warp * 32 * C::WB, lane, sp);
#pragma unroll
        for (int n = 0; n < NF; n += 2) {
          // lanes 8q + i: row 8 (n + q / 2) + i at depth kk + 8 (q % 2)
          uint32_t b[4];
          const int q = lane / 8;
          ldsm_x4(b, xs + (8 * (n + q / 2) + lane % 8) * XP + (kk + 8 * (q % 2)) * 2);
          mma16816(acc[0][n], af[0], b[0], b[1]);
          mma16816(acc[1][n], af[1], b[0], b[1]);
          mma16816(acc[0][n + 1], af[0], b[2], b[3]);
          mma16816(acc[1][n + 1], af[1], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (C::WG) {
    wgmma_wait<0>();
    fence_acc();
  }

  // Thread (g, t) holds, for row 8n + 2t + h of the tile (h = 0, 1), the
  // columns 4g .. 4g + 3 of the warp's 32: tile 0 row g, tile 0 row g + 8,
  // tile 1 row g, tile 1 row g + 8 = accumulators (j, e) (0, h), (0, 2 + h),
  // (1, h), (1, 2 + h).
  const int cw = warp * 32 + 4 * g;  // the block's column of this thread's first
  auto quad = [&](int n, int h) {
    return make_float4(acc[0][n][h], acc[0][n][2 + h], acc[1][n][h], acc[1][n][2 + h]);
  };
  auto store4 = [&](int row, int cb, float4 v) {  // 4 outputs at column c0 + cb
    const int c = c0 + cb;
    bf16* o = out + (size_t)(r0 + row) * f + c;
    if (c + 4 <= f && f % 4 == 0) {
      uint2 u;
      u.x = pack_bf16(v.x, v.y);
      u.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(o) = u;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < f) o[j] = __float2bfloat16(vv[j]);
    }
  };
  if (nsplit == 1) {
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) store4(8 * n + 2 * t + h, cw, quad(n, h));
    return;
  }

  // split-K: this split's fp32 tile to scratch [tile][split][TM][BM], then
  // the last split of the tile to arrive sums them in split order
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* mine = part + (tile * nsplit + split) * TM * BM;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(mine + (8 * n + 2 * t + h) * BM + cw) = quad(n, h);
  __threadfence();  // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + tile, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* tp = part + tile * nsplit * TM * BM;
  for (int i = tid; i < TM * BM / 4; i += THREADS) {
    float4 sum = __ldcg(reinterpret_cast<const float4*>(tp) + i);
    for (int s = 1; s < nsplit; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(tp + (size_t)s * TM * BM) + i);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    store4(i / (BM / 4), (i % (BM / 4)) * 4, sum);
  }
  if (tid == 0) tickets[tile] = 0;
}

template <int WT, int TM>
int launch_tm(const void* x, const void* w, const float* scale, const int* te, const int* live,
              void* out, float* part, int* tickets, int M, int d, int f, int chunk, bool w_vec,
              bool x_vec, cudaStream_t stream) {
  using C = Cfg<WT, TM>;
  cudaError_t err = tva_allow_smem(tc_kernel<WT, TM>, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f + BM - 1) / BM, M / TM, (d + chunk - 1) / chunk);
  tc_kernel<WT, TM><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const typename WTraits<WT>::T*>(w), scale, te,
      live, static_cast<bf16*>(out), part, tickets, d, f, chunk, w_vec, x_vec);
  return (int)cudaGetLastError();
}

template <int WT>
int launch(const void* x, const void* w, const float* scale, const int* te, const int* live,
           void* out, float* part, int* tickets, int M, int d, int f, int tm, int chunk,
           bool w_vec, bool x_vec, cudaStream_t s) {
  switch (tm) {
    case 8: return launch_tm<WT, 8>(x, w, scale, te, live, out, part, tickets, M, d, f, chunk, w_vec, x_vec, s);
    case 16: return launch_tm<WT, 16>(x, w, scale, te, live, out, part, tickets, M, d, f, chunk, w_vec, x_vec, s);
    case 32: return launch_tm<WT, 32>(x, w, scale, te, live, out, part, tickets, M, d, f, chunk, w_vec, x_vec, s);
    case 64: return launch_tm<WT, 64>(x, w, scale, te, live, out, part, tickets, M, d, f, chunk, w_vec, x_vec, s);
    case 128: return launch_tm<WT, 128>(x, w, scale, te, live, out, part, tickets, M, d, f, chunk, w_vec, x_vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x (M, d), w (E, d, f) [+ scale (E, 1, f) fp32 for w_dtype 2, int8],
// tile_expert (M / tm,) int32, live_rows (1,) int32 or null -> out (M, f) in
// x's dtype. M is a multiple of tm, a power of two in [8, 128]; tile_expert
// entries lie in [0, E). x_dtype: 0 bf16, 1 fp32; w_dtype: 0 bf16, 1 fp32,
// 2 int8. `chunk`: the depth a split covers, a multiple of 64 (d or more:
// one split); with more than one split (bf16 x, bf16 or int8 w only),
// `part` is fp32 scratch of M * ceil(f / 128) * 128 * splits floats and
// `tickets` M / tm * ceil(f / 128) int32 counters, all 0 (the launch leaves
// them 0).
extern "C" int tva_grouped_matmul(const void* x, const void* w, const float* scale,
                                  const int* tile_expert, const int* live_rows, void* out,
                                  void* part, void* tickets, int M, int d, int f, int tm,
                                  int chunk, int x_dtype, int w_dtype, void* stream) {
  if (M <= 0 || d <= 0 || f <= 0 || tm < 8 || tm > 128 || (tm & (tm - 1)) || M % tm ||
      chunk <= 0 || chunk % tc::BK)
    return (int)cudaErrorInvalidValue;
  if (w_dtype == TVA_W_INT8 && scale == nullptr) return (int)cudaErrorInvalidValue;
  const bool split = chunk < d;
  const bool tensor_cores =
      x_dtype == TVA_DTYPE_BF16 && (w_dtype == TVA_DTYPE_BF16 || w_dtype == TVA_W_INT8);
  if (split && (!tensor_cores || part == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const int wsize = w_dtype == TVA_W_INT8 ? 1 : (w_dtype == TVA_DTYPE_BF16 ? 2 : 4);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w), xp = reinterpret_cast<uintptr_t>(x);
  if (tensor_cores) {
    // 16-byte copies need every row of the plane (and of x) on the 16-byte grid
    const bool w_vec = (size_t)f * wsize % 16 == 0 && wp % 16 == 0;
    const bool x_vec = d % 8 == 0 && xp % 16 == 0;
    float* pp = split ? static_cast<float*>(part) : nullptr;
    int* tk = split ? static_cast<int*>(tickets) : nullptr;
    if (w_dtype == TVA_W_INT8)
      return tc::launch<TVA_W_INT8>(x, w, scale, tile_expert, live_rows, out, pp, tk, M, d, f, tm,
                                    chunk, w_vec, x_vec, s);
    return tc::launch<TVA_DTYPE_BF16>(x, w, scale, tile_expert, live_rows, out, pp, tk, M, d, f,
                                      tm, chunk, w_vec, x_vec, s);
  }
  // vector loads of VEC weights need rows aligned to VEC elements
  const bool vec_ok = f % simt::VEC == 0 && wp % (simt::VEC * wsize) == 0;
  if (x_dtype == TVA_DTYPE_BF16)  // fp32 weights
    return simt::launch<__nv_bfloat16, TVA_DTYPE_F32>(x, w, scale, tile_expert, live_rows, out, M,
                                                     d, f, tm, vec_ok, s);
  if (x_dtype == TVA_DTYPE_F32) {
    switch (w_dtype) {
      case TVA_DTYPE_BF16:
        return simt::launch<float, TVA_DTYPE_BF16>(x, w, scale, tile_expert, live_rows, out, M, d, f, tm, vec_ok, s);
      case TVA_W_INT8:
        return simt::launch<float, TVA_W_INT8>(x, w, scale, tile_expert, live_rows, out, M, d, f, tm, vec_ok, s);
      case TVA_DTYPE_F32:
        return simt::launch<float, TVA_DTYPE_F32>(x, w, scale, tile_expert, live_rows, out, M, d, f, tm, vec_ok, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
