// Tensor-core building blocks shared by the attention kernels (B1 forward in
// attention_fwd.cu, B2 backward in attention_bwd.cu) for Hopper (sm_90a):
// a cp.async tile loader with zero fill, mma.sync wrappers, split-TF32, and
// the fragment loaders that put shared-memory tiles and accumulators into the
// operand layouts of mma.sync.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8/.m16n8k16"),
// for lane = 4 * g + t (g = groupID 0..7, t = threadID_in_group 0..3):
//   accumulator C (16 x 8):        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   m16n8k8 .tf32 A (16 x 8):      a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   m16n8k8 .tf32 B (8 x 8, k x n): b0 (t, g)  b1 (t+4, g)
//   m16n8k16 .bf16 A (16 x 16):    a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   m16n8k16 .bf16 B (16 x 8):     b0 (2t..2t+1, g)  b1 (2t+8.., g)
//
// f32 operands go through the tensor cores as split-TF32: x = big + small with
// big = tf32(x) and small = tf32(x - big), and a * b is taken as
// small_a * big_b + big_a * small_b + big_a * big_b, which represents each
// operand to about 2^-22 relative and drops only small_a * small_b (about
// 2^-22 of the product). That is the tensor-core policy of PyTorch's
// memory-efficient attention in f32 (CUTLASS's OpMultiplyAddFastF32). One
// pass of TF32 alone keeps about 2^-11 of each operand, which at scores of
// |s| ~ 25 is ~1e-3 -- above the kernels' f32 tolerance.
//
// An accumulator becomes the A operand of the next product without a shuffle:
//   bf16: two 8-column accumulators pack into one 16-column A (FA2's trick);
//   f32:  the accumulator holds columns 2t, 2t+1 where A wants t, t+4, so the
//         k order of that product is permuted instead: k slot t <- column 2t,
//         k slot t+4 <- column 2t+1, and the B operand reads its k rows 2t and
//         2t+1 to match (b_kn_f32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace ieagan {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // rows of a block's own tile and of each ring stage
constexpr int kStages = 2;  // depth of the cp.async ring
// The most dynamic shared memory a block may take for two blocks to share an
// SM: 228 KB per SM, less 1 KB that the card reserves per block, halved.
constexpr int kTwoBlockBytes = (233472 - 2 * 1024) / 2;
constexpr int kMaxD = 128;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The head widths the kernels are instantiated for: each width is padded up
// to 32, 64 or 128 (zero fill) and the pair (padded dk, padded dv) picks the
// instance. Every pair is built, so every dk, dv <= 128 has one.
#define IEAGAN_ATTENTION_WIDTHS(X) \
  X(32, 32) X(32, 64) X(32, 128) X(64, 32) X(64, 64) X(64, 128) X(128, 32) X(128, 64) X(128, 128)

__host__ __device__ constexpr int padded_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// Row stride of a shared-memory tile, in elements. f32: D + 4, so that the
// scalar fragment reads -- (row g, col t) and (row 2t, col g) -- fall in 32
// distinct banks. bf16: D + 8, so that the eight 16-byte rows of an ldmatrix
// 8x8 matrix fall in distinct bank groups. Both keep rows 16-byte aligned
// for cp.async.
template <typename T>
__host__ __device__ constexpr int row_stride(int d) {
  return std::is_same<T, float>::value ? d + 4 : d + 8;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------------- copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0: no
// byte is read, `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + kTile - 1 of a row-major (n_rows, width) tensor `src` into
// the tile `dst` (row stride row_stride<T>(D)); rows at or past n_rows and
// columns at or past width read as zeros. `vec`: width * sizeof(T) and `src`
// are 16-byte aligned, so each row goes as 16-byte cp.async copies; else
// element by element, synchronously (odd widths only).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int n_rows, int width,
                                          bool vec) {
  constexpr int S = row_stride<T>(D);
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T);  // elements per copy
    constexpr int kChunks = D / kChunk;     // copies per row
#pragma unroll 4
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kChunk;
      const bool ok = r0 + r < n_rows && c < width;
      cp_async16(dst + r * S + c, ok ? src + static_cast<long long>(r0 + r) * width + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * S + c] = r0 + r < n_rows && c < width
                           ? src[static_cast<long long>(r0 + r) * width + c]
                           : from_f32<T>(0.f);
    }
  }
}

// kTile f32 row statistics (lse or delta) from row r0 on, zeros past n_rows.
__device__ __forceinline__ void load_stats(float* dst, const float* src, int r0, int n_rows) {
  const int i = threadIdx.x;
  if (i < kTile) {
    const bool ok = r0 + i < n_rows;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// ------------------------------------------------------------- mma.sync

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as big + small, each a TF32 operand rounded half away from zero (the
// values of cvt.rna.tf32.f32). The tensor cores read a .tf32 operand's upper
// 19 bits and drop the low 13, so adding half a TF32 ulp (0x1000) to the bit
// pattern is enough to round it (CUTLASS's round_half_ulp_truncate); only
// the subtraction needs big with its low bits cleared. Four integer and f32
// operations in all: cvt.rna.tf32.f32 also handles NaN and infinity and
// costs several instructions itself, and the split is the f32 kernels'
// most frequent work.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const uint32_t b = __float_as_uint(x) + 0x1000u;
  big = b;
  small = __float_as_uint(x - __uint_as_float(b & 0xffffe000u)) + 0x1000u;
}

// An f32 operand of one m16n8k8 product, split.
struct SplitA {
  uint32_t big[4], small[4];
};
struct SplitB {
  uint32_t big[2], small[2];
};

// d += a * b in split-TF32: three tensor-core products (small terms first)
// into a fresh zero partial, which is then added to d in f32 with rounding to
// nearest. The tensor cores' own f32 accumulation truncates: chained straight
// into d, the twelve products of q·kᵀ at dk 32 and |s| ~ 25 can drift by up
// to 12 * 2^-23 * 25 ~ 4e-5, always towards zero, and dS = p (dP - delta)
// multiplies that by |dP - delta| ~ 30, past the f32 tolerance of B2. Through
// the partial, a truncation only ever applies to one step's eight products.
__device__ __forceinline__ void mma_split(float (&d)[4], const SplitA& a, const SplitB& b) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a.small, b.big[0], b.big[1]);
  mma_tf32(part, a.big, b.small[0], b.small[1]);
  mma_tf32(part, a.big, b.big[0], b.big[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two f32 values as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi),
// together ~2^-17 of x.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// ------------------------------------------------------------- fragments, f32
// Tiles are row-major in shared memory with row stride S (elements).

__device__ __forceinline__ int lane_g() { return (threadIdx.x % 32) / 4; }
__device__ __forceinline__ int lane_t() { return threadIdx.x % 4; }

// f32 fragments through ldmatrix: on pairs of b16 an 8x8 matrix is 8 rows
// of 4 f32, and lane 4g + t receives row g, f32 column t -- the (g, t) layout
// of the tf32 A and B fragments. One ldmatrix.x4 thus fetches a whole A
// fragment, or the B fragments of two n tiles, in place of four scalar loads
// and their address arithmetic. Being volatile asm it is also never merged
// or hoisted, so the A fragments of a block's resident tile are re-read for
// every product instead of being kept live (8 registers per k step, 160 at
// dk + dv = 160, which would spill).
__device__ __forceinline__ void split4(const uint32_t (&r)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), big[i], small[i]);
}

// A = tile[r0 .. r0+15][c0 .. c0+7].
template <int S>
__device__ __forceinline__ SplitA a_rows_f32(const float* tile, int r0, int c0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  uint32_t r[4];
  ldmatrix_x4(r, tile + (r0 + (mi & 1) * 8 + lane % 8) * S + c0 + (mi >> 1) * 4);
  SplitA a;
  split4(r, a.big, a.small);
  return a;
}

// A from an accumulator (16 x 8), k slots permuted: slot t <- column 2t,
// slot t+4 <- column 2t+1. Pairs with b_kn_f32.
__device__ __forceinline__ SplitA a_acc_f32(const float (&c)[4]) {
  SplitA a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

// B(k, n) = tile[n0 + n][k0 + k] for two n tiles, n0 and n0 + 8 (q·kᵀ: k's
// rows): b[0] for the first, b[1] for the second.
template <int S>
__device__ __forceinline__ void b_nk_f32(SplitB (&b)[2], const float* tile, int n0, int k0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  uint32_t r[4], big[4], small[4];
  ldmatrix_x4(r, tile + (n0 + (mi >> 1) * 8 + lane % 8) * S + k0 + (mi & 1) * 4);
  split4(r, big, small);
  b[0] = {{big[0], big[1]}, {small[0], small[1]}};
  b[1] = {{big[2], big[3]}, {small[2], small[3]}};
}

// B(k, n) = tile[k0 + k][n0 + n] in the permuted k order of a_acc_f32: slot
// t reads row 2t, slot t+4 row 2t+1 (p·v: v's rows).
template <int S>
__device__ __forceinline__ SplitB b_kn_f32(const float* tile, int k0, int n0) {
  const float* p = tile + (k0 + 2 * lane_t()) * S + n0 + lane_g();
  SplitB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[S], b.big[1], b.small[1]);
  return b;
}

// ------------------------------------------------------------- fragments, bf16

// A = tile[r0 .. r0+15][c0 .. c0+15].
template <int S>
__device__ __forceinline__ void a_rows_bf16(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                            int c0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  ldmatrix_x4(a, tile + (r0 + (mi & 1) * 8 + lane % 8) * S + c0 + (mi >> 1) * 8);
}

// A (16 x 16) from two accumulators (columns 0..7 in c0, 8..15 in c1),
// rounded to bf16; the _split form also gives the remainders (a = hi + lo).
__device__ __forceinline__ void a_acc_bf16(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void a_acc_bf16_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                 const float (&c0)[4], const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// B(k, n) = tile[n0 + n][k0 + k] for two n tiles (n0 and n0 + 8) and 16 k:
// b[0], b[1] for the first, b[2], b[3] for the second.
template <int S>
__device__ __forceinline__ void b_nk_bf16(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  ldmatrix_x4(b, tile + (n0 + (mi >> 1) * 8 + lane % 8) * S + k0 + (mi & 1) * 8);
}

// B(k, n) = tile[k0 + k][n0 + n] for two n tiles and 16 k, via ldmatrix.trans.
template <int S>
__device__ __forceinline__ void b_kn_bf16(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  ldmatrix_x4_trans(b, tile + (k0 + (mi & 1) * 8 + lane % 8) * S + n0 + (mi >> 1) * 8);
}

// ------------------------------------------------------------- products
// acc[n] (16 x 8 each) += A · Bᵀ over the head width D, with A = rows
// a_r0 .. a_r0+15 of tile `a` (or A's fragments, already in registers) and
// B's n tiles = rows b_n0 + 8n of tile `b`: q·kᵀ, dO·vᵀ and their
// transposes. NT is the number of 8-column n tiles.
template <int D, int S, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const SplitA (&fa)[D / 8],
                                        const float* b, int b_n0) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n tiles");
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      SplitB fb[2];
      b_nk_f32<S>(fb, b, b_n0 + 8 * n, 8 * kk);
      mma_split(acc[n], fa[kk], fb[0]);
      mma_split(acc[n + 1], fa[kk], fb[1]);
    }
}

template <int D, int S, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const float* a, int a_r0,
                                        const float* b, int b_n0) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n tiles");
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const SplitA fa = a_rows_f32<S>(a, a_r0, 8 * kk);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      SplitB fb[2];
      b_nk_f32<S>(fb, b, b_n0 + 8 * n, 8 * kk);
      mma_split(acc[n], fa, fb[0]);
      mma_split(acc[n + 1], fa, fb[1]);
    }
  }
}

template <int D, int S, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&fa)[D / 16][4],
                                        const __nv_bfloat16* b, int b_n0) {
  static_assert(NT % 2 == 0, "bf16 B fragments come in pairs of n tiles");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t fb[4];
      b_nk_bf16<S>(fb, b, b_n0 + 8 * n, 16 * kk);
      mma_bf16(acc[n], fa[kk], fb[0], fb[1]);
      mma_bf16(acc[n + 1], fa[kk], fb[2], fb[3]);
    }
}

template <int D, int S, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* a, int a_r0,
                                        const __nv_bfloat16* b, int b_n0) {
  static_assert(NT % 2 == 0, "bf16 B fragments come in pairs of n tiles");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    a_rows_bf16<S>(fa, a, a_r0, 16 * kk);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t fb[4];
      b_nk_bf16<S>(fb, b, b_n0 + 8 * n, 16 * kk);
      mma_bf16(acc[n], fa, fb[0], fb[1]);
      mma_bf16(acc[n + 1], fa, fb[2], fb[3]);
    }
  }
}

// out[n] (16 x 8 each, D / 8 tiles over the width D) += P · tile, where
// P (16 x 8·KT) is held in KT accumulators and tile rows k0 .. k0 + 8·KT - 1
// are B's k rows: p·v, pᵀ·dO, dSᵀ·q, dS·k.
//
// f32: P is taken as TF32 big + small, whatever kSplit says, and each step
// is added through its own partial (mma_split).
//
// bf16: the call's products go into a fresh partial (64 columns at a time)
// that is added to `out` in f32, so the tensor cores' truncating
// accumulation never runs over a whole reduction (dK: 192 steps over Lq =
// 3072). P is rounded to bf16 (kSplit = false: the forward, as FA2 does), or
// taken as bf16 hi + lo, two products (kSplit = true: the backward, whose dK
// and dV sum up to Lq products of p and dS: one bf16 rounding of each moves
// a term of up to ~30 by up to 2^-9 * 30 ~ 0.06, and over many terms whose
// sum cancels to ~1 that is past the bf16 tolerance of 2e-2 + 1e-2 relative).
template <int D, int S, int KT, bool kSplit = false, typename T>
__device__ __forceinline__ void mma_acc_b(float (&out)[D / 8][4], const float (&p)[KT][4],
                                          const T* tile, int k0) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const SplitA fa = a_acc_f32(p[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_split(out[n], fa, b_kn_f32<S>(tile, k0 + 8 * j, 8 * n));
    }
  } else {
    static_assert(KT % 2 == 0, "a bf16 A operand spans two accumulators");
    constexpr int kChunk = D / 8 < 8 ? D / 8 : 8;
#pragma unroll
    for (int c = 0; c < D / 8; c += kChunk) {
      float part[kChunk][4] = {};
#pragma unroll
      for (int j = 0; j < KT; j += 2) {
        uint32_t hi[4], lo[4];
        if constexpr (kSplit)
          a_acc_bf16_split(hi, lo, p[j], p[j + 1]);
        else
          a_acc_bf16(hi, p[j], p[j + 1]);
#pragma unroll
        for (int n = 0; n < kChunk; n += 2) {
          uint32_t fb[4];
          b_kn_bf16<S>(fb, tile, k0 + 8 * j, 8 * (c + n));
          if constexpr (kSplit) {
            mma_bf16(part[n], lo, fb[0], fb[1]);
            mma_bf16(part[n + 1], lo, fb[2], fb[3]);
          }
          mma_bf16(part[n], hi, fb[0], fb[1]);
          mma_bf16(part[n + 1], hi, fb[2], fb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kChunk; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[c + n][e] += part[n][e];
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores a warp's 16 x D accumulator (rows row0 + g, row0 + g + 8 of a
// row-major (n_rows, width) tensor) in T, skipping rows >= n_rows and
// columns >= width; multiplies row r by mul[r].
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], int row0,
                                           int n_rows, int width, const float (&mul)[2]) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    T* out = dst + static_cast<long long>(row) * width;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < width) out[col] = from_f32<T>(acc[n][2 * r] * mul[r]);
      if (col + 1 < width) out[col + 1] = from_f32<T>(acc[n][2 * r + 1] * mul[r]);
    }
  }
}

// One tile's step of a loop over a cp.async ring of kRing stages: with two,
// the next tile's copies are issued before this one is waited for; with one,
// after this one has been consumed. `load(slot, row0)` issues the copies of
// the tile at row0; `compute(slot)` consumes the tile in `slot`.
template <int kRing, typename Load, typename Compute>
__device__ __forceinline__ void ring_step(int it, int n_tiles, Load load, Compute compute) {
  if constexpr (kRing > 1) {
    if (it + 1 < n_tiles) load((it + 1) % kRing, (it + 1) * kTile);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  compute(it % kRing);
  __syncthreads();  // the slot is refilled next
  if constexpr (kRing == 1) {
    if (it + 1 < n_tiles) {
      load(0, (it + 1) * kTile);
      cp_async_commit();
    }
  }
}

// Sets the dynamic shared memory limit of `kernel` on `device` once, before
// its first launch there.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int device, bool (&done)[kMaxDevices]) {
  if (done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace ieagan
