// Shared device code of the exact FFT kernels (exact_mag_gen.cu,
// exact_mag3.cu, exact_cfft.cu).
//
// Every rounding is spelled out with __fmul_rn/__fadd_rn/__fsub_rn, and the
// build passes -fmad=false, so the error-free transforms (TwoSum, Veltkamp/
// Dekker TwoProd) stay error-free and the plain PyTorch twins in
// kernels/exact_cuda.py give the same bits.
//
// The df tier's pieces (slice_serial, recombine_df, df_mul, twiddle_df_v,
// stage2_slice_df_into, mag_df) serve the complex kernel exact_cfft.cu and
// the df instances of exact_mag_gen.cu and exact_mag3.cu; they are the
// arithmetic of kernels/exactfft.py's _slice_df, _digit_gemm and df_mul, and
// of the df branches of exact_pallas.py's _real_mag_tail and _tail_stage2.
//
// Stage 2 is a DFT over j2 of rows of 256 values [br | bi]: per row one
// pow2 scale from the hi words, the digit slice (f32 tier: the fast
// fixed-point extract of f32 values, stage2_slice_into; df tier: the serial
// slice of (hi, lo), stage2_slice_df_into), then 10 exact int8 digit-pair
// products on the int8 tensor cores (stage2_mma, mma.sync).  The real-split
// kernels (K2, K2-df, K1-gen, K1-df) keep the half k2 < 64 and end in
// stage2_mag_mma: the f32 tier's ((w0 + w1) + w2) + w3, a clamp to +-2^63
// and sqrt(cr^2 + ci^2), or the df tier's TwoSum recombination, the clamp of
// the hi words and mag_df.  K3 (exact_cfft.cu) keeps every k2 and stores
// the TwoSum recombination as df32.  Every stage 1 runs digit_wgmma.  The
// int32 class sums of int8 products are exact in any order, so every bit
// equals the twins'.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wf {

constexpr int kLanes = 128;          // N2: stage-2 transform length
constexpr int kKeep = 64;            // kept stage-2 bins per re/im half
constexpr int kRow2 = 2 * kLanes;    // stage-2 contraction depth [br | bi]
constexpr int kWords2 = kRow2 / 4;   // packed int8x4 words per stage-2 row
constexpr int kThreads = 256;
constexpr int kDigits = 4;           // digit planes (pairs i + j <= 3)
constexpr int kTop = 27;             // fixed-point bits of the slice
constexpr int kBias = (64 << 21) + (64 << 14) + (64 << 7) + 64;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// max that keeps a NaN: a NaN lane must poison its own scale (as the
// reference's max does) rather than be skipped the way fmaxf skips it
__device__ __forceinline__ float nanmax(float a, float b) {
  if (a != a) return a;
  return (b != b || b > a) ? b : a;
}

// (s, 1/s) = 2^e, e = clip(ceil(log2(max(m, 1e-30))) + 1, -125, 125),
// with ceil(log2) read exactly from the exponent and mantissa bits.
__device__ __forceinline__ void pow2_scale(float m, float* s, float* s_inv) {
  if (m != m) {
    *s = m;
    *s_inv = m;
    return;
  }
  m = fmaxf(m, 1e-30f);
  const int bits = __float_as_int(m);
  int e = ((bits >> 23) & 255) - 127 + ((bits & 0x7fffff) != 0) + 1;
  e = min(max(e, -125), 125);
  *s = __int_as_float((e + 127) << 23);
  *s_inv = __int_as_float((127 - e) << 23);
}

// rint(v * s_inv * 2^27) as int32, NaN -> 0 (the conversion's own rule)
__device__ __forceinline__ int fixed27(float v, float s_inv) {
  return __float2int_rn(fmul(fmul(v, s_inv), 134217728.0f));
}

// digit k of the offset-binary fields of u = i + BIAS, as a byte
__device__ __forceinline__ uint32_t digit_byte(int u, int k) {
  const int sh = kTop - 6 - 7 * k;
  return static_cast<uint32_t>(((u >> sh) & 127) - 64) & 0xffu;
}

// class sums -> f32: ((w0 + w1) + w2) + w3, w_t = acc_t * (2^-(12+7t) * s)
__device__ __forceinline__ float recombine(const int acc[kDigits], float s) {
  const float w0 = fmul(__int2float_rn(acc[0]), fmul(0x1p-12f, s));
  const float w1 = fmul(__int2float_rn(acc[1]), fmul(0x1p-19f, s));
  const float w2 = fmul(__int2float_rn(acc[2]), fmul(0x1p-26f, s));
  const float w3 = fmul(__int2float_rn(acc[3]), fmul(0x1p-33f, s));
  return fadd(fadd(fadd(w0, w1), w2), w3);
}

// clamp to +-2^63 that lets a NaN through
__device__ __forceinline__ float clamp63(float v) {
  const float lim = 0x1p63f;
  return v < -lim ? -lim : (v > lim ? lim : v);
}

// Veltkamp split (12-bit halves) and Dekker TwoProd, without fma
__device__ __forceinline__ void vsplit(float a, float* h, float* l) {
  const float t = fmul(4097.0f, a);
  *h = fsub(t, fsub(t, a));
  *l = fsub(a, *h);
}

__device__ __forceinline__ void two_sum(float a, float b, float* s, float* e) {
  *s = fadd(a, b);
  const float bb = fsub(*s, a);
  *e = fadd(fsub(a, fsub(*s, bb)), fsub(b, bb));
}

// a * b = p + e exactly (Dekker, Veltkamp splits of both operands)
__device__ __forceinline__ void two_prod(float a, float b, float* p, float* e) {
  *p = fmul(a, b);
  float ah, al, bh, bl;
  vsplit(a, &ah, &al);
  vsplit(b, &bh, &bl);
  *e = fadd(fadd(fadd(fsub(fmul(ah, bh), *p), fmul(ah, bl)), fmul(al, bh)),
            fmul(al, bl));
}

// (ah, al) + (bh, bl) as a double-float: TwoSum of the highs, the lows
// added into the error, TwoSum again
__device__ __forceinline__ void df_add(float ah, float al, float bh, float bl,
                                       float* h, float* l) {
  float s, e;
  two_sum(ah, bh, &s, &e);
  two_sum(s, fadd(e, fadd(al, bl)), h, l);
}

// (ah, al) * (bh, bl) as a double-float: TwoProd of the highs, the cross
// terms added into the error, TwoSum
__device__ __forceinline__ void df_mul(float ah, float al, float bh, float bl,
                                       float* h, float* l) {
  float p, e;
  two_prod(ah, bh, &p, &e);
  two_sum(p, fadd(e, fadd(fmul(ah, bl), fmul(al, bh))), h, l);
}

// x * (w_hi + w_lo) as a double-float (hi, lo)
__device__ __forceinline__ void windowed_df(float x, float wh, float wl,
                                            float* hi, float* lo) {
  float p, e;
  two_prod(x, wh, &p, &e);
  two_sum(p, fadd(e, fmul(x, wl)), hi, lo);
}

// Serial 4-digit slice of (hi, lo) scaled by the power of two s_inv:
// digit k = rint(r * 2^(6+7k)) (half to even), r -= digit * 2^-(6+7k); the
// lo word joins the residual at k = 3.  |r| <= 1/2 keeps the digits within
// +-68: they fit int8.
__device__ __forceinline__ void slice_serial(float hi, float lo, float s_inv,
                                             int d[kDigits]) {
  float r = fmul(hi, s_inv);
#pragma unroll
  for (int k = 0; k < kDigits; ++k) {
    if (k == 3) r = fadd(r, fmul(lo, s_inv));
    const float sc = static_cast<float>(1 << (6 + 7 * k));
    const float dk = rintf(fmul(r, sc));
    d[k] = static_cast<int>(dk);
    r = fsub(r, fmul(dk, 1.0f / sc));
  }
}

// class sums -> df32: w_t = acc_t * (2^-(12+7t) * s),
// TwoSum(w0, (w3 + w2) + w1)
__device__ __forceinline__ void recombine_df(const int acc[kDigits], float s,
                                             float* h, float* l) {
  const float w0 = fmul(__int2float_rn(acc[0]), fmul(0x1p-12f, s));
  const float w1 = fmul(__int2float_rn(acc[1]), fmul(0x1p-19f, s));
  const float w2 = fmul(__int2float_rn(acc[2]), fmul(0x1p-26f, s));
  const float w3 = fmul(__int2float_rn(acc[3]), fmul(0x1p-33f, s));
  two_sum(w0, fadd(fadd(w3, w2), w1), h, l);
}

// a * b as a double-float with both operands' Veltkamp splits in hand
// (exact_pallas.py's mul_ps): equal to df_mul when (bh, bl) is b0's split
__device__ __forceinline__ void mul_ps(float a0, float a1, float ah, float al,
                                      float b0, float b1, float bh, float bl,
                                      float* h, float* l) {
  const float p = fmul(a0, b0);
  const float e = fadd(fadd(fadd(fsub(fmul(ah, bh), p), fmul(ah, bl)),
                            fmul(al, bh)),
                       fmul(al, bl));
  two_sum(p, fadd(e, fadd(fmul(a0, b1), fmul(a1, b0))), h, l);
}

// The df tier's outer twiddle (_real_mag_tail): (br + i*bi) =
// (ar + i*ai) * (tr + i*ti) in double-floats, the twiddle given as its
// planes (hi, lo, Veltkamp-high half of hi): the twiddle's halves come from
// the host, only the data is split here.
__device__ __forceinline__ void twiddle_df_v(float arh, float arl, float aih,
                                             float ail, float trh, float trl,
                                             float trH, float tih, float til,
                                             float tiH, float* brh, float* brl,
                                             float* bih, float* bil) {
  const float trL = fsub(trh, trH), tiL = fsub(tih, tiH);
  float arH, arL, aiH, aiL;
  vsplit(arh, &arH, &arL);
  vsplit(aih, &aiH, &aiL);
  float prh, prl, pih, pil, qrh, qrl, qih, qil;
  mul_ps(arh, arl, arH, arL, trh, trl, trH, trL, &prh, &prl);
  mul_ps(aih, ail, aiH, aiL, tih, til, tiH, tiL, &pih, &pil);
  mul_ps(arh, arl, arH, arL, tih, til, tiH, tiL, &qrh, &qrl);
  mul_ps(aih, ail, aiH, aiL, trh, trl, trH, trL, &qih, &qil);
  df_add(prh, prl, -pih, -pil, brh, brl);
  df_add(qrh, qrl, qih, qil, bih, bil);
}

// _tail_stage2's df magnitude of the clamped (cr, ci): rr = cr^2, ii = ci^2
// as double-floats, (s0, e0) = TwoSum(rr.hi, ii.hi),
// sqrt(max(s0 + ((e0 + rr.lo) + ii.lo), 0)); a NaN passes through
__device__ __forceinline__ float mag_df(float crh, float crl, float cih,
                                       float cil) {
  float rrh, rrl, iih, iil, s0, e0;
  df_mul(crh, crl, crh, crl, &rrh, &rrl);
  df_mul(cih, cil, cih, cil, &iih, &iil);
  two_sum(rrh, iih, &s0, &e0);
  const float v = fadd(s0, fadd(fadd(e0, rrl), iil));
  return sqrtf(v < 0.0f ? 0.0f : v);
}

// Stage-2 slice into any word layout, one warp per row: the 256 f32 values
// [br | bi] of each row r < kRows (at row(r)) get one pow2 scale
// (row_scale[r] = s) and their packed digit words, word(r, k, w) = word w of
// digit plane k (w < kWords2, four consecutive values).  The block's
// kThreads threads call it.
template <int kRows, class Row, class Word>
__device__ __forceinline__ void stage2_slice_into(Row row, float* row_scale,
                                                  Word word) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const float4 v0 = reinterpret_cast<const float4*>(row(r))[2 * lane];
    const float4 v1 = reinterpret_cast<const float4*>(row(r))[2 * lane + 1];
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    float rm = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) rm = nanmax(rm, fabsf(v[q]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rm = nanmax(rm, __shfl_xor_sync(0xffffffffu, rm, off));
    float s2, s2_inv;
    pow2_scale(rm, &s2, &s2_inv);
    uint32_t packed[kDigits][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int u = fixed27(v[q], s2_inv) + kBias;
#pragma unroll
      for (int k = 0; k < kDigits; ++k)
        packed[k][q >> 2] |= digit_byte(u, k) << (8 * (q & 3));
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kDigits; ++k) {
      word(r, k, 2 * lane) = static_cast<int>(packed[k][0]);
      word(r, k, 2 * lane + 1) = static_cast<int>(packed[k][1]);
    }
    if (lane == 0) row_scale[r] = s2;
  }
}

// The df tier's stage-2 slice into any word layout, one warp per row: flat
// rows R = row_of(r), r < kRows, of the (hi, lo) planes `rows` (hi at rows
// + R*kRow2, lo `plane` floats further) each get one pow2 scale from their
// 256 hi words (row_scale[r] = s) and the serial slice into packed digit
// words word(r, k, w); rows from `total` on get zero words.  The block's
// kThreads threads call it.
template <int kRows, class RowOf, class Word>
__device__ __forceinline__ void stage2_slice_df_into(
    const float* __restrict__ rows, size_t plane, RowOf row_of, int total,
    float* row_scale, Word word) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const size_t R = static_cast<size_t>(row_of(r));
    uint32_t packed[kDigits][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};
    float s2 = 0.0f;
    if (R < static_cast<size_t>(total)) {
      const float4* h4 = reinterpret_cast<const float4*>(rows + R * kRow2);
      const float4* l4 =
          reinterpret_cast<const float4*>(rows + plane + R * kRow2);
      const float4 h0 = h4[2 * lane], h1 = h4[2 * lane + 1];
      const float4 l0 = l4[2 * lane], l1 = l4[2 * lane + 1];
      const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float l[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      float rm = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) rm = nanmax(rm, fabsf(h[q]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rm = nanmax(rm, __shfl_xor_sync(0xffffffffu, rm, off));
      float s2_inv;
      pow2_scale(rm, &s2, &s2_inv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        int d[kDigits];
        slice_serial(h[q], l[q], s2_inv, d);
#pragma unroll
        for (int k = 0; k < kDigits; ++k)
          packed[k][q >> 2] |= (static_cast<uint32_t>(d[k]) & 0xffu)
                               << (8 * (q & 3));
      }
    }
#pragma unroll
    for (int k = 0; k < kDigits; ++k) {
      word(r, k, 2 * lane) = static_cast<int>(packed[k][0]);
      word(r, k, 2 * lane + 1) = static_cast<int>(packed[k][1]);
    }
    if (lane == 0) row_scale[r] = s2;
  }
}

// ---- the int8 tensor cores -------------------------------------------------
//
// wgmma m64n32k32 s8 x s8 -> s32 runs one warpgroup (4 warps) over 64 rows
// (M) x 32 columns (N) x 32 int8 of the contraction (k).  A comes from
// registers, each warp its 16 rows, with g = lane / 4 and t = lane % 4
// (PTX ISA, the mma.m16n8k32 .s8 A layout): a[0], a[2] = row g at k =
// 4t..4t+3 and 16+4t..19+4t, a[1], a[3] = row g + 8; each register one
// int8x4 word of four consecutive k, lowest k in the lowest byte, so the
// port's packed words load as they are.  B comes from shared memory in the
// K-major core-matrix layout without swizzle (cm_word): per k-step a 1 KB
// tile of 4 groups of 8 columns x 2 16-byte halves of the k-step, each a
// core matrix of 8 columns x 16 bytes.  d[4j..4j+3] of column group j hold
// row g at columns 8j + 2t, 8j + 2t + 1, then row g + 8 at the same columns.
// No .satfinite: the class sums stay far inside int32.

// Word of column n, packed word w (of a k-step's 8) in a 1 KB B tile
__device__ __forceinline__ int cm_word(int n, int w) {
  return ((n >> 3) * 2 + ((w >> 2) & 1)) * 32 + (n & 7) * 4 + (w & 3);
}

// Descriptor of a B tile at shared address addr: no swizzle, leading (K)
// byte offset 128 between the two core matrices of a k-step, stride (N)
// byte offset 256 between groups of 8 columns.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory stores made by the threads, visible to wgmma's reads (the
// async proxy); a __syncthreads() follows.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a * b over the warpgroup
__device__ __forceinline__ void wgmma_n32(int d[16], const uint32_t a[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// Compiler fences: the accumulators are not read before wgmma.wait_group,
// and the A registers of a group stay untouched until it has completed.
__device__ __forceinline__ void fence_acc(int d[16]) {
  asm volatile(""
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
                 "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
                 "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
                 "+r"(d[14]), "+r"(d[15])::"memory");
}

__device__ __forceinline__ void keep_a(const uint32_t a[kDigits][4]) {
#pragma unroll
  for (int p = 0; p < kDigits; ++p)
    asm volatile("" ::"r"(a[p][0]), "r"(a[p][1]), "r"(a[p][2]), "r"(a[p][3])
                 : "memory");
}

// The digit GEMMs of one warpgroup: acc[t] (+)= sum over i <= t of A_i B_(t-i)
// over `ksteps` k-steps, the 10 digit pairs of the 4-term split.  load(af,
// ks) fills the warp's A fragments of k-step ks (one per digit plane);
// b_tile(k, ks) is the shared address of the B tile of digit plane k at
// k-step ks.  Each k-step's 10 wgmmas run while the next k-step's A loads.
template <class Load, class BTile>
__device__ __forceinline__ void digit_wgmma(int acc[kDigits][16], int ksteps,
                                            Load load, BTile b_tile) {
  uint32_t a0[kDigits][4], a1[kDigits][4];
  auto step = [&](uint32_t (&cur)[kDigits][4], uint32_t (&nxt)[kDigits][4],
                  int ks) {
    wg_fence();
#pragma unroll
    for (int t = 0; t < kDigits; ++t)
#pragma unroll
      for (int i = 0; i <= t; ++i)
        wgmma_n32(acc[t], cur[i], wg_desc(b_tile(t - i, ks)));
    wg_commit();
    if (ks + 1 < ksteps) load(nxt, ks + 1);
    wg_wait0();
#pragma unroll
    for (int t = 0; t < kDigits; ++t) fence_acc(acc[t]);
    keep_a(cur);
  };
  load(a0, 0);
  for (int ks = 0; ks < ksteps; ks += 2) {
    step(a0, a1, ks);
    if (ks + 1 < ksteps) step(a1, a0, ks + 1);
  }
}

// The warp's A fragments of one k-step from a fragment-ordered constant:
// src is the lane's int4 of digit plane 0 at that k-step, the planes lie
// `plane` int4 apart
__device__ __forceinline__ void load_a(uint32_t (&af)[kDigits][4],
                                       const int4* __restrict__ src,
                                       size_t plane) {
#pragma unroll
  for (int p = 0; p < kDigits; ++p) {
    const int4 v = __ldg(src + p * plane);
    af[p][0] = static_cast<uint32_t>(v.x);
    af[p][1] = static_cast<uint32_t>(v.y);
    af[p][2] = static_cast<uint32_t>(v.z);
    af[p][3] = static_cast<uint32_t>(v.w);
  }
}

// One int8 tensor-core product c += a * b of mma.sync m16n8k32 (A 16x32
// row-major, B 32x8 column-major, C 16x8 int32), with g = lane / 4 and
// t = lane % 4: a as wgmma's A above; b[0], b[1] = column g at k =
// 4t..4t+3 and 16+4t..19+4t; c[0], c[1] = row g at columns 2t, 2t+1, c[2],
// c[3] = row g+8.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage 2's digit products on the tensor cores (mma.sync) over kRows sliced
// rows (kRows % 32 == 0, rows kStride words apart, kStride % 32 == 4 so the
// A loads are free of bank conflicts), against the f2 digits in B-fragment
// order f2b [4][8 k-steps][kTiles N tiles][32 lanes][2] (exact_cuda._frag_b2:
// one 8-byte __ldg per lane is one B fragment), whose first kTiles / 2 N
// tiles are re columns and the rest the im columns of the same k2: warp w
// runs N tiles tile0 + w (re columns k2 = 8*(tile0 + w) .. + 7) and
// tile0 + w + kTiles / 2 (im, the same k2), so each thread holds re and im
// of its (row, k2).  A = the rows' data digit words from shared memory.
// Class t sums the products data digit t - i by f2 digit i.  sums(r, k2,
// cre, cim) receives the int32 class sums of row r at re and im column k2.
// The block's kThreads threads call it.
template <int kRows, int kStride, int kTiles, class Sums>
__device__ __forceinline__ void stage2_mma(const int (*words)[kStride],
                                           const int* __restrict__ f2b,
                                           int tile0, Sums sums) {
  static_assert(kThreads == 256 && kRows % 32 == 0 && kStride % 32 == 4,
                "stage2_mma: 8 warps, 32-row passes, padded rows");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane >> 2, tl = lane & 3;
  const int2* bsrc = reinterpret_cast<const int2*>(f2b) + lane;
  for (int m0 = 0; m0 < kRows; m0 += 32) {
    int acc[2][2][kDigits][4];            // [M tile][re, im][class][c reg]
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < kDigits; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][h][t][q] = 0;
    for (int ks = 0; ks < kWords2 / 8; ++ks) {
      uint32_t bf[2][kDigits][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < kDigits; ++p) {
          const int2 v = __ldg(bsrc + ((p * (kWords2 / 8) + ks) * kTiles +
                                       tile0 + warp + kTiles / 2 * h) *
                                          32);
          bf[h][p][0] = static_cast<uint32_t>(v.x);
          bf[h][p][1] = static_cast<uint32_t>(v.y);
        }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int* r0 = words[m0 + 16 * m + gl] + ks * 8 + tl;
        const int* r1 = words[m0 + 16 * m + 8 + gl] + ks * 8 + tl;
        uint32_t af[kDigits][4];
#pragma unroll
        for (int p = 0; p < kDigits; ++p) {
          af[p][0] = static_cast<uint32_t>(r0[p * kWords2]);
          af[p][1] = static_cast<uint32_t>(r1[p * kWords2]);
          af[p][2] = static_cast<uint32_t>(r0[p * kWords2 + 4]);
          af[p][3] = static_cast<uint32_t>(r1[p * kWords2 + 4]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < kDigits; ++t)
#pragma unroll
            for (int i = 0; i <= t; ++i)
              mma_s8(acc[m][h][t], af[t - i], bf[h][i]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {       // c reg: row half q / 2, column q % 2
        int cre[kDigits], cim[kDigits];
#pragma unroll
        for (int t = 0; t < kDigits; ++t) {
          cre[t] = acc[m][0][t][q];
          cim[t] = acc[m][1][t][q];
        }
        sums(m0 + 16 * m + gl + 8 * (q >> 1),
             8 * (tile0 + warp) + 2 * tl + (q & 1), cre, cim);
      }
  }
}

// The real-split kernels' stage 2 (K2, K2-df, K1-gen, K1-df): stage2_mma
// over the kept half (f2b with 16 N tiles: k2 < 64, re then im), then the
// magnitude of each (row r, kept bin k2), clamped as the tier does, handed
// to emit(r, k2, m).
template <int kRows, int kStride, bool kDf, class Emit>
__device__ __forceinline__ void stage2_mag_mma(const int (*words)[kStride],
                                               const float* row_scale,
                                               const int* __restrict__ f2b,
                                               Emit emit) {
  stage2_mma<kRows, kStride, 2 * kKeep / 8>(
      words, f2b, 0,
      [&](int r, int k2, const int (&cre)[kDigits],
          const int (&cim)[kDigits]) {
        const float s2 = row_scale[r];
        if constexpr (kDf) {
          float crh, crl, cih, cil;
          recombine_df(cre, s2, &crh, &crl);
          recombine_df(cim, s2, &cih, &cil);
          emit(r, k2, mag_df(clamp63(crh), crl, clamp63(cih), cil));
        } else {
          const float cr = clamp63(recombine(cre, s2));
          const float ci = clamp63(recombine(cim, s2));
          emit(r, k2, sqrtf(fadd(fmul(cr, cr), fmul(ci, ci))));
        }
      });
}

}  // namespace wf
