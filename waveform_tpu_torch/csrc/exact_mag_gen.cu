// Exact |rFFT| of channel pairs at every 2-factor size: K1-gen and K1-df.
//
// Replaces waveform_tpu/kernels/exact_pallas.py:525 (_kernel_real_mag) for
// sm_90a at both twiddle tiers.  K1-gen is the f32 tier (fast parallel
// slice) at N1 = N/128 outside {8, 16, 32}: every N1 % 8 == 0 up to 256
// (N <= 32768), where exact_mag.cu's design (one block per stream, one whole
// column per thread in registers, F1's digits resident in shared memory)
// does not fit.  K1-df is the df tier (twiddle == "df": _slice4(exact=True),
// _digit_stage's TwoSum, the Dekker twiddle, _tail_stage2(exact=True)) at
// every N1 % 8 == 0 up to 256, K1's three sizes included.  Both compute,
// with bins in natural order:
//
//   for each stream s and channel c, N = 128*N1, j = 128*j1 + j2:
//     nz[s,c]   = count of raw samples != 0 (before the window)
//     (hi, lo)  = x * (w_hi + w_lo) in double-float (TwoProd + TwoSum)
//     stage 1   = real DFT over j1 of every column j2, [A_r; A_i] = F1r @ x_c,
//                 F1r = [Re f1; Im f1]: exact integer digit products, one
//                 pow2 scale per (s, j2) over both channels; f32: fast slice,
//                 f32 class sum; df: serial slice, TwoSum recombination
//     twiddle   = products with exp(-2*pi*i*k1*j2/N): f32, or double-float
//                 Dekker products (twiddle_df)
//     stage 2   = DFT over j2 of every row (s, c, k1), kept half k2 < 64,
//                 one pow2 scale per row over the hi words of [br | bi]
//     mag[s,c,k1 + N1*k2] = sqrt(cr^2 + ci^2), components clamped to 2^63
//                 (df: the hi words, then mag_df)
//
// Rounding: as exact_mag.cu (-fmad=false, every rounding spelled out in
// exact_common.cuh), so the plain PyTorch twins rfft_pair_mag_ref and
// rfft_pair_mag_df_ref in kernels/exact_cuda.py give the same bits, and at
// the f32 tier so does exact_mag.cu at N1 in {8, 16, 32}.
//
// Bound on this card: int8 multiply-accumulates, 10 digit pairs of the
// 4-term split per product: per stream 5120*N1^2 in stage 1 (two channels,
// 2*N1 rows, N1 deep, 128 columns) and 655,360*N1 in stage 2; the df tier
// adds no MACs.  At the serving slice's shape (N = 6144, S = 256) that is
// 22.1 G int8 ops, 11.2 us at the 1,979 TOP/s int8 peak, against 19.1 MB of
// input and output (5.7 us at 3.35 TB/s): the operations bound the function.
// This design also moves a stage-1 scratch round trip of 2 * S*2*N1*256*4
// bytes (50.3 MB, 15.0 us; twice that at the df tier, whose rows carry lo
// words), which alone would bound it by bytes once the MACs run on the int8
// tensor cores.  At N1 = 256 a column pair is 4 KB of df32 values and F1r's
// digits are 512 KB, so nothing stays resident; K1-gen takes K3's two-launch
// shape:
//
//   stage 1: one block per (stream, 32 columns j2), both channels of its
//     columns, one column per lane.  The block windows its columns twice
//     (once for the raw nonzero counts and the column maxima, once to slice),
//     keeping only the packed digit words in shared memory (8*N1 bytes a
//     column, padded to whole 16-byte words); F1r's digit words stream from
//     L2 as 16-byte __ldg loads that are uniform across a warp, so one load
//     feeds 32 columns; the MACs are __dp4a.  A warp owns N1/4 consecutive
//     (channel, k1) rows, all of one channel.  The twiddled rows go to a
//     device scratch [S, 2, N1, 256] f32 (df: a (hi, lo) pair of planes).
//   stage 2: one block per 32 of the flat S*2*N1 rows, the tail masked,
//     running the stage 2 that exact_mag.cu and exact_mag3.cu run
//     (exact_common.cuh); rows stay in natural k1 order.
//
// The nonzero count spans stage-1 blocks: it is summed in int32 with integer
// atomics (order-free) after a memset and turned into f32 by stage 2.

#include "exact_common.cuh"

namespace {

using namespace wf;

constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // j2 columns per stage-1 block
constexpr int kColTiles = kLanes / kCols;
constexpr int kRows2 = 32;                 // stage-2 rows per block
constexpr int kMaxN1 = 256;                // N <= 32768

// Packed words of one channel's column (N1/4), padded to whole int4 loads;
// f1w rows carry the same zero padding.
__host__ __device__ constexpr int padded_words(int n1) {
  return (n1 / 4 + 3) / 4 * 4;
}

// Packed-word stride of one column's digits in shared memory: a multiple of
// 4 words (16-byte loads) that is 4 mod 8, so the 8 lanes of each phase of
// an int4 load hit distinct banks.
__host__ __device__ constexpr int word_stride(int words) {
  return words % 8 == 4 ? words : words + 4;
}

__host__ __device__ constexpr int stage1_smem_bytes(int n1) {
  return static_cast<int>(sizeof(int)) *
         (2 * kDigits * kCols * word_stride(padded_words(n1)) +
          kWarps * kCols + 2 * kWarps);
}

// Stage 1.  kUnits k1 per GEMM pass (their A_r and A_i rows together); each
// warp owns N1/4 consecutive (channel, k1) rows, a multiple of kUnits.  twr
// and twi are [N1][128] at the f32 tier and [3][N1][128] (hi, lo,
// Veltkamp-high half of hi) under kDf.
template <int kUnits, bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag_gen_stage1(const float* __restrict__ x,
                     const float* __restrict__ w_hi,
                     const float* __restrict__ w_lo,
                     const int* __restrict__ f1w, const float* __restrict__ twr,
                     const float* __restrict__ twi, float* __restrict__ rows,
                     int* __restrict__ nz_int, int n1, int streams) {
  const int n = n1 * kLanes;
  const int kw = n1 / 4;                    // packed words along j1
  const int words = padded_words(n1);
  const int stride = word_stride(words);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* dsm = reinterpret_cast<int*>(smem_raw);  // [2][kDigits][kCols][stride]
  float* col_max = reinterpret_cast<float*>(dsm + 2 * kDigits * kCols * stride);
  int* nz_sm = reinterpret_cast<int*>(col_max + kWarps * kCols);  // [kWarps][2]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.x / kColTiles;
  const int j2 = (blockIdx.x % kColTiles) * kCols + lane;
  const float* xs = x + static_cast<size_t>(s) * 2 * n;

  // ---- pass 1: raw nonzero counts, max |hi| over both channels ----------
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int count = 0;
    for (int j1 = warp; j1 < n1; j1 += kWarps) {
      const int j = j1 * kLanes + j2;
      const float v = xs[c * n + j];
      count += (v != 0.0f);
      float h, l;
      windowed_df(v, w_hi[j], w_lo[j], &h, &l);
      m = nanmax(m, fabsf(h));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, off);
    if (lane == 0) nz_sm[2 * warp + c] = count;
  }
  col_max[warp * kCols + lane] = m;
  __syncthreads();
  if (tid < 2) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += nz_sm[2 * w + tid];
    atomicAdd(nz_int + 2 * s + tid, total);
  }
  float sc, sc_inv;
  {
    float mm = 0.0f;
    for (int w = 0; w < kWarps; ++w) mm = nanmax(mm, col_max[w * kCols + lane]);
    pow2_scale(mm, &sc, &sc_inv);
  }

  // ---- pass 2: slice into packed digit words (f32: fast, df: serial) ----
  // word w of channel c packs j1 = 4w..4w+3; the padding words stay zero
  for (int i = warp; i < 2 * words; i += kWarps) {
    const int c = i / words;
    const int w = i - c * words;
    uint32_t packed[kDigits] = {0u, 0u, 0u, 0u};
    if (w < kw) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = (4 * w + b) * kLanes + j2;
        float h, l;
        windowed_df(xs[c * n + j], w_hi[j], w_lo[j], &h, &l);
        if constexpr (kDf) {
          int d[kDigits];
          slice_serial(h, l, sc_inv, d);
#pragma unroll
          for (int k = 0; k < kDigits; ++k)
            packed[k] |= (static_cast<uint32_t>(d[k]) & 0xffu) << (8 * b);
        } else {
          const int u = fixed27(h, sc_inv) + fixed27(l, sc_inv) + kBias;
#pragma unroll
          for (int k = 0; k < kDigits; ++k)
            packed[k] |= digit_byte(u, k) << (8 * b);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kDigits; ++k)
      dsm[((c * kDigits + k) * kCols + lane) * stride + w] =
          static_cast<int>(packed[k]);
  }
  __syncthreads();

  // ---- digit GEMMs + twiddle: warp -> N1/4 rows of one channel ----------
  const int per_warp = n1 / 4;
  const int c = (warp * per_warp) / n1;
  const int k1_begin = warp * per_warp - c * n1;
  const int* dcol = dsm + (c * kDigits * kCols + lane) * stride;
  float* out = rows + (static_cast<size_t>(s) * 2 + c) * n1 * kRow2;
  for (int p0 = k1_begin; p0 < k1_begin + per_warp; p0 += kUnits) {
    int acc[2 * kUnits][kDigits] = {};
    for (int w = 0; w < words; w += 4) {
      int4 dv[kDigits];
#pragma unroll
      for (int p = 0; p < kDigits; ++p)
        dv[p] = *reinterpret_cast<const int4*>(dcol + p * kCols * stride + w);
#pragma unroll
      for (int r = 0; r < 2 * kUnits; ++r) {
        // rows p0..p0+kUnits-1 of F1r give A_r, rows n1 + those give A_i
        const int row = p0 + (r % kUnits) + (r >= kUnits ? n1 : 0);
        int4 cv[kDigits];
#pragma unroll
        for (int p = 0; p < kDigits; ++p)
          cv[p] = __ldg(reinterpret_cast<const int4*>(
              f1w + (static_cast<size_t>(p) * 2 * n1 + row) * words + w));
#pragma unroll
        for (int t = 0; t < kDigits; ++t) {
#pragma unroll
          for (int i = 0; i <= t; ++i) {
            acc[r][t] = __dp4a(cv[i].x, dv[t - i].x, acc[r][t]);
            acc[r][t] = __dp4a(cv[i].y, dv[t - i].y, acc[r][t]);
            acc[r][t] = __dp4a(cv[i].z, dv[t - i].z, acc[r][t]);
            acc[r][t] = __dp4a(cv[i].w, dv[t - i].w, acc[r][t]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int k1 = p0 + u;
      if constexpr (kDf) {
        float arh, arl, aih, ail, brh, brl, bih, bil;
        recombine_df(acc[u], sc, &arh, &arl);
        recombine_df(acc[kUnits + u], sc, &aih, &ail);
        const int ti = k1 * kLanes + j2;
        twiddle_df(arh, arl, aih, ail, twr + ti, twi + ti,
                   static_cast<size_t>(n1) * kLanes, &brh, &brl, &bih, &bil);
        const size_t plane = static_cast<size_t>(streams) * 2 * n1 * kRow2;
        out[k1 * kRow2 + j2] = brh;
        out[plane + k1 * kRow2 + j2] = brl;
        out[k1 * kRow2 + kLanes + j2] = bih;
        out[plane + k1 * kRow2 + kLanes + j2] = bil;
      } else {
        const float ar = recombine(acc[u], sc);
        const float ai = recombine(acc[kUnits + u], sc);
        const float tr = twr[k1 * kLanes + j2];
        const float ti = twi[k1 * kLanes + j2];
        out[k1 * kRow2 + j2] = fsub(fmul(ar, tr), fmul(ai, ti));
        out[k1 * kRow2 + kLanes + j2] = fadd(fmul(ar, ti), fmul(ai, tr));
      }
    }
  }
}

// Stage 2 over the flat rows R = (s*2 + c)*n1 + k1; the last block's rows
// past the end are zero and emit nothing.  Under kDf rows_g holds the (hi,
// lo) planes and the slice writes its digit words over `rows` directly.
template <bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag_gen_stage2(const float* __restrict__ rows_g,
                     const int* __restrict__ f2w,
                     const int* __restrict__ nz_int, float* __restrict__ mag,
                     float* __restrict__ nz, int n1, int streams) {
  __shared__ __align__(16) float rows[kRows2][kRow2];
  __shared__ float row_scale[kRows2];
  const int total = streams * 2 * n1;
  const int row0 = blockIdx.x * kRows2;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < 2 * streams) nz[g] = static_cast<float>(nz_int[g]);
  if constexpr (kDf) {
    stage2_slice_df<kRows2>(rows_g, static_cast<size_t>(total) * kRow2, row0,
                            total, reinterpret_cast<int (*)[kRow2]>(rows),
                            row_scale);
  } else {
    const int live = min(kRows2, total - row0) * (kRow2 / 4);
    const float4* src = reinterpret_cast<const float4*>(
        rows_g + static_cast<size_t>(row0) * kRow2);
    float4* dst = reinterpret_cast<float4*>(&rows[0][0]);
    for (int i = threadIdx.x; i < kRows2 * kRow2 / 4; i += kThreads)
      dst[i] = i < live ? src[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    stage2_slice<kRows2>(rows, row_scale);
  }
  __syncthreads();
  stage2_mag<kRows2, kDf>(rows, row_scale, f2w, [&](int r, int k2, float v) {
    const int R = row0 + r;
    if (R < total) {
      const int sc = R / n1;
      mag[static_cast<size_t>(sc) * n1 * kKeep + (R - sc * n1) + n1 * k2] = v;
    }
  });
}

template <int kUnits, bool kDf>
cudaError_t launch_stage1(const float* x, const float* w_hi, const float* w_lo,
                          const int* f1w, const float* twr, const float* twi,
                          float* rows, int* nz_int, int n1, int streams,
                          cudaStream_t st) {
  const int bytes = stage1_smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(
      exact_mag_gen_stage1<kUnits, kDf>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  exact_mag_gen_stage1<kUnits, kDf>
      <<<streams * kColTiles, kThreads, bytes, st>>>(
          x, w_hi, w_lo, f1w, twr, twi, rows, nz_int, n1, streams);
  return cudaGetLastError();
}

template <bool kDf>
int run(const float* x, const float* w_hi, const float* w_lo, const int* f1w,
        const int* f2w, const float* twr, const float* twi, float* rows,
        int* nz_int, float* mag, float* nz, int streams, int n, void* stream) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  const int n1 = n / kLanes;
  if (n % kLanes != 0 || n1 < 8 || n1 % 8 != 0 || n1 > kMaxN1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(nz_int, 0, sizeof(int) * 2 * streams, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((n1 / 4) % 4 == 0)
    err = launch_stage1<4, kDf>(x, w_hi, w_lo, f1w, twr, twi, rows, nz_int,
                                n1, streams, st);
  else
    err = launch_stage1<2, kDf>(x, w_hi, w_lo, f1w, twr, twi, rows, nz_int,
                                n1, streams, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks2 = (streams * 2 * n1 + kRows2 - 1) / kRows2;
  exact_mag_gen_stage2<kDf><<<blocks2, kThreads, 0, st>>>(
      rows, f2w, nz_int, mag, nz, n1, streams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: x [S, 2, n], w_hi/w_lo [n], f1w [4][2*N1][W] packed int8x4
// digit words of F1r (W = N1/4 rounded up to a multiple of 4, zero-padded),
// f2w [4][64][128] packed int8x4 digit words, nz_int [S, 2] int32, outputs
// mag [S, 2, n/2] and nz [S, 2].  n = 128*N1 with N1 % 8 == 0 and
// n <= 32768.  Return the first failing call's cudaError_t.
//
// K1-gen (f32 tier): twr/twi [N1][128], scratch rows [S, 2, N1, 256] f32.
extern "C" int wf_exact_mag_gen(const float* x, const float* w_hi,
                                const float* w_lo, const int* f1w,
                                const int* f2w, const float* twr,
                                const float* twi, float* rows, int* nz_int,
                                float* mag, float* nz, int streams, int n,
                                void* stream) {
  return run<false>(x, w_hi, w_lo, f1w, f2w, twr, twi, rows, nz_int, mag, nz,
                    streams, n, stream);
}

// K1-df (df tier): twr/twi [3][N1][128] (hi, lo, Veltkamp-high half of hi),
// scratch rows [2][S, 2, N1, 256] f32 (hi, lo).
extern "C" int wf_exact_mag_gen_df(const float* x, const float* w_hi,
                                   const float* w_lo, const int* f1w,
                                   const int* f2w, const float* twr,
                                   const float* twi, float* rows, int* nz_int,
                                   float* mag, float* nz, int streams, int n,
                                   void* stream) {
  return run<true>(x, w_hi, w_lo, f1w, f2w, twr, twi, rows, nz_int, mag, nz,
                   streams, n, stream);
}
