// Exact |rFFT| of channel pairs, 3-factor stage 1: the large-FFT kernels K2
// and K2-df.
//
// Replaces waveform_tpu/kernels/exact_pallas.py:825 (_kernel_real_mag3) for
// sm_90a at both twiddle tiers: K2 is the f32 tier (fast parallel slice), K2-df
// the df tier (twiddle == "df": the serial slice and TwoSum recombination of
// :878-886, then the df _real_mag_tail).  Both compute the same function as
// exact_mag_gen.cu at their tier, with stage 1 split N1 = 4a
// (j1 = jq*a + jp, k1 = kq + 4*kp), bins in natural order:
//
//   for each stream s and channel c, N = 128*N1, j = 128*j1 + j2:
//     nz[s,c]   = count of raw samples != 0 (before the window)
//     (hi, lo)  = x * (w_hi + w_lo) in double-float (TwoProd + TwoSum)
//     radix 4   = u0 = x0 + x2, u1 = x0 - x2, u2 = x1 + x3, u3 = x1 - x3 over
//                 the four a-row chunks x_q of every column, df32 adds
//     stage 1   = U02 = [u0; u2] and U13 = [u1; u3] against the twiddle-folded
//                 DFT_a digit constants c02, c13 [4a, 2a]: exact integer digit
//                 products, one pow2 scale per (s, c, j2) column for each of
//                 U02 and U13; rows come out chunk-major, pos = kq*a + kp;
//                 f32: fast slice, f32 class sum; df: serial slice, TwoSum
//     twiddle   = products with exp(-2*pi*i*k1(pos)*j2/N): f32, or
//                 double-float Dekker products (twiddle_df)
//     stage 2   = DFT over j2 of every row (s, c, pos), kept half k2 < 64,
//                 one pow2 scale per row over the hi words of [br | bi]
//     mag[s,c,k1(pos) + N1*k2] = sqrt(cr^2 + ci^2), components clamped to 2^63
//                 (df: the hi words, then mag_df)
//
// Rounding: as exact_mag.cu (-fmad=false, every rounding spelled out), so the
// plain PyTorch twins rfft_pair_mag3_ref and rfft_pair_mag3_df_ref in
// kernels/exact_cuda.py give the same bits.
//
// Bound on this card: int8 multiply-accumulates.  Per stream at N=65536 that
// is ~0.67G MACs in stage 1 and ~0.34G in stage 2 (exact_pallas.kernel_cost,
// :1375-1385: 10 digit pairs of the 4-term split); the df tier adds no MACs.
// N=65536 does not fit exact_mag.cu's one-block-per-stream design (one
// channel's df32 column set is 512 KB, c02 and c13 are 512 KB each, a block
// has 227 KB of shared memory), so this kernel runs in two launches:
//
//   stage 1: one block per (stream, channel, 32 columns j2), one column per
//     lane.  Stage 1 contracts over j1 only, so columns are independent.  The
//     block windows and butterflies its columns twice (once for the column
//     maxima, once to slice), keeping only the packed digit words in shared
//     memory (16*a bytes per column); the c02/c13 digit words stream from L2
//     as 16-byte __ldg loads that are uniform across a warp, so one load
//     feeds 32 columns; the MACs are __dp4a.  The twiddled rows go to a
//     device scratch [S, 2, N1, 256] f32 (16*N bytes per stream; df: a (hi,
//     lo) pair of planes, 32*N bytes).
//   stage 2: one block per 32 rows of one (stream, channel), running the
//     stage 2 that exact_mag.cu runs (exact_common.cuh).
//
// The nonzero count spans stage-1 blocks: it is summed in int32 with integer
// atomics (order-free) and turned into f32 by stage 2.  Moving the digit
// GEMMs onto the int8 tensor cores (mma.sync / wgmma) is the next step.

#include "exact_common.cuh"

namespace {

using namespace wf;

constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // j2 columns per stage-1 block
constexpr int kColTiles = kLanes / kCols;
constexpr int kUnits = 4;                  // output positions per GEMM pass
constexpr int kRows2 = 32;                 // stage-2 rows per block
constexpr int kMaxN = 65536;

// Packed-word stride of one column's digits in shared memory: a multiple of
// 4 words (16-byte loads) that is 4 mod 8, so the 8 lanes of each phase of
// an int4 load hit distinct banks.
__host__ __device__ constexpr int word_stride(int a) {
  return (a / 2) % 8 == 4 ? a / 2 : a / 2 + 4;
}

__host__ __device__ constexpr int stage1_smem_bytes(int a) {
  return static_cast<int>(sizeof(int)) *
         (2 * kDigits * kCols * word_stride(a) + 2 * kWarps * kCols + kWarps);
}

// Window and radix-4 butterfly of four consecutive jp of column j2:
// u[i][b] = u_i at jp0 + b as df32 (uh, ul); counts the raw nonzeros.
__device__ __forceinline__ void butterfly_quad(
    const float* __restrict__ xs, const float* __restrict__ w_hi,
    const float* __restrict__ w_lo, int a, int jp0, int j2, float uh[4][4],
    float ul[4][4], int* count) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (q * a + jp0 + b) * kLanes + j2;
      const float v = xs[j];
      *count += (v != 0.0f);
      windowed_df(v, w_hi[j], w_lo[j], &h[q], &l[q]);
    }
    df_add(h[0], l[0], h[2], l[2], &uh[0][b], &ul[0][b]);
    df_add(h[0], l[0], -h[2], -l[2], &uh[1][b], &ul[1][b]);
    df_add(h[1], l[1], h[3], l[3], &uh[2][b], &ul[2][b]);
    df_add(h[1], l[1], -h[3], -l[3], &uh[3][b], &ul[3][b]);
  }
}

// twr and twi are [N1][128] at the f32 tier and [3][N1][128] (hi, lo,
// Veltkamp-high half of hi) under kDf, rows in chunk-major order.
template <bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag3_stage1(const float* __restrict__ x, const float* __restrict__ w_hi,
                  const float* __restrict__ w_lo, const int* __restrict__ c02w,
                  const int* __restrict__ c13w, const float* __restrict__ twr,
                  const float* __restrict__ twi, float* __restrict__ rows,
                  int* __restrict__ nz_int, int a, int streams) {
  const int n1 = 4 * a;
  const int n = n1 * kLanes;
  const int kw = a / 2;                     // packed words along 2a
  const int stride = word_stride(a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* dsm = reinterpret_cast<int*>(smem_raw);   // [2][kDigits][kCols][stride]
  float* col_max = reinterpret_cast<float*>(dsm + 2 * kDigits * kCols * stride);
  int* nz_sm = reinterpret_cast<int*>(col_max + 2 * kWarps * kCols);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sc = blockIdx.x / kColTiles;    // stream * 2 + channel
  const int j2 = (blockIdx.x % kColTiles) * kCols + lane;
  const float* xs = x + static_cast<size_t>(sc) * n;

  // ---- pass 1: raw nonzero count and the U02/U13 column maxima ---------
  int count = 0;
  float m02 = 0.0f, m13 = 0.0f;
  for (int qd = warp; qd < a / 4; qd += kWarps) {
    float uh[4][4], ul[4][4];
    butterfly_quad(xs, w_hi, w_lo, a, 4 * qd, j2, uh, ul, &count);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      m02 = nanmax(nanmax(m02, fabsf(uh[0][b])), fabsf(uh[2][b]));
      m13 = nanmax(nanmax(m13, fabsf(uh[1][b])), fabsf(uh[3][b]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) nz_sm[warp] = count;
  col_max[warp * kCols + lane] = m02;
  col_max[(kWarps + warp) * kCols + lane] = m13;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += nz_sm[w];
    atomicAdd(nz_int + sc, total);
  }
  float s02, s02_inv, s13, s13_inv;
  {
    float ma = 0.0f, mb = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      ma = nanmax(ma, col_max[w * kCols + lane]);
      mb = nanmax(mb, col_max[(kWarps + w) * kCols + lane]);
    }
    pow2_scale(ma, &s02, &s02_inv);
    pow2_scale(mb, &s13, &s13_inv);
  }

  // ---- pass 2: slice U02/U13 into packed digit words (f32: fast, df:
  // serial); word w of U02 packs contraction rows 4w..4w+3 (u0 rows, then
  // u2 rows)
  for (int qd = warp; qd < a / 4; qd += kWarps) {
    float uh[4][4], ul[4][4];
    int ignored = 0;
    butterfly_quad(xs, w_hi, w_lo, a, 4 * qd, j2, uh, ul, &ignored);
#pragma unroll
    for (int ui = 0; ui < 4; ++ui) {
      const int g = ui & 1;                 // u0, u2 -> U02; u1, u3 -> U13
      const float si = g ? s13_inv : s02_inv;
      uint32_t packed[kDigits] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if constexpr (kDf) {
          int d[kDigits];
          slice_serial(uh[ui][b], ul[ui][b], si, d);
#pragma unroll
          for (int k = 0; k < kDigits; ++k)
            packed[k] |= (static_cast<uint32_t>(d[k]) & 0xffu) << (8 * b);
        } else {
          const int u =
              fixed27(uh[ui][b], si) + fixed27(ul[ui][b], si) + kBias;
#pragma unroll
          for (int k = 0; k < kDigits; ++k)
            packed[k] |= digit_byte(u, k) << (8 * b);
        }
      }
      const int w = (ui >> 1) * (a / 4) + qd;
#pragma unroll
      for (int k = 0; k < kDigits; ++k)
        dsm[((g * kDigits + k) * kCols + lane) * stride + w] =
            static_cast<int>(packed[k]);
    }
  }
  __syncthreads();

  // ---- digit GEMMs + twiddle: warp -> a/2 positions of one chunk kq ------
  // position pos = kq*a + kp reads rows re = (kq/2)*2a + kp, im = re + a of
  // c02 (kq even, against U02) or c13 (kq odd, against U13)
  const int units = n1 / kWarps;
  const int pos_begin = warp * units;
  const int kq = pos_begin / a;
  const int g = kq & 1;
  const int* cw = g ? c13w : c02w;          // [kDigits][4a][kw]
  const int* dcol = dsm + (g * kDigits * kCols + lane) * stride;
  const float sg = g ? s13 : s02;
  float* out = rows + static_cast<size_t>(sc) * n1 * kRow2;
  for (int p0 = pos_begin; p0 < pos_begin + units; p0 += kUnits) {
    int acc[2 * kUnits][kDigits] = {};
    for (int w = 0; w < kw; w += 4) {
      int4 dv[kDigits];
#pragma unroll
      for (int p = 0; p < kDigits; ++p)
        dv[p] = *reinterpret_cast<const int4*>(dcol + p * kCols * stride + w);
#pragma unroll
      for (int r = 0; r < 2 * kUnits; ++r) {
        const int kp = p0 + (r % kUnits) - kq * a;
        const int row = (kq >> 1) * 2 * a + kp + (r >= kUnits ? a : 0);
        int4 cv[kDigits];
#pragma unroll
        for (int p = 0; p < kDigits; ++p)
          cv[p] = __ldg(reinterpret_cast<const int4*>(
              cw + (static_cast<size_t>(p) * 4 * a + row) * kw + w));
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
    for (int r = 0; r < kUnits; ++r) {
      const int pos = p0 + r;
      if constexpr (kDf) {
        float arh, arl, aih, ail, brh, brl, bih, bil;
        recombine_df(acc[r], sg, &arh, &arl);
        recombine_df(acc[kUnits + r], sg, &aih, &ail);
        const int ti = pos * kLanes + j2;
        twiddle_df(arh, arl, aih, ail, twr + ti, twi + ti,
                   static_cast<size_t>(n1) * kLanes, &brh, &brl, &bih, &bil);
        const size_t plane = static_cast<size_t>(streams) * 2 * n1 * kRow2;
        out[pos * kRow2 + j2] = brh;
        out[plane + pos * kRow2 + j2] = brl;
        out[pos * kRow2 + kLanes + j2] = bih;
        out[plane + pos * kRow2 + kLanes + j2] = bil;
      } else {
        const float ar = recombine(acc[r], sg);
        const float ai = recombine(acc[kUnits + r], sg);
        const float tr = twr[pos * kLanes + j2];
        const float ti = twi[pos * kLanes + j2];
        out[pos * kRow2 + j2] = fsub(fmul(ar, tr), fmul(ai, ti));
        out[pos * kRow2 + kLanes + j2] = fadd(fmul(ar, ti), fmul(ai, tr));
      }
    }
  }
}

// Under kDf rows_g holds the (hi, lo) planes and the slice writes its digit
// words over `rows` directly.
template <bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag3_stage2(const float* __restrict__ rows_g, const int* __restrict__ f2w,
                  const int* __restrict__ nz_int, float* __restrict__ mag,
                  float* __restrict__ nz, int a, int streams) {
  __shared__ __align__(16) float rows[kRows2][kRow2];
  __shared__ float row_scale[kRows2];
  const int n1 = 4 * a;
  const int tiles = n1 / kRows2;
  const int sc = blockIdx.x / tiles;
  const int pos0 = (blockIdx.x % tiles) * kRows2;
  if (pos0 == 0 && threadIdx.x == 0) nz[sc] = static_cast<float>(nz_int[sc]);
  if constexpr (kDf) {
    const int total = streams * 2 * n1;
    stage2_slice_df<kRows2>(rows_g, static_cast<size_t>(total) * kRow2,
                            sc * n1 + pos0, total,
                            reinterpret_cast<int (*)[kRow2]>(rows), row_scale);
  } else {
    const float4* src = reinterpret_cast<const float4*>(
        rows_g + (static_cast<size_t>(sc) * n1 + pos0) * kRow2);
    float4* dst = reinterpret_cast<float4*>(&rows[0][0]);
    for (int i = threadIdx.x; i < kRows2 * kRow2 / 4; i += kThreads)
      dst[i] = src[i];
    __syncthreads();
    stage2_slice<kRows2>(rows, row_scale);
  }
  __syncthreads();
  float* out = mag + static_cast<size_t>(sc) * n1 * kKeep;
  stage2_mag<kRows2, kDf>(rows, row_scale, f2w, [&](int r, int k2, float v) {
    const int pos = pos0 + r;
    const int kq = pos / a;
    out[kq + 4 * (pos - kq * a) + n1 * k2] = v;
  });
}

template <bool kDf>
int run(const float* x, const float* w_hi, const float* w_lo, const int* c02w,
        const int* c13w, const int* f2w, const float* twr, const float* twi,
        float* rows, int* nz_int, float* mag, float* nz, int streams, int n,
        void* stream) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  const int n1 = n / kLanes;
  const int a = n1 / 4;
  if (n % kLanes != 0 || n1 < 32 || n1 % 32 != 0 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = stage1_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      exact_mag3_stage1<kDf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(nz_int, 0, sizeof(int) * 2 * streams, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  exact_mag3_stage1<kDf><<<streams * 2 * kColTiles, kThreads, bytes, st>>>(
      x, w_hi, w_lo, c02w, c13w, twr, twi, rows, nz_int, a, streams);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  exact_mag3_stage2<kDf><<<streams * 2 * (n1 / kRows2), kThreads, 0, st>>>(
      rows, f2w, nz_int, mag, nz, a, streams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: x [S, 2, n], w_hi/w_lo [n], c02w/c13w [4][4a][a/2] and
// f2w [4][64][128] packed int8x4 digit words, nz_int [S, 2] int32, outputs
// mag [S, 2, n/2] and nz [S, 2].  n = 512*a with a % 8 == 0 and n <= 65536.
// Return the first failing call's cudaError_t.
//
// K2 (f32 tier): twr/twi [N1][128] in chunk-major row order, scratch rows
// [S, 2, N1, 256] f32.
extern "C" int wf_exact_mag3(const float* x, const float* w_hi,
                             const float* w_lo, const int* c02w,
                             const int* c13w, const int* f2w, const float* twr,
                             const float* twi, float* rows, int* nz_int,
                             float* mag, float* nz, int streams, int n,
                             void* stream) {
  return run<false>(x, w_hi, w_lo, c02w, c13w, f2w, twr, twi, rows, nz_int,
                    mag, nz, streams, n, stream);
}

// K2-df (df tier): twr/twi [3][N1][128] (hi, lo, Veltkamp-high half of hi)
// in chunk-major row order, scratch rows [2][S, 2, N1, 256] f32 (hi, lo).
extern "C" int wf_exact_mag3_df(const float* x, const float* w_hi,
                                const float* w_lo, const int* c02w,
                                const int* c13w, const int* f2w,
                                const float* twr, const float* twi,
                                float* rows, int* nz_int, float* mag,
                                float* nz, int streams, int n, void* stream) {
  return run<true>(x, w_hi, w_lo, c02w, c13w, f2w, twr, twi, rows, nz_int,
                   mag, nz, streams, n, stream);
}
