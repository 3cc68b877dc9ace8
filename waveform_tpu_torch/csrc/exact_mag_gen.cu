// Exact |rFFT| of channel pairs at every 2-factor size: K1-gen and K1-df.
//
// Replaces waveform_tpu/kernels/exact_pallas.py:525 (_kernel_real_mag) for
// sm_90a at both twiddle tiers, at every N1 = N/128 with N1 % 8 == 0 up to
// 256 (N <= 32768).  K1-gen is the f32 tier (fast parallel slice); K1-df is
// the df tier (twiddle == "df": _slice4(exact=True), _digit_stage's TwoSum,
// the Dekker twiddle, _tail_stage2(exact=True)).  Both compute, with bins
// in natural order:
//
//   for each stream s and channel c, N = 128*N1, j = 128*j1 + j2:
//     nz[s,c]   = count of raw samples != 0 (before the window)
//     (hi, lo)  = x * (w_hi + w_lo) in double-float (TwoProd + TwoSum)
//     stage 1   = real DFT over j1 of every column j2, [A_r; A_i] = F1r @ x_c,
//                 F1r = [Re f1; Im f1]: exact integer digit products, one
//                 pow2 scale per (s, j2) over both channels; f32: fast slice,
//                 f32 class sum; df: serial slice, TwoSum recombination
//     twiddle   = products with exp(-2*pi*i*k1*j2/N): f32, or double-float
//                 Dekker products (twiddle_df_v)
//     stage 2   = DFT over j2 of every row (s, c, k1), kept half k2 < 64,
//                 one pow2 scale per row over the hi words of [br | bi]
//     mag[s,c,k1 + N1*k2] = sqrt(cr^2 + ci^2), components clamped to 2^63
//                 (df: the hi words, then mag_df)
//
// Rounding: -fmad=false and every rounding spelled out (exact_common.cuh),
// so the plain PyTorch twins rfft_pair_mag_ref and rfft_pair_mag_df_ref in
// kernels/exact_cuda.py give the same bits.
//
// Bound on this card: int8 multiply-accumulates, 10 digit pairs of the
// 4-term split per product: per stream 5120*N1^2 in stage 1 (two channels,
// 2*N1 rows, N1 deep, 128 columns) and 655,360*N1 in stage 2; the df tier
// adds no MACs.  At the serving slice's shape (N = 6144, S = 256) that is
// 22.1 G int8 ops, 11.2 us at the 1,979 TOP/s int8 peak, against 19.1 MB of
// input and output (5.7 us at 3.35 TB/s): the operations bound the function.
// Every digit GEMM runs on the int8 tensor cores, as exact_mag3.cu's do
// (stage 1 wgmma m64n32k32, stage 2 mma.sync m16n8k32); the int32 class
// sums are exact in any order, so every bit equals the twins'.  This design
// also moves a stage-1 scratch round trip of 2 * S*2*N1*256*4 bytes (50.3
// MB at the slice's shape, 15.0 us; twice that at the df tier, whose rows
// carry lo words).  At N1 = 256 a column pair is 4 KB of df32 values and
// F1r's digits are 512 KB, so nothing stays resident; the kernel runs in two
// launches:
//
//   stage 1: one block per (stream, 32 columns j2), both channels of its
//     columns, so K1's scale rule stays inside the block.  The block windows
//     its columns twice (once for the raw nonzero counts and the column
//     maxima, once to slice; one column per lane), keeping only the packed
//     digit words in shared memory, in wgmma's K-major core-matrix layout
//     (widx): the data columns are the B operand, one 1 KB tile per
//     (channel, digit plane, k-step of 32), the N1-deep contraction over j1
//     zero-padded to whole k-steps (zero digits add nothing).  F1r's digits
//     are the A operand, from L2 in fragment order (exact_cuda._frag_a1:
//     [digit][tile][k-step][lane][4 words], one 16-byte __ldg per lane and
//     digit plane): M tile T holds the re rows k1 = 8T + g as fragment rows
//     g and the im rows N1 + 8T + g as rows g + 8, so a thread holds re and
//     im of its (k1, column) and recombines, twiddles and stores them in
//     registers (8-byte stores of two adjacent columns).  Warpgroup c runs
//     channel c over every 64-row group of 4 M tiles (a warp past the last
//     tile repeats it and stores nothing), so each block reads F1r's
//     fragments twice from L2, 8*N1^2 bytes each time.  (Feeding both
//     channels' B tiles from one warpgroup's A fragments reads F1r once but
//     holds twice the accumulators, which leaves room for one block per SM;
//     that stage 1 ran slower at every size tried, both tiers.)  The
//     twiddled rows go to a device scratch [S, 2, N1, 256] f32 (df: a (hi,
//     lo) pair of planes).
//   stage 2: one block per 32 of the flat S*2*N1 rows R = (s*2 + c)*N1 + k1
//     (natural order; a block may cross (stream, channel) boundaries), the
//     rows sliced from device memory into padded shared rows (260 words, 4
//     mod 32), then exact_mag3.cu's stage 2 (exact_common.cuh:
//     stage2_mag_mma) against the f2 digits in B-fragment order
//     (exact_cuda._frag_b2).  The last block's rows past
//     the end are read as the last row (f32) or as zeros (df) and emit
//     nothing.
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
constexpr int kStride2 = kRow2 + 4;        // stage-2 shared row, in words
constexpr int kMaxN1 = 256;                // N <= 32768

// k-steps of 32 int8 along the N1-deep contraction over j1, zero-padded
__host__ __device__ constexpr int ksteps_of(int n1) { return (n1 + 31) / 32; }

__host__ __device__ constexpr int stage1_smem_bytes(int n1) {
  return static_cast<int>(sizeof(int)) *
         (2 * kDigits * ksteps_of(n1) * 256 + kWarps * kCols + 2 * kWarps +
          kCols);
}

// Word of digit plane k of channel c, column col, packed word w (j1 =
// 4w..4w+3) in the B tiles of stage 1's wgmmas: one 1 KB tile (cm_word) per
// (c, k, k-step of 8 words).
__device__ __forceinline__ int widx(int c, int k, int col, int w, int ksteps) {
  return ((c * kDigits + k) * ksteps + (w >> 3)) * 256 + cm_word(col, w);
}

// Stage 1.  twr and twi are [N1][128] at the f32 tier and [3][N1][128] (hi,
// lo, Veltkamp-high half of hi) under kDf.
template <bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag_gen_stage1(const float* __restrict__ x,
                     const float* __restrict__ w_hi,
                     const float* __restrict__ w_lo,
                     const int* __restrict__ f1f, const float* __restrict__ twr,
                     const float* __restrict__ twi, float* __restrict__ rows,
                     int* __restrict__ nz_int, int n1, int streams) {
  const int n = n1 * kLanes;
  const int kw = n1 / 4;                    // packed words along j1
  const int ksteps = ksteps_of(n1);
  const int kwp = 8 * ksteps;               // the same, zero-padded
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* dsm = reinterpret_cast<int*>(smem_raw);   // widx layout
  float* col_max = reinterpret_cast<float*>(dsm + 2 * kDigits * ksteps * 256);
  int* nz_sm = reinterpret_cast<int*>(col_max + kWarps * kCols);  // [kWarps][2]
  float* col_scale = reinterpret_cast<float*>(nz_sm + 2 * kWarps);  // [kCols]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.x / kColTiles;
  const int col0 = (blockIdx.x % kColTiles) * kCols;
  const int j2 = col0 + lane;
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
  if (warp == 0) col_scale[lane] = sc;

  // ---- pass 2: slice into packed digit words (f32: fast, df: serial) ----
  // word w of channel c packs j1 = 4w..4w+3; the padding words are zero
  for (int i = warp; i < 2 * kwp; i += kWarps) {
    const int c = i / kwp;
    const int w = i - c * kwp;
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
      dsm[widx(c, k, lane, w, ksteps)] = static_cast<int>(packed[k]);
  }
  fence_to_async();
  __syncthreads();

  // ---- digit GEMMs on wgmma, then recombination, twiddle, scratch -------
  // warpgroup c takes channel c
  const int tiles = n1 / 8;                 // 16-row M tiles (8 k1, re + im)
  const int groups = (tiles + 3) / 4;       // 64-row wgmma groups
  const int c = warp >> 2, wq = warp & 3;
  const int gl = lane >> 2, tl = lane & 3;
  const size_t dplane = static_cast<size_t>(tiles) * ksteps * 32;
  const uint32_t dsm_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dsm));
  const uint32_t bbase = dsm_addr + c * kDigits * ksteps * 1024;
  const size_t plane = static_cast<size_t>(n1) * kLanes;      // twiddle
  for (int gi = 0; gi < groups; ++gi) {
    // warp wq takes M tile 4*gi + wq; a warp past the last tile repeats it
    // and stores nothing
    const int tile_raw = 4 * gi + wq;
    const bool valid = tile_raw < tiles;
    const int tile = valid ? tile_raw : tiles - 1;
    const int k1 = 8 * tile + gl;
    const int4* af_src = reinterpret_cast<const int4*>(f1f) +
                         static_cast<size_t>(tile) * ksteps * 32 + lane;
    int acc[kDigits][16];
#pragma unroll
    for (int t = 0; t < kDigits; ++t)
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[t][q] = 0;
    digit_wgmma(
        acc, ksteps,
        [&](uint32_t (&af)[kDigits][4], int ks) {
          load_a(af, af_src + ks * 32, dplane);
        },
        [&](int k, int ks) { return bbase + (k * ksteps + ks) * 1024; });
    if (!valid) continue;
    // c regs 0, 1: the re row at columns 2*tl, 2*tl + 1; 2, 3: the im row.
    // Both columns of a thread are adjacent: one 8-byte load or store each.
    float* out = rows + (static_cast<size_t>(s) * 2 + c) * n1 * kRow2 +
                 static_cast<size_t>(k1) * kRow2 + col0;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const int col = nt * 8 + 2 * tl;
      const int ti = k1 * kLanes + col0 + col;
      const float2 sg = *reinterpret_cast<const float2*>(col_scale + col);
      const float2 tr = *reinterpret_cast<const float2*>(twr + ti);
      const float2 tq = *reinterpret_cast<const float2*>(twi + ti);
      float br[2], bi[2];
      float brl[2], bil[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int cre[kDigits], cim[kDigits];
#pragma unroll
        for (int t = 0; t < kDigits; ++t) {
          cre[t] = acc[t][4 * nt + e];
          cim[t] = acc[t][4 * nt + 2 + e];
        }
        const float sce = e ? sg.y : sg.x;
        const float trh = e ? tr.y : tr.x;
        const float tih = e ? tq.y : tq.x;
        if constexpr (kDf) {
          const float2 trl = *reinterpret_cast<const float2*>(twr + plane + ti);
          const float2 trH =
              *reinterpret_cast<const float2*>(twr + 2 * plane + ti);
          const float2 til = *reinterpret_cast<const float2*>(twi + plane + ti);
          const float2 tiH =
              *reinterpret_cast<const float2*>(twi + 2 * plane + ti);
          float arh, arl, aih, ail;
          recombine_df(cre, sce, &arh, &arl);
          recombine_df(cim, sce, &aih, &ail);
          twiddle_df_v(arh, arl, aih, ail, trh, e ? trl.y : trl.x,
                       e ? trH.y : trH.x, tih, e ? til.y : til.x,
                       e ? tiH.y : tiH.x, &br[e], &brl[e], &bi[e], &bil[e]);
        } else {
          const float ar = recombine(cre, sce);
          const float ai = recombine(cim, sce);
          br[e] = fsub(fmul(ar, trh), fmul(ai, tih));
          bi[e] = fadd(fmul(ar, tih), fmul(ai, trh));
        }
      }
      float* o = out + col;
      *reinterpret_cast<float2*>(o) = make_float2(br[0], br[1]);
      *reinterpret_cast<float2*>(o + kLanes) = make_float2(bi[0], bi[1]);
      if constexpr (kDf) {
        float* ol = o + static_cast<size_t>(streams) * 2 * n1 * kRow2;
        *reinterpret_cast<float2*>(ol) = make_float2(brl[0], brl[1]);
        *reinterpret_cast<float2*>(ol + kLanes) = make_float2(bil[0], bil[1]);
      }
    }
  }
}

// Stage 2 over the flat rows R = (s*2 + c)*n1 + k1, 32 a block; the last
// block's rows past the end emit nothing.  Under kDf rows_g holds the (hi,
// lo) planes.
template <bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag_gen_stage2(const float* __restrict__ rows_g,
                     const int* __restrict__ f2b,
                     const int* __restrict__ nz_int, float* __restrict__ mag,
                     float* __restrict__ nz, int n1, int streams) {
  __shared__ __align__(16) int words[kRows2][kStride2];
  __shared__ float row_scale[kRows2];
  const int total = streams * 2 * n1;
  const int row0 = blockIdx.x * kRows2;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < 2 * streams) nz[g] = static_cast<float>(nz_int[g]);
  auto word = [](int r, int k, int w) -> int& {
    return words[r][k * kWords2 + w];
  };
  if constexpr (kDf) {
    stage2_slice_df_into<kRows2>(
        rows_g, static_cast<size_t>(total) * kRow2,
        [=](int r) { return row0 + r; }, total, row_scale, word);
  } else {
    stage2_slice_into<kRows2>(
        [=](int r) {
          return rows_g + static_cast<size_t>(min(row0 + r, total - 1)) * kRow2;
        },
        row_scale, word);
  }
  __syncthreads();
  stage2_mag_mma<kRows2, kStride2, kDf>(
      words, row_scale, f2b, [&](int r, int k2, float v) {
        const int R = row0 + r;
        if (R < total) {
          const int sc = R / n1;
          mag[static_cast<size_t>(sc) * n1 * kKeep + (R - sc * n1) + n1 * k2] =
              v;
        }
      });
}

// Launch stage 1 (stages & 1) and stage 2 (stages & 2) on `stream`; the
// entry points launch both, the stage entry point one for timing.
template <bool kDf>
int run(const float* x, const float* w_hi, const float* w_lo, const int* f1f,
        const int* f2b, const float* twr, const float* twi, float* rows,
        int* nz_int, float* mag, float* nz, int streams, int n, void* stream,
        int stages) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  const int n1 = n / kLanes;
  if (n % kLanes != 0 || n1 < 8 || n1 % 8 != 0 || n1 > kMaxN1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  // stage 1's shared-memory limit, set once per device (at the largest
  // size it takes)
  static bool ready[64];
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(exact_mag_gen_stage1<kDf>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stage1_smem_bytes(kMaxN1));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  if (stages & 1) {
    const int bytes = stage1_smem_bytes(n1);
    err = cudaMemsetAsync(nz_int, 0, sizeof(int) * 2 * streams, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    exact_mag_gen_stage1<kDf><<<streams * kColTiles, kThreads, bytes, st>>>(
        x, w_hi, w_lo, f1f, twr, twi, rows, nz_int, n1, streams);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    const int blocks2 = (streams * 2 * n1 + kRows2 - 1) / kRows2;
    exact_mag_gen_stage2<kDf><<<blocks2, kThreads, 0, st>>>(
        rows, f2b, nz_int, mag, nz, n1, streams);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry points: x [S, 2, n], w_hi/w_lo [n], f1f [4][N1/8][k][32][4] (k =
// N1/32 rounded up) and f2b [4][8][16][32][2] int8x4 digit words of F1r and
// f2 in A- and B-fragment order (exact_cuda._frag_a1, _frag_b2), nz_int
// [S, 2] int32, outputs mag [S, 2, n/2] and nz [S, 2].  n = 128*N1 with
// N1 % 8 == 0 and n <= 32768.  Return the first failing call's cudaError_t.
//
// K1-gen (f32 tier): twr/twi [N1][128], scratch rows [S, 2, N1, 256] f32.
extern "C" int wf_exact_mag_gen(const float* x, const float* w_hi,
                                const float* w_lo, const int* f1f,
                                const int* f2b, const float* twr,
                                const float* twi, float* rows, int* nz_int,
                                float* mag, float* nz, int streams, int n,
                                void* stream) {
  return run<false>(x, w_hi, w_lo, f1f, f2b, twr, twi, rows, nz_int, mag, nz,
                    streams, n, stream, 3);
}

// K1-df (df tier): twr/twi [3][N1][128] (hi, lo, Veltkamp-high half of hi),
// scratch rows [2][S, 2, N1, 256] f32 (hi, lo).
extern "C" int wf_exact_mag_gen_df(const float* x, const float* w_hi,
                                   const float* w_lo, const int* f1f,
                                   const int* f2b, const float* twr,
                                   const float* twi, float* rows, int* nz_int,
                                   float* mag, float* nz, int streams, int n,
                                   void* stream) {
  return run<true>(x, w_hi, w_lo, f1f, f2b, twr, twi, rows, nz_int, mag, nz,
                   streams, n, stream, 3);
}

// One stage of K1-gen (df != 0: K1-df) alone, for timing the stages apart:
// stage 1 or 2, the arguments of wf_exact_mag_gen; stage 2 reads the
// scratch and counts that an earlier stage 1 left.
extern "C" int wf_exact_mag_gen_stage(int stage, int df, const float* x,
                                      const float* w_hi, const float* w_lo,
                                      const int* f1f, const int* f2b,
                                      const float* twr, const float* twi,
                                      float* rows, int* nz_int, float* mag,
                                      float* nz, int streams, int n,
                                      void* stream) {
  if (stage != 1 && stage != 2) return static_cast<int>(cudaErrorInvalidValue);
  return df ? run<true>(x, w_hi, w_lo, f1f, f2b, twr, twi, rows, nz_int, mag,
                        nz, streams, n, stream, stage)
            : run<false>(x, w_hi, w_lo, f1f, f2b, twr, twi, rows, nz_int, mag,
                         nz, streams, n, stream, stage);
}
