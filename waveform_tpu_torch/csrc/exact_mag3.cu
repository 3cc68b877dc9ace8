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
// Rounding: -fmad=false and every rounding spelled out, so the
// plain PyTorch twins rfft_pair_mag3_ref and rfft_pair_mag3_df_ref in
// kernels/exact_cuda.py give the same bits.
//
// Bound on this card: int8 multiply-accumulates.  Per stream at N=65536 that
// is ~0.67G MACs in stage 1 and ~0.34G in stage 2 (exact_pallas.kernel_cost,
// :1375-1385: 10 digit pairs of the 4-term split); the df tier adds no MACs.
// At (N, S) = (65536, 32) that is 64.4 G int8 operations, 32.5 us at the
// 1,979 TOP/s int8 tensor-core peak, against 8.4 MB of input and output
// (2.5 us at 3.35 TB/s).  On __dp4a the digit GEMMs ran at ~79 TOP/s (4% of
// that peak).  Here every digit GEMM runs on the int8 tensor cores: stage 1
// as wgmma m64n32k32 (one warpgroup instruction per 64 rows x 32 columns x
// 32 k; exact_common.cuh: digit_wgmma), stage 2 as mma.sync m16n8k32
// (stage2_mag_mma).  Both sum the same int8 products in int32, exactly and
// in any order, so
// the class sums, and every bit after them, equal the __dp4a kernel's and
// the twins'.  What is left around the products (chip_smoke.py times the
// stages apart): stage 1's two windowing passes over its columns and its
// per-element epilogue (recombination, twiddle, the scratch store), which
// are not overlapped with its products.  Stage 1 on mma.sync took ~95 us
// at (N, S) = (65536, 32), on wgmma ~81 us (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py's stage timing).
//
// N=65536 does not fit a one-block-per-stream design (one
// channel's df32 column set is 512 KB, c02 and c13 are 512 KB each, a block
// has 227 KB of shared memory), so this kernel runs in two launches:
//
//   stage 1: one block per (stream, channel, 32 columns j2).  Stage 1
//     contracts over j1 only, so columns are independent.  The block windows
//     and butterflies its columns twice (once for the column maxima, once to
//     slice; one column per lane), keeping only the packed digit words in
//     shared memory, in wgmma's K-major core-matrix layout (widx): the data
//     columns are the B operand.  Each warpgroup then takes 64-row groups of
//     c02/c13, each warp 16 rows: rows g and g + 8 of a warp are the re and
//     im rows of one position (a apart in c02/c13), so a thread holds re and
//     im of its (position, column) and recombines, twiddles and stores them
//     in registers.  Per k-step of 32 (the 2a contraction zero-padded to a
//     multiple of 32: zero digits add nothing) a warp loads one A fragment
//     per digit plane into registers and the warpgroup runs 10 wgmmas
//     (class t = sum over i <= t of A_i B_(t-i)) into 4 int32 accumulator
//     sets; the next k-step's A loads while they run.  The host packs
//     c02/c13 in fragment order (exact_cuda._frag_a3: [digit][tile][k-step]
//     [lane][4 words]), so one 16-byte __ldg per lane is one A fragment and
//     a warp reads 512 contiguous bytes.  Each block reads all of c02f and
//     c13f, 2 * 4 * 4a * 2a bytes (1 MB at a = 128), from L2: 256 MB a call
//     at (65536, 32).  The twiddled rows go to a device scratch [S, 2, N1,
//     256] f32 with 8-byte stores (16*N bytes per stream; df: a (hi, lo)
//     pair of planes, 32*N bytes).
//   stage 2: one block per 32 rows of one (stream, channel), chosen as 32
//     consecutive bins k1 (4 chunks kq x 8 kp), so the magnitude stores
//     write whole 32-byte runs: the rows are sliced from device memory into
//     padded shared rows (stride 260 words, free of bank conflicts for the
//     A loads), then stage2_mag_mma runs the kept half against the f2
//     digits in B-fragment order (exact_cuda._frag_b2, 8-byte loads; 128 KB
//     from L2 per block).  (A wgmma stage 2, the rows as its B tiles, ran
//     slower: one row's words fall in 4 banks of the core-matrix layout, so
//     the slice's stores conflicted.)
//
// The nonzero count spans stage-1 blocks: it is summed in int32 with integer
// atomics (order-free) and turned into f32 by stage 2.

#include "exact_common.cuh"

namespace {

using namespace wf;

constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // j2 columns per stage-1 block
constexpr int kColTiles = kLanes / kCols;
constexpr int kRows2 = 32;                 // stage-2 rows per block
constexpr int kStride2 = kRow2 + 4;        // stage-2 shared row, in words
constexpr int kMaxN = 65536;

// Packed words along the 2a contraction, zero-padded to whole k-steps of 32
__host__ __device__ constexpr int padded_words(int a) {
  return (2 * a + 31) / 32 * 8;
}

__host__ __device__ constexpr int stage1_smem_bytes(int a) {
  return static_cast<int>(sizeof(int)) *
         (2 * kDigits * kCols * padded_words(a) + 2 * kWarps * kCols + kWarps +
          2 * kCols);
}

// Word of digit plane k of U02 (g = 0) or U13 (g = 1), column col, packed
// word w in the B tiles of stage 1's wgmmas: one 1 KB tile (cm_word) per
// (g, k, k-step of 8 words).
__device__ __forceinline__ int widx(int g, int k, int col, int w, int ksteps) {
  return ((g * kDigits + k) * ksteps + (w >> 3)) * 256 + cm_word(col, w);
}

// Window and radix-4 butterfly of four consecutive jp of column j2:
// u[i][b] = u_i at jp0 + b as df32 (uh, ul); counts the raw nonzeros.
// Under kHead sample j of the row's window is xs[(j + hd) mod n] (a
// rotating ring's head hd in [0, n)); its window coefficient is that of j.
template <bool kHead>
__device__ __forceinline__ void butterfly_quad(
    const float* __restrict__ xs, int hd, const float* __restrict__ w_hi,
    const float* __restrict__ w_lo, int a, int jp0, int j2, float uh[4][4],
    float ul[4][4], int* count) {
  const int n = 4 * a * kLanes;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (q * a + jp0 + b) * kLanes + j2;
      float v;
      if constexpr (kHead) {
        const int p = j + hd;
        v = xs[p < n ? p : p - n];
      } else {
        v = xs[j];
      }
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
// Veltkamp-high half of hi) under kDf, rows in chunk-major order.  kHead:
// the rows are a rotating ring's, read at their heads (head [S, 2]); the
// instance without it reads them in order and takes no head.
template <bool kDf, bool kHead>
__global__ void __launch_bounds__(kThreads)
exact_mag3_stage1(const float* __restrict__ x, const int* __restrict__ head,
                  const float* __restrict__ w_hi,
                  const float* __restrict__ w_lo, const int* __restrict__ c02f,
                  const int* __restrict__ c13f, const float* __restrict__ twr,
                  const float* __restrict__ twi, float* __restrict__ rows,
                  int* __restrict__ nz_int, int a, int streams) {
  const int n1 = 4 * a;
  const int n = n1 * kLanes;
  const int kw = a / 2;                     // packed words along 2a
  const int kwp = padded_words(a);
  const int ksteps = kwp / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* dsm = reinterpret_cast<int*>(smem_raw);   // widx layout
  float* col_max = reinterpret_cast<float*>(dsm + 2 * kDigits * kCols * kwp);
  int* nz_sm = reinterpret_cast<int*>(col_max + 2 * kWarps * kCols);
  float* col_scale = reinterpret_cast<float*>(nz_sm + kWarps);  // [2][kCols]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sc = blockIdx.x / kColTiles;    // stream * 2 + channel
  const int j2 = (blockIdx.x % kColTiles) * kCols + lane;
  const float* xs = x + static_cast<size_t>(sc) * n;
  const int hd = kHead ? head[sc] : 0;

  // ---- pass 1: raw nonzero count and the U02/U13 column maxima ---------
  int count = 0;
  float m02 = 0.0f, m13 = 0.0f;
  for (int qd = warp; qd < a / 4; qd += kWarps) {
    float uh[4][4], ul[4][4];
    butterfly_quad<kHead>(xs, hd, w_hi, w_lo, a, 4 * qd, j2, uh, ul, &count);
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
  if (warp == 0) {
    col_scale[lane] = s02;
    col_scale[kCols + lane] = s13;
  }
  // the zero padding of the contraction past 2a
  for (int i = tid; i < 2 * kDigits * kCols * (kwp - kw); i += kThreads) {
    const int gkc = i / (kwp - kw);
    dsm[widx(gkc / (kDigits * kCols), (gkc / kCols) % kDigits, gkc % kCols,
             kw + i % (kwp - kw), ksteps)] = 0;
  }

  // ---- pass 2: slice U02/U13 into packed digit words (f32: fast, df:
  // serial); word w of U02 packs contraction rows 4w..4w+3 (u0 rows, then
  // u2 rows)
  for (int qd = warp; qd < a / 4; qd += kWarps) {
    float uh[4][4], ul[4][4];
    int ignored = 0;
    butterfly_quad<kHead>(xs, hd, w_hi, w_lo, a, 4 * qd, j2, uh, ul, &ignored);
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
        dsm[widx(g, k, lane, w, ksteps)] = static_cast<int>(packed[k]);
    }
  }
  __syncthreads();

  fence_to_async();
  __syncthreads();
  const int tiles_g = a / 4;                // 16-row M tiles per block g
  const int groups_g = (tiles_g + 3) / 4;   // 64-row wgmma groups per g
  const int wg = warp >> 2, wq = warp & 3;
  const int gl = lane >> 2, tl = lane & 3;
  const int col0 = (blockIdx.x % kColTiles) * kCols;
  const size_t dplane = static_cast<size_t>(tiles_g) * ksteps * 32;
  const uint32_t dsm_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dsm));
  float* out = rows + static_cast<size_t>(sc) * n1 * kRow2;
  for (int gi = wg; gi < 2 * groups_g; gi += kWarps / 4) {
    // warp wq of the warpgroup takes M tile 4*(gi % groups_g) + wq of g; a
    // warp past the last tile repeats it and stores nothing
    const int g = gi / groups_g;
    const int tile_raw = 4 * (gi % groups_g) + wq;
    const bool valid = tile_raw < tiles_g;
    const int tile = valid ? tile_raw : tiles_g - 1;
    const int kq = 2 * (tile / (a / 8)) + g;
    const int pos = kq * a + (tile % (a / 8)) * 8 + gl;
    const int4* af_src = reinterpret_cast<const int4*>(g ? c13f : c02f) +
                         static_cast<size_t>(tile) * ksteps * 32 + lane;
    const uint32_t bbase = dsm_addr + g * kDigits * ksteps * 1024;
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
    const size_t plane = static_cast<size_t>(n1) * kLanes;    // twiddle
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const int c = nt * 8 + 2 * tl;
      const int ti = pos * kLanes + col0 + c;
      const float2 sg = *reinterpret_cast<const float2*>(col_scale +
                                                         g * kCols + c);
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
        const float s = e ? sg.y : sg.x;
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
          recombine_df(cre, s, &arh, &arl);
          recombine_df(cim, s, &aih, &ail);
          twiddle_df_v(arh, arl, aih, ail, trh, e ? trl.y : trl.x,
                       e ? trH.y : trH.x, tih, e ? til.y : til.x,
                       e ? tiH.y : tiH.x, &br[e], &brl[e], &bi[e], &bil[e]);
        } else {
          const float ar = recombine(cre, s);
          const float ai = recombine(cim, s);
          br[e] = fsub(fmul(ar, trh), fmul(ai, tih));
          bi[e] = fadd(fmul(ar, tih), fmul(ai, trh));
        }
      }
      float* o = out + pos * kRow2 + col0 + c;
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

// One block per 32 rows of one (stream, channel): the positions kq*a + kp0
// + i (kq < 4, i < 8), tile row r = 4i + kq, which are the 32 consecutive
// bins k1 = 4*kp0 + r, so each magnitude store of a warp writes whole
// 32-byte runs of bins.  The slice reads the rows from device memory (under
// kDf the (hi, lo) planes) and writes their digit words to shared rows
// kStride2 words apart.
template <bool kDf>
__global__ void __launch_bounds__(kThreads)
exact_mag3_stage2(const float* __restrict__ rows_g, const int* __restrict__ f2b,
                  const int* __restrict__ nz_int, float* __restrict__ mag,
                  float* __restrict__ nz, int a, int streams) {
  __shared__ __align__(16) int words[kRows2][kStride2];
  __shared__ float row_scale[kRows2];
  const int n1 = 4 * a;
  const int sc = blockIdx.x / (a / 8);
  const int kp0 = 8 * (blockIdx.x % (a / 8));
  if (kp0 == 0 && threadIdx.x == 0) nz[sc] = static_cast<float>(nz_int[sc]);
  auto row_of = [=](int r) { return sc * n1 + (r & 3) * a + kp0 + (r >> 2); };
  auto word = [](int r, int k, int w) -> int& {
    return words[r][k * kWords2 + w];
  };
  if constexpr (kDf) {
    const int total = streams * 2 * n1;
    stage2_slice_df_into<kRows2>(rows_g, static_cast<size_t>(total) * kRow2,
                                 row_of, total, row_scale, word);
  } else {
    stage2_slice_into<kRows2>(
        [=](int r) {
          return rows_g + static_cast<size_t>(row_of(r)) * kRow2;
        },
        row_scale, word);
  }
  __syncthreads();
  float* out = mag + static_cast<size_t>(sc) * n1 * kKeep + 4 * kp0;
  stage2_mag_mma<kRows2, kStride2, kDf>(
      words, row_scale, f2b,
      [&](int r, int k2, float v) { out[r + n1 * k2] = v; });
}

// Launch stage 1 (stages & 1) and stage 2 (stages & 2) on `stream`; the
// entry points launch both, the stage entry points one for timing.
template <bool kDf>
int run(const float* x, const int* head, const float* w_hi, const float* w_lo,
        const int* c02f, const int* c13f, const int* f2b, const float* twr,
        const float* twi, float* rows, int* nz_int, float* mag, float* nz,
        int streams, int n, void* stream, int stages) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  const int n1 = n / kLanes;
  const int a = n1 / 4;
  if (n % kLanes != 0 || n1 < 32 || n1 % 32 != 0 || n > kMaxN)
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
    // both instances: with and without the rows' heads
    err = cudaFuncSetAttribute(exact_mag3_stage1<kDf, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stage1_smem_bytes(kMaxN / 512));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(exact_mag3_stage1<kDf, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 stage1_smem_bytes(kMaxN / 512));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  if (stages & 1) {
    const int bytes = stage1_smem_bytes(a);
    err = cudaMemsetAsync(nz_int, 0, sizeof(int) * 2 * streams, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto stage1 = head ? exact_mag3_stage1<kDf, true>
                             : exact_mag3_stage1<kDf, false>;
    stage1<<<streams * 2 * kColTiles, kThreads, bytes, st>>>(
        x, head, w_hi, w_lo, c02f, c13f, twr, twi, rows, nz_int, a, streams);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    exact_mag3_stage2<kDf><<<streams * 2 * (a / 8), kThreads, 0, st>>>(
        rows, f2b, nz_int, mag, nz, a, streams);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry points: x [S, 2, n], head null or [S, 2] int32 (each row's
// logical sample j at x[(j + head) mod n], a rotating ring's layout; null:
// in order), w_hi/w_lo [n], c02f/c13f [4][a/4][k][32][4] (k = 2a/32
// rounded up) and f2b [4][8][16][32][2] int8x4 digit words in A- and
// B-fragment order (exact_cuda._frag_a3, _frag_b2), nz_int [S, 2] int32,
// outputs mag [S, 2, n/2] and nz [S, 2].  n = 512*a with a % 8 == 0 and
// n <= 65536.  Return the first failing call's cudaError_t.
//
// K2 (f32 tier): twr/twi [N1][128] in chunk-major row order, scratch rows
// [S, 2, N1, 256] f32.
extern "C" int wf_exact_mag3(const float* x, const int* head,
                             const float* w_hi, const float* w_lo,
                             const int* c02f, const int* c13f, const int* f2b,
                             const float* twr, const float* twi, float* rows,
                             int* nz_int, float* mag, float* nz, int streams,
                             int n, void* stream) {
  return run<false>(x, head, w_hi, w_lo, c02f, c13f, f2b, twr, twi, rows,
                    nz_int, mag, nz, streams, n, stream, 3);
}

// K2-df (df tier): twr/twi [3][N1][128] (hi, lo, Veltkamp-high half of hi)
// in chunk-major row order, scratch rows [2][S, 2, N1, 256] f32 (hi, lo).
extern "C" int wf_exact_mag3_df(const float* x, const int* head,
                                const float* w_hi, const float* w_lo,
                                const int* c02f, const int* c13f,
                                const int* f2b, const float* twr,
                                const float* twi, float* rows, int* nz_int,
                                float* mag, float* nz, int streams, int n,
                                void* stream) {
  return run<true>(x, head, w_hi, w_lo, c02f, c13f, f2b, twr, twi, rows,
                   nz_int, mag, nz, streams, n, stream, 3);
}

// One stage of K2 (df != 0: K2-df) alone, for timing the stages apart:
// stage 1 or 2, the arguments of wf_exact_mag3; stage 2 reads the scratch
// and counts that an earlier stage 1 left.
extern "C" int wf_exact_mag3_stage(int stage, int df, const float* x,
                                   const int* head, const float* w_hi,
                                   const float* w_lo, const int* c02f,
                                   const int* c13f, const int* f2b,
                                   const float* twr, const float* twi,
                                   float* rows, int* nz_int, float* mag,
                                   float* nz, int streams, int n,
                                   void* stream) {
  if (stage != 1 && stage != 2) return static_cast<int>(cudaErrorInvalidValue);
  return df ? run<true>(x, head, w_hi, w_lo, c02f, c13f, f2b, twr, twi, rows,
                        nz_int, mag, nz, streams, n, stream, stage)
            : run<false>(x, head, w_hi, w_lo, c02f, c13f, f2b, twr, twi,
                         rows, nz_int, mag, nz, streams, n, stream, stage);
}
