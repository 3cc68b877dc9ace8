// Exact complex FFT, df32 in and df32 out: the packed-pair kernel (K3).
//
// Replaces waveform_tpu/kernels/exact_pallas.py:479 (_kernel, body _core
// :439-476, launched by cfft_exact_packed :982) for sm_90a.  It computes the
// same function, with bins in natural order:
//
//   for each stream s, N = 128*N1 (N1 % 8 == 0, N <= 32768),
//   j = 128*j1 + j2, k = k1 + N1*k2, x = (re_hi + re_lo) + i*(im_hi + im_lo):
//     stage 1   = [A_r; A_i] = F1b @ [x_r; x_i] over j1 for every column j2,
//                 F1b = [[Re f1, -Im f1], [Im f1, Re f1]]: one pow2 scale per
//                 (s, j2) over the column's 2*N1 hi words, the serial 4-digit
//                 slice, exact integer digit products, TwoSum recombination
//     twiddle   = B = A * exp(-2*pi*i*k1*j2/N) in double-float (Dekker
//                 products with run-time Veltkamp splits of both operands)
//     stage 2   = [C_r | C_i] = [B_r | B_i] @ F2b over j2 for every row
//                 (s, k1), F2b = [[Re f2, Im f2], [-Im f2, Re f2]]: one pow2
//                 scale per row over its 256 hi words, then as stage 1
//     out       = (C_r, C_i)[s, k1 + N1*k2] as df32 (hi, lo) pairs
//
// Rounding: -fmad=false and every rounding spelled out (exact_common.cuh), so
// the plain PyTorch twin cfft_exact_ref in kernels/exact_cuda.py gives the
// same bits.
//
// Bound on this card: the bytes.  Per stream the int8 work is 5120*N1^2
// multiply-accumulates in stage 1 and 655,360*N1 in stage 2 (10 digit pairs
// of the 4-term split per product); at the packed pair's shape (N = 4096,
// S = 256) that is 13.4 G int8 ops, 6.8 us at the 1,979 TOP/s int8 peak,
// against 33.5 MB of df32 in and out, 10.1 us at 3.35 TB/s.  At N1 = 256
// (N = 32768) the stage-1 products dominate instead.  Every digit GEMM runs
// on the int8 tensor cores, as in exact_mag_gen.cu; the int32 class sums are
// exact in any order, so every bit equals the twin's.  A stream's columns
// reach 4 KB of df32 values and F1b's digits 1 MB, so nothing stays resident
// as in the TPU kernel; the kernel runs in two launches and moves a scratch
// round trip of 4 * S*N1*256*4 bytes (33.5 MB at the packed pair's shape):
//
//   stage 1: one block per (stream, 32 columns j2).  The block reads its
//     columns twice (once for the column maxima, once to slice; one column
//     per lane), keeping only the packed digit words in shared memory, in
//     wgmma's K-major core-matrix layout: the data columns are the B
//     operand, one 1 KB tile per (digit plane, k-step of 32), the 2*N1-deep
//     contraction over [x_r; x_i] zero-padded to whole k-steps (zero digits
//     add nothing).  F1b's digits are the A operand, from L2 in fragment
//     order (exact_cuda._frag_a: [digit][tile][k-step][lane][4 words]):
//     M tile T holds the A_r rows k1 = 8T + g as fragment rows g and the
//     A_i rows N1 + 8T + g as rows g + 8, so a thread holds ar and ai of its
//     (k1, column) and recombines, twiddles and stores them in registers
//     (8-byte stores of two adjacent columns).  The warpgroups split the
//     64-row groups of 4 M tiles (m64n32k32; a warp past the last tile
//     repeats it and stores nothing, and at N1 <= 32, one group, the second
//     warpgroup idles: giving each warpgroup 16 of the 32 columns instead,
//     m64n16k32, ran 4% slower there and 56% slower at N1 = 256).  The
//     twiddled (hi, lo) rows go to a device scratch [2][S, N1, 256] f32.
//   stage 2: one block per 32 of the flat S*N1 rows R = s*N1 + k1, sliced
//     from device memory into padded shared rows (260 words, 4 mod 32), then
//     exact_common.cuh's stage2_mma twice, each pass 64 of the 128 k2 (C_r
//     and C_i of the same k2 in one thread), against all 256 columns of F2b
//     in B-fragment order (exact_cuda._frag_b2, 32 N tiles).  Eight
//     consecutive k1 of a fragment are one 32-byte sector of the output.
//     The last block's rows past the end read zeros and store nothing.

#include "exact_common.cuh"

namespace {

using namespace wf;

constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // j2 columns per stage-1 block
constexpr int kColTiles = kLanes / kCols;
constexpr int kRows2 = 32;                 // stage-2 rows per block
constexpr int kStride2 = kRow2 + 4;        // stage-2 shared row, in words
constexpr int kMaxN1 = 256;                // N <= 32768

// k-steps of 32 int8 along the 2*N1-deep contraction over [x_r; x_i],
// zero-padded
__host__ __device__ constexpr int ksteps_of(int n1) {
  return (2 * n1 + 31) / 32;
}

__host__ __device__ constexpr int stage1_smem_bytes(int n1) {
  return static_cast<int>(sizeof(int)) *
         (kDigits * ksteps_of(n1) * 256 + kWarps * kCols + kCols);
}

// Row j of column j2 of stream base: j < n1 reads the real part, the rest
// the imaginary part.
__device__ __forceinline__ size_t col_index(size_t base, int n1, int j,
                                            int j2) {
  return base + static_cast<size_t>(j < n1 ? j : j - n1) * kLanes + j2;
}

// Stage 1: warpgroup h takes the 64-row groups h, h + 2, ...
__global__ void __launch_bounds__(kThreads)
exact_cfft_stage1(const float* __restrict__ re_hi,
                  const float* __restrict__ re_lo,
                  const float* __restrict__ im_hi,
                  const float* __restrict__ im_lo, const int* __restrict__ f1f,
                  const float* __restrict__ tw, float* __restrict__ rows,
                  int n1, int streams) {
  const int words = n1 / 2;                 // packed words along 2*n1
  const int ksteps = ksteps_of(n1);
  const int kwp = 8 * ksteps;               // the same, zero-padded
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* dsm = reinterpret_cast<int*>(smem_raw);   // [kDigits][ksteps] B tiles
  float* col_max = reinterpret_cast<float*>(dsm + kDigits * ksteps * 256);
  float* col_scale = col_max + kWarps * kCols;   // [kCols]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.x / kColTiles;
  const int col0 = (blockIdx.x % kColTiles) * kCols;
  const int j2 = col0 + lane;
  const size_t base = static_cast<size_t>(s) * n1 * kLanes;

  // ---- pass 1: max |hi| over the column's 2*n1 rows ---------------------
  float m = 0.0f;
  for (int j = warp; j < 2 * n1; j += kWarps)
    m = nanmax(m, fabsf((j < n1 ? re_hi : im_hi)[col_index(base, n1, j, j2)]));
  col_max[warp * kCols + lane] = m;
  __syncthreads();
  float sc, sc_inv;
  {
    float mm = 0.0f;
    for (int w = 0; w < kWarps; ++w) mm = nanmax(mm, col_max[w * kCols + lane]);
    pow2_scale(mm, &sc, &sc_inv);
  }
  if (warp == 0) col_scale[lane] = sc;

  // ---- pass 2: serial slice into the B tiles ----------------------------
  // word w packs contraction rows 4w..4w+3 (all real or all imaginary); the
  // padding words are zero
  for (int w = warp; w < kwp; w += kWarps) {
    uint32_t packed[kDigits] = {0u, 0u, 0u, 0u};
    if (w < words) {
      const bool imag = 4 * w >= n1;
      const float* hi = imag ? im_hi : re_hi;
      const float* lo = imag ? im_lo : re_lo;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const size_t i = col_index(base, n1, 4 * w + b, j2);
        int d[kDigits];
        slice_serial(hi[i], lo[i], sc_inv, d);
#pragma unroll
        for (int k = 0; k < kDigits; ++k)
          packed[k] |= (static_cast<uint32_t>(d[k]) & 0xffu) << (8 * b);
      }
    }
#pragma unroll
    for (int k = 0; k < kDigits; ++k)
      dsm[(k * ksteps + (w >> 3)) * 256 + cm_word(lane, w)] =
          static_cast<int>(packed[k]);
  }
  fence_to_async();
  __syncthreads();

  // ---- digit GEMMs on wgmma, TwoSum recombination, df twiddle -----------
  const int tiles = n1 / 8;                 // 16-row M tiles (8 k1, re + im)
  const int groups = (tiles + 3) / 4;       // 64-row wgmma groups
  const int wg = warp >> 2, wq = warp & 3;
  const int gl = lane >> 2, tl = lane & 3;
  const size_t dplane = static_cast<size_t>(tiles) * ksteps * 32;
  const uint32_t bbase = static_cast<uint32_t>(__cvta_generic_to_shared(dsm));
  const size_t plane = static_cast<size_t>(streams) * n1 * kRow2;   // lo
  const size_t tw_plane = static_cast<size_t>(n1) * kLanes;
  for (int gi = wg; gi < groups; gi += 2) {
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
    // c regs 0, 1: the A_r row at two adjacent columns; 2, 3: the A_i row
    float* out = rows + (static_cast<size_t>(s) * n1 + k1) * kRow2 + col0;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const int col = nt * 8 + 2 * tl;
      const size_t ti = static_cast<size_t>(k1) * kLanes + col0 + col;
      const float2 sg = *reinterpret_cast<const float2*>(col_scale + col);
      const float2 trh = *reinterpret_cast<const float2*>(tw + ti);
      const float2 trl = *reinterpret_cast<const float2*>(tw + tw_plane + ti);
      const float2 tih =
          *reinterpret_cast<const float2*>(tw + 2 * tw_plane + ti);
      const float2 til =
          *reinterpret_cast<const float2*>(tw + 3 * tw_plane + ti);
      float brh[2], brl[2], bih[2], bil[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int cre[kDigits], cim[kDigits];
#pragma unroll
        for (int t = 0; t < kDigits; ++t) {
          cre[t] = acc[t][4 * nt + e];
          cim[t] = acc[t][4 * nt + 2 + e];
        }
        const float sce = e ? sg.y : sg.x;
        const float wrh = e ? trh.y : trh.x, wrl = e ? trl.y : trl.x;
        const float wih = e ? tih.y : tih.x, wil = e ? til.y : til.x;
        float arh, arl, aih, ail, ph, pl, qh, ql;
        recombine_df(cre, sce, &arh, &arl);
        recombine_df(cim, sce, &aih, &ail);
        // br = ar*twr - ai*twi
        df_mul(arh, arl, wrh, wrl, &ph, &pl);
        df_mul(aih, ail, wih, wil, &qh, &ql);
        df_add(ph, pl, -qh, -ql, &brh[e], &brl[e]);
        // bi = ar*twi + ai*twr
        df_mul(arh, arl, wih, wil, &ph, &pl);
        df_mul(aih, ail, wrh, wrl, &qh, &ql);
        df_add(ph, pl, qh, ql, &bih[e], &bil[e]);
      }
      float* o = out + col;
      *reinterpret_cast<float2*>(o) = make_float2(brh[0], brh[1]);
      *reinterpret_cast<float2*>(o + kLanes) = make_float2(bih[0], bih[1]);
      *reinterpret_cast<float2*>(o + plane) = make_float2(brl[0], brl[1]);
      *reinterpret_cast<float2*>(o + plane + kLanes) =
          make_float2(bil[0], bil[1]);
    }
  }
}

// Stage 2 over the flat rows R = s*n1 + k1, 32 a block; the last block's
// rows past the end store nothing.
__global__ void __launch_bounds__(kThreads)
exact_cfft_stage2(const float* __restrict__ rows, const int* __restrict__ f2b,
                  float* __restrict__ out, int n1, int streams) {
  __shared__ __align__(16) int words[kRows2][kStride2];
  __shared__ float row_scale[kRows2];
  const int total = streams * n1;
  const int row0 = blockIdx.x * kRows2;
  stage2_slice_df_into<kRows2>(
      rows, static_cast<size_t>(total) * kRow2,
      [=](int r) { return row0 + r; }, total, row_scale,
      [](int r, int k, int w) -> int& { return words[r][k * kWords2 + w]; });
  __syncthreads();
  const size_t n = static_cast<size_t>(n1) * kLanes;
  const size_t plane = static_cast<size_t>(streams) * n;
  // pass h: k2 = 64h .. 64h + 63 (N tiles 8h + w for C_r, 16 + 8h + w for
  // C_i)
#pragma unroll 1
  for (int h = 0; h < 2; ++h)
    stage2_mma<kRows2, kStride2, kRow2 / 8>(
        words, f2b, 8 * h,
        [&](int r, int k2, const int (&cre)[kDigits],
            const int (&cim)[kDigits]) {
          const int R = row0 + r;
          if (R >= total) return;
          const int sr = R / n1;
          const size_t o = static_cast<size_t>(sr) * n + (R - sr * n1) +
                           static_cast<size_t>(n1) * k2;
          const float s2 = row_scale[r];
          float hi, lo;
          recombine_df(cre, s2, &hi, &lo);
          out[o] = hi;
          out[plane + o] = lo;
          recombine_df(cim, s2, &hi, &lo);
          out[2 * plane + o] = hi;
          out[3 * plane + o] = lo;
        });
}

// Launch stage 1 (stages & 1) and stage 2 (stages & 2) on `stream`; the
// entry point launches both, the stage entry point one for timing.
int run(const float* re_hi, const float* re_lo, const float* im_hi,
        const float* im_lo, const int* f1f, const int* f2b, const float* tw,
        float* rows, float* out, int streams, int n, void* stream,
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
    err = cudaFuncSetAttribute(exact_cfft_stage1,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stage1_smem_bytes(kMaxN1));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  if (stages & 1) {
    exact_cfft_stage1<<<streams * kColTiles, kThreads,
                        stage1_smem_bytes(n1), st>>>(
        re_hi, re_lo, im_hi, im_lo, f1f, tw, rows, n1, streams);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    const int blocks2 = (streams * n1 + kRows2 - 1) / kRows2;
    exact_cfft_stage2<<<blocks2, kThreads, 0, st>>>(rows, f2b, out, n1,
                                                     streams);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry point: re_hi/re_lo/im_hi/im_lo [S, n] f32, f1f [4][N1/8][k][32][4]
// (k = 2*N1/32 rounded up) and f2b [4][8][32][32][2] int8x4 digit words of
// F1b and F2b in A- and B-fragment order (exact_cuda._frag_a, _frag_b2), tw
// [4][N1][128] (twr_hi, twr_lo, twi_hi, twi_lo), scratch rows [2][S][N1][256]
// f32, out [4][S][n] (zr_hi, zr_lo, zi_hi, zi_lo).  n = 128*N1 with
// N1 % 8 == 0 and n <= 32768.  Returns the first failing call's cudaError_t.
extern "C" int wf_exact_cfft(const float* re_hi, const float* re_lo,
                             const float* im_hi, const float* im_lo,
                             const int* f1f, const int* f2b, const float* tw,
                             float* rows, float* out, int streams, int n,
                             void* stream) {
  return run(re_hi, re_lo, im_hi, im_lo, f1f, f2b, tw, rows, out, streams, n,
             stream, 3);
}

// One stage of K3 alone, for timing the stages apart: stage 1 or 2, then
// the arguments of wf_exact_cfft; stage 2 reads the scratch that an earlier
// stage 1 left.
extern "C" int wf_exact_cfft_stage(int stage, const float* re_hi,
                                   const float* re_lo, const float* im_hi,
                                   const float* im_lo, const int* f1f,
                                   const int* f2b, const float* tw,
                                   float* rows, float* out, int streams,
                                   int n, void* stream) {
  if (stage != 1 && stage != 2) return static_cast<int>(cudaErrorInvalidValue);
  return run(re_hi, re_lo, im_hi, im_lo, f1f, f2b, tw, rows, out, streams, n,
             stream, stage);
}
