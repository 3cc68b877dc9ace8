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
// Rounding: as exact_mag.cu (-fmad=false, every rounding spelled out in
// exact_common.cuh), so the plain PyTorch twin cfft_exact_ref in
// kernels/exact_cuda.py gives the same bits.
//
// Bound on this card: int8 multiply-accumulates, 10 digit pairs of the
// 4-term split per product: per stream 5120*N1^2 in stage 1 (5.2M at
// N=4096, 336M at N=32768) and 655k*N1 in stage 2 (21M at 4096, 168M at
// 32768).  A stream's column set is 2*N1 df values a column (4 KB at
// N1 = 256), F1b's digits reach 1 MB and F2b's 256 KB, so nothing stays
// resident as in the TPU kernel; K3 takes K2's two-launch shape:
//
//   stage 1: one block per (stream, 32 columns j2), one column per lane.  The
//     block reads its columns twice (once for the column maxima, once to
//     slice), keeping only the packed digit words in shared memory (8*N1
//     bytes a column); F1b's digit words stream from L2 as 16-byte __ldg
//     loads that are uniform across a warp, so one load feeds 32 columns;
//     the MACs are __dp4a.  The twiddled df rows go to a device scratch
//     (hi, lo) x [S, N1, 256] f32.
//   stage 2: one block per 32 rows (s, k1), one warp slicing each row, then
//     thread (k2, row half) runs the C_r and C_i columns of its k2 with F2b's
//     digit words streaming from L2.
//
// Moving the digit GEMMs onto the int8 tensor cores is the next step.

#include "exact_common.cuh"

namespace {

using namespace wf;

constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // j2 columns per stage-1 block
constexpr int kColTiles = kLanes / kCols;
constexpr int kRows2 = 32;                 // stage-2 rows per block
constexpr int kGroups2 = kThreads / kLanes;
constexpr int kTile2 = 8;                  // stage-2 rows per accumulator tile
constexpr int kMaxN1 = 256;                // N <= 32768

// Packed-word stride of one column's digits in shared memory: a multiple of
// 4 words (16-byte loads) that is 4 mod 8, so the 8 lanes of each phase of
// an int4 load hit distinct banks.
__host__ __device__ constexpr int word_stride(int words) {
  return words % 8 == 4 ? words : words + 4;
}

__host__ __device__ constexpr int stage1_smem_bytes(int n1) {
  return static_cast<int>(sizeof(int)) *
         (kDigits * kCols * word_stride(n1 / 2) + kWarps * kCols);
}

// Row j of column j2 of stream base: j < n1 reads the real part, the rest
// the imaginary part.
__device__ __forceinline__ size_t col_index(size_t base, int n1, int j,
                                            int j2) {
  return base + static_cast<size_t>(j < n1 ? j : j - n1) * kLanes + j2;
}

// Stage 1.  kUnits k1 per GEMM pass (their A_r and A_i rows together);
// each warp owns n1/8 consecutive k1, a multiple of kUnits.
template <int kUnits>
__global__ void __launch_bounds__(kThreads)
exact_cfft_stage1(const float* __restrict__ re_hi,
                  const float* __restrict__ re_lo,
                  const float* __restrict__ im_hi,
                  const float* __restrict__ im_lo, const int* __restrict__ f1w,
                  const float* __restrict__ tw, float* __restrict__ rows,
                  int n1, int streams) {
  const int words = n1 / 2;                 // packed words along 2*n1
  const int stride = word_stride(words);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* dsm = reinterpret_cast<int*>(smem_raw);   // [kDigits][kCols][stride]
  float* col_max = reinterpret_cast<float*>(dsm + kDigits * kCols * stride);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.x / kColTiles;
  const int j2 = (blockIdx.x % kColTiles) * kCols + lane;
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

  // ---- pass 2: serial slice into packed digit words ---------------------
  // word w packs contraction rows 4w..4w+3 (all real or all imaginary)
  for (int w = warp; w < words; w += kWarps) {
    const bool imag = 4 * w >= n1;
    const float* hi = imag ? im_hi : re_hi;
    const float* lo = imag ? im_lo : re_lo;
    uint32_t packed[kDigits] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const size_t i = col_index(base, n1, 4 * w + b, j2);
      int d[kDigits];
      slice_serial(hi[i], lo[i], sc_inv, d);
#pragma unroll
      for (int k = 0; k < kDigits; ++k)
        packed[k] |= (static_cast<uint32_t>(d[k]) & 0xffu) << (8 * b);
    }
#pragma unroll
    for (int k = 0; k < kDigits; ++k)
      dsm[(k * kCols + lane) * stride + w] = static_cast<int>(packed[k]);
  }
  __syncthreads();

  // ---- digit GEMMs, TwoSum recombination, df twiddle --------------------
  const int per_warp = n1 / kWarps;
  const int* dcol = dsm + lane * stride;
  const size_t plane = static_cast<size_t>(streams) * n1 * kRow2;
  float* out = rows + static_cast<size_t>(s) * n1 * kRow2;
  const size_t tw_plane = static_cast<size_t>(n1) * kLanes;
  for (int p0 = warp * per_warp; p0 < (warp + 1) * per_warp; p0 += kUnits) {
    int acc[2 * kUnits][kDigits] = {};
    for (int w = 0; w < words; w += 4) {
      int4 dv[kDigits];
#pragma unroll
      for (int p = 0; p < kDigits; ++p)
        dv[p] = *reinterpret_cast<const int4*>(dcol + p * kCols * stride + w);
#pragma unroll
      for (int r = 0; r < 2 * kUnits; ++r) {
        // rows p0..p0+kUnits-1 of F1b give A_r, rows n1 + those give A_i
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
      float arh, arl, aih, ail;
      recombine_df(acc[u], sc, &arh, &arl);
      recombine_df(acc[kUnits + u], sc, &aih, &ail);
      const size_t ti = static_cast<size_t>(k1) * kLanes + j2;
      const float trh = tw[ti], trl = tw[tw_plane + ti];
      const float tih = tw[2 * tw_plane + ti], til = tw[3 * tw_plane + ti];
      float ph, pl, qh, ql, bh, bl;
      // br = ar*twr - ai*twi
      df_mul(arh, arl, trh, trl, &ph, &pl);
      df_mul(aih, ail, tih, til, &qh, &ql);
      df_add(ph, pl, -qh, -ql, &bh, &bl);
      out[k1 * kRow2 + j2] = bh;
      out[plane + k1 * kRow2 + j2] = bl;
      // bi = ar*twi + ai*twr
      df_mul(arh, arl, tih, til, &ph, &pl);
      df_mul(aih, ail, trh, trl, &qh, &ql);
      df_add(ph, pl, qh, ql, &bh, &bl);
      out[k1 * kRow2 + kLanes + j2] = bh;
      out[plane + k1 * kRow2 + kLanes + j2] = bl;
    }
  }
}

// Stage 2 over the flat rows R = s*n1 + k1 (a multiple of 8 of them).
__global__ void __launch_bounds__(kThreads)
exact_cfft_stage2(const float* __restrict__ rows, const int* __restrict__ f2w,
                  float* __restrict__ out, int n1, int streams) {
  __shared__ __align__(16) int words[kRows2][kDigits * kWords2];
  __shared__ float row_scale[kRows2];
  const int total = streams * n1;
  const size_t plane = static_cast<size_t>(total) * kRow2;
  const int row0 = blockIdx.x * kRows2;

  // ---- slice: one warp per row, 8 of its 256 values [br | bi] a lane -----
  stage2_slice_df<kRows2>(rows, plane, row0, total, words, row_scale);
  __syncthreads();

  // ---- GEMM: thread (k2, group) runs columns k2 (C_r) and 128 + k2 (C_i) --
  constexpr int kRowsPerGroup = kRows2 / kGroups2;
  const int k2 = threadIdx.x & (kLanes - 1);
  const int group = threadIdx.x / kLanes;
  const size_t n = static_cast<size_t>(n1) * kLanes;
  const size_t out_plane = static_cast<size_t>(streams) * n;
  for (int r0 = group * kRowsPerGroup; r0 < (group + 1) * kRowsPerGroup;
       r0 += kTile2) {
    if (row0 + r0 >= total) break;          // tiles are wholly in or out
    int acc[kTile2][2][kDigits] = {};
    for (int kc = 0; kc < kWords2; ++kc) {
      int fr[kDigits], fi[kDigits];
#pragma unroll
      for (int p = 0; p < kDigits; ++p) {
        fr[p] = __ldg(f2w + (p * kWords2 + kc) * kRow2 + k2);
        fi[p] = __ldg(f2w + (p * kWords2 + kc) * kRow2 + kLanes + k2);
      }
#pragma unroll
      for (int r = 0; r < kTile2; ++r) {
        int dw[kDigits];
#pragma unroll
        for (int p = 0; p < kDigits; ++p)
          dw[p] = words[r0 + r][p * kWords2 + kc];
#pragma unroll
        for (int t = 0; t < kDigits; ++t) {
#pragma unroll
          for (int i = 0; i <= t; ++i) {
            acc[r][0][t] = __dp4a(dw[t - i], fr[i], acc[r][0][t]);
            acc[r][1][t] = __dp4a(dw[t - i], fi[i], acc[r][1][t]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTile2; ++r) {
      const int R = row0 + r0 + r;
      const int s = R / n1;
      const size_t o = static_cast<size_t>(s) * n + (R - s * n1) +
                       static_cast<size_t>(n1) * k2;
      const float s2 = row_scale[r0 + r];
      float h, l;
      recombine_df(acc[r][0], s2, &h, &l);
      out[o] = h;
      out[out_plane + o] = l;
      recombine_df(acc[r][1], s2, &h, &l);
      out[2 * out_plane + o] = h;
      out[3 * out_plane + o] = l;
    }
  }
}

template <int kUnits>
cudaError_t launch_stage1(const float* re_hi, const float* re_lo,
                          const float* im_hi, const float* im_lo,
                          const int* f1w, const float* tw, float* rows, int n1,
                          int streams, cudaStream_t st) {
  const int bytes = stage1_smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(
      exact_cfft_stage1<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  exact_cfft_stage1<kUnits><<<streams * kColTiles, kThreads, bytes, st>>>(
      re_hi, re_lo, im_hi, im_lo, f1w, tw, rows, n1, streams);
  return cudaGetLastError();
}

}  // namespace

// C entry point: re_hi/re_lo/im_hi/im_lo [S, n] f32, f1w [4][2*N1][N1/2] and
// f2w [4][64][256] packed int8x4 digit words, tw [4][N1][128] (twr_hi,
// twr_lo, twi_hi, twi_lo), scratch rows [2][S][N1][256] f32, out [4][S][n]
// (zr_hi, zr_lo, zi_hi, zi_lo).  n = 128*N1 with N1 % 8 == 0 and
// n <= 32768.  Returns the first failing call's cudaError_t.
extern "C" int wf_exact_cfft(const float* re_hi, const float* re_lo,
                             const float* im_hi, const float* im_lo,
                             const int* f1w, const int* f2w, const float* tw,
                             float* rows, float* out, int streams, int n,
                             void* stream) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  const int n1 = n / kLanes;
  if (n % kLanes != 0 || n1 < 8 || n1 % 8 != 0 || n1 > kMaxN1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_warp = n1 / kWarps;
  cudaError_t err;
  if (per_warp % 4 == 0)
    err = launch_stage1<4>(re_hi, re_lo, im_hi, im_lo, f1w, tw, rows, n1,
                           streams, st);
  else if (per_warp % 2 == 0)
    err = launch_stage1<2>(re_hi, re_lo, im_hi, im_lo, f1w, tw, rows, n1,
                           streams, st);
  else
    err = launch_stage1<1>(re_hi, re_lo, im_hi, im_lo, f1w, tw, rows, n1,
                           streams, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks2 = (streams * n1 + kRows2 - 1) / kRows2;
  exact_cfft_stage2<<<blocks2, kThreads, 0, st>>>(rows, f2w, out, n1, streams);
  return static_cast<int>(cudaGetLastError());
}
