// Exact |rFFT| of channel pairs: window, digit-sliced two-stage DFT, magnitude.
//
// Replaces waveform_tpu/kernels/exact_pallas.py::_kernel_real_mag (2-factor
// real split, f32 twiddle tier, fast parallel slice) with one CUDA kernel for
// sm_90a.  It computes the same function, with bins in natural order:
//
//   for each stream s and channel c, N = 128*N1, j = 128*j1 + j2:
//     nz[s,c]   = count of raw samples != 0 (before the window)
//     (hi, lo)  = x * (w_hi + w_lo) in double-float (TwoProd + TwoSum)
//     stage 1   = real DFT over j1 of every column j2, exact integer digit
//                 products, one pow2 scale per (s, j2) over both channels
//     twiddle   = f32 products with exp(-2*pi*i*k1*j2/N)
//     stage 2   = DFT over j2 of every row (s, c, k1), kept half k2 < 64,
//                 one pow2 scale per row over its 256 values [br | bi]
//     mag[s,c,k1 + N1*k2] = sqrt(cr^2 + ci^2), components clamped to 2^63
//
// Every digit product and its int32 sum is exact, so the result depends only
// on the order of the f32 operations around them, which this file keeps the
// same as the reference: the plain PyTorch twin in kernels/exact_cuda.py
// gives the same bits.  The error-free transforms need every product and sum
// rounded on its own, so the build passes -fmad=false and the arithmetic
// (here and in exact_common.cuh, which holds the helpers and the stage 2
// this kernel shares with exact_mag3.cu) spells each rounding out with
// __fmul_rn/__fadd_rn/__fsub_rn.
//
// Bound on this card: int8 multiply-accumulates.  At N=4096 one stream costs
// ~5.2M MACs in stage 1 and ~21M in stage 2 (10 digit pairs of the 4-term
// Ozaki split).  This first version issues them as __dp4a (4 MACs per
// instruction) from registers and shared memory, one thread block per
// stream: the windowed column and its digit planes stay in registers, the
// stage-1 result and the stage-2 digits share one 2*N1 x 1 KB shared-memory
// tile, and the 128 KB of stage-2 constant digits stream from L2.  Moving
// the two digit GEMMs onto the int8 tensor cores (mma.sync / wgmma) is the
// next step.

#include "exact_common.cuh"

namespace {

using namespace wf;

template <int N1>
struct Smem {
  // stage-1 digits of F1r = [Re f1; Im f1]: [plane][row][j1 word]
  int f1[kDigits][2 * N1][N1 / 4];
  // per (channel, k1) row: [br | bi] f32, then the same bytes as the row's
  // stage-2 digit words [plane][kWords2]
  float rows[2 * N1][kRow2];
  float row_scale[2 * N1];
  float col_max[2][kLanes];
  float mag[2][N1 * kKeep];
  int nz[kThreads / 32];
};

template <int N1>
__global__ void __launch_bounds__(kThreads)
exact_mag_kernel(const float* __restrict__ x, const float* __restrict__ w_hi,
                 const float* __restrict__ w_lo, const int* __restrict__ f1w,
                 const int* __restrict__ f2w, const float* __restrict__ twr,
                 const float* __restrict__ twi, float* __restrict__ mag,
                 float* __restrict__ nz) {
  constexpr int n = N1 * kLanes;
  constexpr int kW1 = N1 / 4;                 // packed words per column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N1>& sm = *reinterpret_cast<Smem<N1>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t stream = blockIdx.x;
  const float* xs = x + stream * 2 * n;

  for (int i = tid; i < kDigits * 2 * N1 * kW1; i += kThreads)
    (&sm.f1[0][0][0])[i] = f1w[i];

  // ---- load one column (c, j2), count nonzeros, window in df32 ----------
  const int c = tid >> 7;
  const int j2 = tid & (kLanes - 1);
  float hi[N1], lo[N1];
  int count = 0;
  float m = 0.0f;
#pragma unroll
  for (int j1 = 0; j1 < N1; ++j1) {
    const int j = j1 * kLanes + j2;
    const float v = xs[c * n + j];
    count += (v != 0.0f);
    windowed_df(v, w_hi[j], w_lo[j], &hi[j1], &lo[j1]);
    m = nanmax(m, fabsf(hi[j1]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) sm.nz[warp] = count;
  sm.col_max[c][j2] = m;
  __syncthreads();
  if (tid < 2) {
    int total = 0;
    for (int w = 0; w < 4; ++w) total += sm.nz[tid * 4 + w];
    nz[stream * 2 + tid] = static_cast<float>(total);
  }

  // ---- stage-1 slice: one scale per column over both channels ----------
  float s, s_inv;
  pow2_scale(nanmax(sm.col_max[0][j2], sm.col_max[1][j2]), &s, &s_inv);
  int d[kDigits][kW1];
#pragma unroll
  for (int w = 0; w < kW1; ++w) {
    uint32_t packed[kDigits] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j1 = 4 * w + b;
      const int u = fixed27(hi[j1], s_inv) + fixed27(lo[j1], s_inv) + kBias;
#pragma unroll
      for (int k = 0; k < kDigits; ++k) packed[k] |= digit_byte(u, k) << (8 * b);
    }
#pragma unroll
    for (int k = 0; k < kDigits; ++k) d[k][w] = static_cast<int>(packed[k]);
  }

  // ---- stage 1 + f32 twiddle, one k1 (re and im rows) at a time --------
  for (int k1 = 0; k1 < N1; ++k1) {
    int ar_acc[kDigits] = {0, 0, 0, 0};
    int ai_acc[kDigits] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < kDigits; ++t) {
#pragma unroll
      for (int i = 0; i <= t; ++i) {
#pragma unroll
        for (int w = 0; w < kW1; ++w) {
          ar_acc[t] = __dp4a(sm.f1[i][k1][w], d[t - i][w], ar_acc[t]);
          ai_acc[t] = __dp4a(sm.f1[i][N1 + k1][w], d[t - i][w], ai_acc[t]);
        }
      }
    }
    const float ar = recombine(ar_acc, s);
    const float ai = recombine(ai_acc, s);
    const float tr = twr[k1 * kLanes + j2];
    const float ti = twi[k1 * kLanes + j2];
    sm.rows[c * N1 + k1][j2] = fsub(fmul(ar, tr), fmul(ai, ti));
    sm.rows[c * N1 + k1][kLanes + j2] = fadd(fmul(ar, ti), fmul(ai, tr));
  }
  __syncthreads();

  // ---- stage 2: one scale per row, kept-half DFT over j2, magnitude ---
  stage2_slice<2 * N1>(sm.rows, sm.row_scale);
  __syncthreads();
  stage2_mag<2 * N1>(sm.rows, sm.row_scale, f2w,
                     [&](int row, int k2, float v) {
                       const int ch = row / N1;
                       const int k1 = row - ch * N1;
                       sm.mag[ch][k1 + N1 * k2] = v;
                     });
  __syncthreads();

  float* out = mag + stream * 2 * (n / 2);
  for (int i = tid; i < 2 * (n / 2); i += kThreads)
    out[i] = (&sm.mag[0][0])[i];
}

template <int N1>
cudaError_t launch(const float* x, const float* w_hi, const float* w_lo,
                   const int* f1w, const int* f2w, const float* twr,
                   const float* twi, float* mag, float* nz, int streams,
                   cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<N1>));
  cudaError_t err = cudaFuncSetAttribute(
      exact_mag_kernel<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  exact_mag_kernel<N1><<<streams, kThreads, bytes, stream>>>(
      x, w_hi, w_lo, f1w, f2w, twr, twi, mag, nz);
  return cudaGetLastError();
}

}  // namespace

// C entry point: x [S, 2, n], w_hi/w_lo [n], f1w [4][2*N1][N1/4] and
// f2w [4][64][128] packed int8x4 digit words, twr/twi [N1][128],
// mag [S, 2, n/2], nz [S, 2].  Returns the launch's cudaError_t.
extern "C" int wf_exact_mag(const float* x, const float* w_hi,
                            const float* w_lo, const int* f1w, const int* f2w,
                            const float* twr, const float* twi, float* mag,
                            float* nz, int streams, int n, void* stream) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1024:
      return launch<8>(x, w_hi, w_lo, f1w, f2w, twr, twi, mag, nz, streams, st);
    case 2048:
      return launch<16>(x, w_hi, w_lo, f1w, f2w, twr, twi, mag, nz, streams, st);
    case 4096:
      return launch<32>(x, w_hi, w_lo, f1w, f2w, twr, twi, mag, nz, streams, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
