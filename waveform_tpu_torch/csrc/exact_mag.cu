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
// below spells each rounding out with __fmul_rn/__fadd_rn/__fsub_rn.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// x * (w_hi + w_lo) as a double-float (hi, lo)
__device__ __forceinline__ void windowed_df(float x, float wh, float wl,
                                            float* hi, float* lo) {
  const float p = fmul(x, wh);
  float xh, xl, bh, bl;
  vsplit(x, &xh, &xl);
  vsplit(wh, &bh, &bl);
  float e = fadd(fadd(fsub(fmul(xh, bh), p), fmul(xh, bl)), fmul(xl, bh));
  e = fadd(e, fmul(xl, bl));
  two_sum(p, fadd(e, fmul(x, wl)), hi, lo);
}

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

  // ---- stage-2 slice: one scale per row, digits written over the row ---
  for (int r = warp; r < 2 * N1; r += kThreads / 32) {
    const float4 v0 = reinterpret_cast<const float4*>(sm.rows[r])[2 * lane];
    const float4 v1 = reinterpret_cast<const float4*>(sm.rows[r])[2 * lane + 1];
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
    int* words = reinterpret_cast<int*>(sm.rows[r]);
#pragma unroll
    for (int k = 0; k < kDigits; ++k) {
      words[k * kWords2 + 2 * lane] = static_cast<int>(packed[k][0]);
      words[k * kWords2 + 2 * lane + 1] = static_cast<int>(packed[k][1]);
    }
    if (lane == 0) sm.row_scale[r] = s2;
  }
  __syncthreads();

  // ---- stage 2: thread (k2, row group), re and im columns together -----
  constexpr int kRowsPerGroup = (2 * N1) / (kThreads / kKeep);
  constexpr int kTile = kRowsPerGroup < 8 ? kRowsPerGroup : 8;
  const int k2 = tid & (kKeep - 1);
  const int group = tid / kKeep;
  for (int r0 = group * kRowsPerGroup; r0 < (group + 1) * kRowsPerGroup;
       r0 += kTile) {
    int acc[kTile][2][kDigits];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int k = 0; k < kDigits; ++k) acc[r][0][k] = acc[r][1][k] = 0;
    for (int kc = 0; kc < kWords2; ++kc) {
      int fr[kDigits], fi[kDigits];
#pragma unroll
      for (int p = 0; p < kDigits; ++p) {
        fr[p] = __ldg(f2w + (p * kWords2 + kc) * kLanes + k2);
        fi[p] = __ldg(f2w + (p * kWords2 + kc) * kLanes + kKeep + k2);
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int* words = reinterpret_cast<const int*>(sm.rows[r0 + r]);
        int dw[kDigits];
#pragma unroll
        for (int p = 0; p < kDigits; ++p) dw[p] = words[p * kWords2 + kc];
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
    for (int r = 0; r < kTile; ++r) {
      const int row = r0 + r;
      const float s2 = sm.row_scale[row];
      const float cr = clamp63(recombine(acc[r][0], s2));
      const float ci = clamp63(recombine(acc[r][1], s2));
      const int ch = row / N1;
      const int k1 = row - ch * N1;
      sm.mag[ch][k1 + N1 * k2] = sqrtf(fadd(fmul(cr, cr), fmul(ci, ci)));
    }
  }
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
