// The rebin's two stages that do arithmetic on the card
// (rebin/apply.make_rebin_fn, kernels/rebin_cuda.py): the interp, dB bins
// to pixels through the tap tables, and the Gaussian filter over the pixels.
//
// Replaces no Pallas kernel.  The JAX package's rebin
// (waveform_tpu/rebin/apply.py) is jnp code: a gather of the taps and a
// weighted sum, or one dense [nbins, P] product.  On the card the dense
// product ran a [512, 8192] x [8192, 800] float32 GEMM in the studio look
// (6.7 GFLOP, 156 us) on a matrix 99.9% zeros, and the filter ran as ~22
// elementwise nodes (53 us).  Bytes bound both kernels:
//
//   interp (rebin_interp): each of R rows x P pixels reads its T taps (1, 4
//     or 8; consecutive bins for Lanczos and Catmull-Rom), so at most
//     R*P*T*4 B read (13.1 MB at (512, 800, 8)) and R*P*4 written (1.6
//     MB), the 51 KB table read through L1: ~4.4 us at 3.35 TB/s.  A
//     thread owns one pixel, keeps its taps and weights in registers and
//     walks a few rows, so the table is read once a block;
//   filter (rebin_gauss): the zero-padded K-tap convolution of each row
//     divided by renorm (rebin/filter.py): R*P*4 B in and out (3.3 MB),
//     ~1.0 us.  A block takes a tile of 1024 outputs of one row (a whole
//     800-pixel row: one wave of blocks), its inputs and their halo in
//     shared memory, every load in flight at once; each of 256 threads
//     keeps four sums in flight.  On an H100 it ran 2.7-2.8 us against
//     3.1-3.3 with the loads in a loop, 4.0-4.2 for one output a thread
//     in tiles of 256 and 2.1 for a plain copy of the same bytes.
//
// Arithmetic is the plain versions' in float32 (rebin_cuda.rebin_interp_ref,
// rebin_gauss_ref).  Built with -fmad=false, each product and sum rounds
// once.  The filter adds padded[i + j] * w[j] for j = 0 .. K-1 from zero,
// then divides, as the plain loop does: the same bits.  The interp adds its
// T products in tap order; the plain gather-and-sum's reduction may add
// them in another order, so the two agree to the rounding of a T-term sum.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 64;        // interp: pixels (threads) a block
constexpr int kGaussThreads = 256; // filter: threads a block
constexpr int kGaussOut = 4;       // filter: outputs a thread

template <int T>
__global__ void __launch_bounds__(kPixels)
rebin_interp(const float* __restrict__ x, long long stride_a,
             long long stride_b, int inner, const int* __restrict__ taps,
             const float* __restrict__ weights, float* __restrict__ out,
             int rows, int P, int rows_per_block) {
  const int p = blockIdx.y * kPixels + threadIdx.x;
  if (p >= P) return;
  int tap[T];
  float w[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    tap[t] = __ldg(taps + p * T + t);
    w[t] = __ldg(weights + p * T + t);
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const int a = r / inner;
    const float* row = x + a * stride_a + (r - a * inner) * stride_b;
    float v[T];
#pragma unroll
    for (int t = 0; t < T; ++t) v[t] = __ldg(row + tap[t]);
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) acc = __fadd_rn(acc, __fmul_rn(v[t], w[t]));
    out[static_cast<size_t>(r) * P + p] = acc;
  }
}

// One block a tile of kGaussOut * kGaussThreads outputs of one row: the
// tile's inputs and their halo in shared memory; thread t computes outputs
// t + kGaussThreads * q, kGaussOut independent sums in flight.
__global__ void __launch_bounds__(kGaussThreads)
rebin_gauss(const float* __restrict__ x, const float* __restrict__ w, int K,
            const float* __restrict__ renorm, float* __restrict__ out, int P) {
  extern __shared__ float sh[];   // K weights, then the tile's padded inputs
  float* sw = sh;
  float* sp = sh + K;
  constexpr int kTile = kGaussOut * kGaussThreads;
  const int pad = (K - 1) / 2;
  const int p0 = blockIdx.y * kTile;
  const size_t row = static_cast<size_t>(blockIdx.x) * P;
  // every load of the tile in flight at once: the tile's inputs through
  // registers, then the halo's K - 1 past it
  float norm[kGaussOut], v[kGaussOut];
#pragma unroll
  for (int q = 0; q < kGaussOut; ++q) {
    const int i = p0 + threadIdx.x + kGaussThreads * q;
    norm[q] = i < P ? renorm[i] : 1.0f;
    v[q] = i - pad >= 0 && i - pad < P ? x[row + i - pad] : 0.0f;
  }
  for (int j = threadIdx.x; j < K; j += kGaussThreads) sw[j] = w[j];
  for (int j = kTile + threadIdx.x; j < kTile + K - 1; j += kGaussThreads) {
    const int src = p0 - pad + j;
    sp[j] = src >= 0 && src < P ? x[row + src] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kGaussOut; ++q) sp[threadIdx.x + kGaussThreads * q] = v[q];
  __syncthreads();
  float acc[kGaussOut];
#pragma unroll
  for (int q = 0; q < kGaussOut; ++q) acc[q] = 0.0f;
  for (int j = 0; j < K; ++j) {
    const float wj = sw[j];
#pragma unroll
    for (int q = 0; q < kGaussOut; ++q)
      acc[q] = __fadd_rn(acc[q],
                         __fmul_rn(sp[threadIdx.x + kGaussThreads * q + j], wj));
  }
#pragma unroll
  for (int q = 0; q < kGaussOut; ++q) {
    const int i = p0 + threadIdx.x + kGaussThreads * q;
    if (i < P) out[row + i] = __fdiv_rn(acc[q], norm[q]);
  }
}

}  // namespace

// C entry points; each returns the launch's cudaError_t.
//
// wf_rebin_interp: rows r = a * inner + b of x (a < rows / inner), row r at
// x + a * stride_a + b * stride_b with unit stride along its bins; taps
// [P, T] int32 (each inside the row) and weights [P, T] f32, contiguous;
// out [rows, P] f32, contiguous.  T is 1, 4 or 8.
extern "C" int wf_rebin_interp(const float* x, long long stride_a,
                               long long stride_b, int rows, int inner,
                               const int* taps, const float* weights, int P,
                               int T, float* out, int rows_per_block,
                               void* stream) {
  if (rows <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (inner <= 0 || rows % inner != 0 || rows_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block,
                  (P + kPixels - 1) / kPixels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1:
      rebin_interp<1><<<grid, kPixels, 0, s>>>(
          x, stride_a, stride_b, inner, taps, weights, out, rows, P,
          rows_per_block);
      break;
    case 4:
      rebin_interp<4><<<grid, kPixels, 0, s>>>(
          x, stride_a, stride_b, inner, taps, weights, out, rows, P,
          rows_per_block);
      break;
    case 8:
      rebin_interp<8><<<grid, kPixels, 0, s>>>(
          x, stride_a, stride_b, inner, taps, weights, out, rows, P,
          rows_per_block);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// wf_rebin_gauss: x and out [rows, P] f32, contiguous; w [K] f32 (K odd,
// the zero pad (K - 1) / 2 on each side) and renorm [P] f32.
extern "C" int wf_rebin_gauss(const float* x, const float* w, int K,
                              const float* renorm, float* out, int rows,
                              int P, void* stream) {
  if (rows <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || K % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kTile = kGaussOut * kGaussThreads;
  const size_t shared = sizeof(float) * (2 * static_cast<size_t>(K) - 1
                                         + kTile);
  const dim3 grid(rows, (P + kTile - 1) / kTile);
  rebin_gauss<<<grid, kGaussThreads, shared,
                static_cast<cudaStream_t>(stream)>>>(x, w, K, renorm, out, P);
  return static_cast<int>(cudaGetLastError());
}
