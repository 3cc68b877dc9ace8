// The rotating device ring's push (dsp/devring.push_rotating,
// kernels/ring_cuda.py): each (stream, channel) row of buf [S, C, L] keeps
// its samples where they were written, and head [S, C] says where the
// row's oldest sample sits, so logical sample j of the window is
// buf[(head + j) mod L].  A push writes the row's count of new samples at
// (head + i) mod L and advances head by the count mod L.
//
// It replaces no Pallas kernel: the JAX ring (waveform_tpu/dsp/devring.py)
// shifts its window with a dynamic_slice, which on the card was three
// passes over the whole ring a tick (a concatenation, a gather and a copy
// back: 3 x 16.8 MB at (S, C, L) = (32, 2, 65536)).  Bytes bound the push:
// the new samples read and written once, at most S*C*H*4 each way (0.41 MB
// at H = 1616), ~0.25 us at 3.35 TB/s, so the launch sets its time.  One
// block a row reads the row's head, and thread 0 advances it after every
// thread of the block has read it.  The count is read on the device (a
// 0-d or an [S] float32 tensor of whole numbers: the packed upload's own
// count column, so no conversion runs before the push) so that a
// captured graph replays whatever count was written before the replay,
// and is clamped to [0, H] as the JAX ring's dynamic slice clamps it.  A
// count above L keeps only the last L samples, each written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ring_push(float* __restrict__ buf, int* __restrict__ head,
          const float* __restrict__ fresh, long long stride_s,
          long long stride_c, const float* __restrict__ counts,
          long long count_stride, int host_count, int channels, int L,
          int H) {
  const int row = blockIdx.x;               // stream * C + channel
  const int s = row / channels;
  const int c = row - s * channels;
  // truncated toward zero, then clamped (NaN to 0), as torch's
  // .to(int64).clamp(0, H) takes it
  const float k = counts ? counts[s * count_stride]
                         : static_cast<float>(host_count);
  const int count = !(k > 0.0f) ? 0
                    : k >= static_cast<float>(H) ? H
                                                 : static_cast<int>(k);
  const int h = head[row];
  __syncthreads();                          // every thread has read head
  if (threadIdx.x == 0) head[row] = (h + count) % L;
  float* dst = buf + static_cast<size_t>(row) * L;
  const float* src = fresh + s * stride_s + c * stride_c;
  for (int i = (count > L ? count - L : 0) + threadIdx.x; i < count;
       i += kThreads)
    dst[(h + i) % L] = src[i];
}

}  // namespace

// C entry point: buf [S, C, L] f32 and head [S, C] int32 (each in [0, L)),
// contiguous, updated in place; fresh [S, C, H] f32 with element (s, c, i)
// at s * stride_s + c * stride_c + i; counts a float32 pointer read at
// s * count_stride (0: one count for every stream), or null for
// host_count (in [0, H]).  Returns the launch's cudaError_t.
extern "C" int wf_ring_push(float* buf, int* head, const float* fresh,
                            long long stride_s, long long stride_c,
                            const float* counts, long long count_stride,
                            int host_count, int streams, int channels, int L,
                            int H, void* stream) {
  if (streams <= 0 || channels <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  ring_push<<<streams * channels, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      buf, head, fresh, stride_s, stride_c, counts, count_stride, host_count,
      channels, L, H);
  return static_cast<int>(cudaGetLastError());
}
