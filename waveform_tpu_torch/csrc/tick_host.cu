// The upload of a served tick without torch's per-call dispatch: one
// asynchronous copy from pinned host memory to the device, then the
// record of the event that frees the host buffer for reuse, on one
// stream.  runtime/serving.py's upload calls it through ctypes for every
// packed upload on the card.
//
// No kernel here, and none replaced: the JAX engine's upload is
// jax.device_put.  It does what torch's copy_(non_blocking=True) and
// Event.record do for the same arguments, minus the dispatch around them.

#include <cuda_runtime.h>

// Copy ``bytes`` from pinned host memory ``src`` to device memory ``dst``
// on ``stream`` of card ``device``, asynchronously, then record ``event``
// on the stream; the thread's current card is given back after.  Returns
// the CUDA error code (0: none).
extern "C" int wf_tick_upload(void* dst, const void* src, long long bytes,
                              void* stream, void* event, int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                        cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess)
    err = cudaEventRecord(static_cast<cudaEvent_t>(event), s);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
