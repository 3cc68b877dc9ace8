"""The rotating device ring's push on the card: one hand-written CUDA kernel.

A rotating ring (``dsp/devring.py``, ``DeviceRing.head`` set) keeps each
(stream, channel) row's samples where they were written: ``head`` [S, C]
int32 says where the row's oldest sample sits, so logical sample ``j`` of
the window is ``buf[..., (head + j) mod L]``.  A push writes the new
samples at ``(head + i) mod L`` and advances the head, where the shifting
ring (``devring.push``) moved the whole window: at (S, C, L) = (32, 2,
65536) three passes over its 16.8 MB a tick against at most 0.41 MB
here.  The readers that honour the head are the exact pair kernels
(``kernels/exact_cuda.py``, their ``head`` argument) and their CPU
twins; :func:`unrolled` gives the windows in order to code outside the
tick (``dsp/devring.window``).

:func:`ring_push` launches ``csrc/ring_push.cu`` (built into the port's
CUDA library, ``cuda_lib.build``, counted as ``LAUNCHES["ring"]``) on a
CUDA tensor and runs the plain version :func:`ring_push_ref` on a CPU
tensor; both give the same ring.  It replaces no Pallas kernel: the JAX
ring shifts its window with a ``dynamic_slice``.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def ring_push_ref(buf: torch.Tensor, head: torch.Tensor, new: torch.Tensor,
                  counts) -> None:
    """Plain PyTorch version of :func:`ring_push`, in place: the last
    ``min(count, L)`` of each row's ``count`` new samples land at ``(head
    + i) mod L`` (distinct positions), then ``head`` advances by the count
    mod L."""
    S, C, L = buf.shape
    H = new.shape[-1]
    count = torch.as_tensor(counts).to(torch.int64).clamp(0, H).expand(S)
    count = count[:, None, None]
    i = torch.arange(H, device=buf.device)
    keep = ((i >= count - L) & (i < count)).expand(S, C, H)
    pos = (head.to(torch.int64)[..., None] + i) % L
    s, c, _ = keep.nonzero(as_tuple=True)
    buf[s, c, pos[keep]] = new.to(torch.float32)[keep]
    head.copy_((head.to(torch.int64) + count[..., 0]) % L)


def ring_push(buf: torch.Tensor, head: torch.Tensor, new: torch.Tensor,
              counts) -> None:
    """Push ``new`` [S, C, H] f32 (left-aligned, zero-padded) into the
    rotating ring ``buf`` [S, C, L] f32 with heads ``head`` [S, C] int32
    (each in [0, L)), both contiguous and updated in place.

    ``counts``: every stream alike as a host int or a 0-d tensor on the
    ring's device (read on the device, so a captured graph replays
    whatever count was written before the replay), or an [S] tensor there
    (a count per stream), of whole numbers in any dtype (the kernel reads
    float32: a packed upload's count column as it is); each truncated and
    clamped to [0, H] as ``.to(torch.int64).clamp(0, H)`` would.  Row
    (s, c) takes its ``counts[s]`` new samples, as ``devring.push`` takes
    them, and its logical window afterwards is the shifting ring's.
    """
    S, C, L = buf.shape
    H = new.shape[-1]
    if (buf.dtype != torch.float32 or not buf.is_contiguous()
            or head.shape != (S, C) or head.dtype != torch.int32
            or not head.is_contiguous() or new.shape[:2] != (S, C)
            or head.device != buf.device or new.device != buf.device):
        raise ValueError(
            f"ring_push takes a contiguous [S, C, L] float32 ring with "
            f"contiguous [S, C] int32 heads and [S, C, H] samples on its "
            f"device; got {tuple(buf.shape)} {buf.dtype}, {tuple(head.shape)} "
            f"{head.dtype}, {tuple(new.shape)}")
    if buf.device.type == "cpu":
        ring_push_ref(buf, head, new, counts)
        return
    if new.dtype != torch.float32 or new.stride(-1) != 1:
        new = new.to(torch.float32).contiguous()
    if isinstance(counts, torch.Tensor):
        if counts.device != buf.device or counts.dim() not in (0, 1):
            raise ValueError("counts must be a 0-d or [S] tensor on the "
                             "ring's device")
        counts = counts.to(torch.float32)
        ptr, stride, host = (counts.data_ptr(),
                             counts.stride(0) if counts.dim() else 0, 0)
    else:
        ptr, stride, host = None, 0, min(max(int(counts), 0), H)
    dev = buf.device
    with torch.cuda.device(dev):
        err = cuda_lib.build().wf_ring_push(
            buf.data_ptr(), head.data_ptr(), new.data_ptr(), new.stride(0),
            new.stride(1), ptr, stride, host, S, C, L, H,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_push kernel launch failed: cudaError {err}")
    cuda_lib.launched("ring")


def unrolled(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The windows of a rotating ring's buffer ``x`` [..., L] with heads
    ``head`` [...] in order: a new tensor whose ``[..., j]`` is ``x[...,
    (head + j) mod L]``."""
    L = x.shape[-1]
    idx = (head.to(torch.int64)[..., None]
           + torch.arange(L, device=x.device)) % L
    return x.gather(-1, idx)
