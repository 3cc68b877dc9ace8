"""Device-resident audio window ring.

The PyTorch counterpart of ``waveform_tpu/dsp/devring.py``: the rolling
window of every stream lives on the device as ``[S, C, L]`` f32, and each
tick pushes only the newly arrived samples (padded to a hop budget ``H``)
plus how many of them are valid.  The buffer is contiguous ``[S, C, L]``,
which is the layout the exact |rFFT| kernel reads directly.

Two layouts, chosen when the ring is made.  A shifting ring (:func:`push`)
holds each window in order, ``buf[s, c, -1]`` the newest sample, and moves
the whole window on every push, as the JAX ring does.  A rotating ring
(``init_ring(..., rotating=True)``, :func:`push_rotating`) writes only the
new samples and keeps a head per row (``DeviceRing.head``): logical
sample ``j`` is ``buf[s, c, (head[s, c] + j) mod L]``.  Only readers that
take the head (the exact pair kernels) read a rotating ring in the tick;
code outside the tick reads :func:`window`, the windows in order, and
writes them with :func:`set_window`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import checked_device
from ..kernels.ring_cuda import ring_push, unrolled


@dataclass
class DeviceRing:
    """Rolling sample windows.  Shifting (``head`` None): ``buf[s, c, -1]``
    is the newest sample.  Rotating: ``buf[s, c, head[s, c]]`` is the
    oldest."""

    buf: torch.Tensor  # [S, C, L] f32, contiguous
    head: torch.Tensor | None = None  # [S, C] int32 in [0, L): rotating


def init_ring(num_streams: int, channels: int, window: int,
              device: torch.device | str = "cuda",
              rotating: bool = False) -> DeviceRing:
    """A silent ring on ``device`` (the card unless the caller asks for
    the CPU; raises RuntimeError without one); ``rotating``: with its
    heads at 0, for :func:`push_rotating`."""
    dev = checked_device(device, "init_ring")
    buf = torch.zeros((num_streams, channels, window), dtype=torch.float32,
                      device=dev)
    head = (torch.zeros((num_streams, channels), dtype=torch.int32,
                        device=dev) if rotating else None)
    return DeviceRing(buf=buf, head=head)


def ring_from_numpy(buf: np.ndarray,
                    device: torch.device | str = "cuda") -> DeviceRing:
    """A ring holding ``buf`` [S, C, L] (natural layout, copied) on
    ``device``, as :func:`init_ring` places it."""
    return DeviceRing(buf=torch.tensor(
        np.asarray(buf, np.float32),
        device=checked_device(device, "ring_from_numpy")))


def push(ring: DeviceRing, new: torch.Tensor,
         counts: int | torch.Tensor) -> DeviceRing:
    """Advance each stream's window by ``counts[s]`` samples, in place.

    * ``new``    [S, C, H] f32 — fresh samples, left-aligned, zero-padded
    * ``counts`` advancing every stream alike (the lockstep steady state:
      one shift of the whole batch) as a Python int, or as a 0-d integer
      tensor on the ring's device (the JAX ring's traced scalar
      ``dynamic_slice``: the shift is read on the device, so a captured
      CUDA graph replays it with whatever count was written before the
      replay); or an [S] integer tensor on the ring's device (a per-stream
      gather)

    window'[s] = (window[s] ++ new[s])[counts[s] : counts[s] + L], with
    counts clamped to [0, H] as the JAX ring's dynamic slice clamps them.
    ``ring.buf`` is overwritten and the same ring is returned (the JAX
    ring returns a new array; the port updates in place).
    """
    buf = ring.buf
    L, H = buf.shape[-1], new.shape[-1]
    full = torch.cat([buf, new.to(torch.float32)], dim=-1)     # [S, C, L+H]
    if isinstance(counts, torch.Tensor):
        start = counts.to(torch.int64).clamp(0, H)
        idx = start[..., None] + torch.arange(L, device=buf.device)
        if counts.dim() == 0:
            buf.copy_(full.index_select(-1, idx))
        else:
            buf.copy_(torch.gather(full, -1, idx[:, None].expand(buf.shape)))
    else:
        c = min(max(int(counts), 0), H)
        buf.copy_(full[..., c:c + L])
    return ring


def push_rotating(ring: DeviceRing, new: torch.Tensor,
                  counts: int | torch.Tensor) -> DeviceRing:
    """:func:`push` on a rotating ring, in place: each row's new samples
    are written after its newest and its head advances past them
    (``kernels/ring_cuda.ring_push``: one kernel on the card).  The same
    arguments and clamp; afterwards :func:`window` equals what
    :func:`push` leaves in a shifting ring.  Returns ``ring``."""
    ring_push(ring.buf, ring.head, new, counts)
    return ring


def window(ring: DeviceRing) -> torch.Tensor:
    """The windows in order, [S, C, L]: ``ring.buf`` itself for a
    shifting ring, a new tensor for a rotating one."""
    if ring.head is None:
        return ring.buf
    return unrolled(ring.buf, ring.head)


def set_window(ring: DeviceRing, buf: torch.Tensor) -> None:
    """Overwrite the windows with ``buf`` [S, C, L] (in order), in place."""
    ring.buf.copy_(buf)
    if ring.head is not None:
        ring.head.zero_()
