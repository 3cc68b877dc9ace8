"""Device-resident audio window ring.

The PyTorch counterpart of ``waveform_tpu/dsp/devring.py``: the rolling
window of every stream lives on the device as ``[S, C, L]`` f32, and each
tick pushes only the newly arrived samples (padded to a hop budget ``H``)
plus how many of them are valid.  The buffer is contiguous ``[S, C, L]``,
which is the layout the exact |rFFT| kernel reads directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import checked_device


@dataclass
class DeviceRing:
    """Rolling sample windows: ``buf[s, c, -1]`` is the newest sample."""

    buf: torch.Tensor  # [S, C, L] f32, contiguous


def init_ring(num_streams: int, channels: int, window: int,
              device: torch.device | str = "cuda") -> DeviceRing:
    """A silent ring on ``device`` (the card unless the caller asks for
    the CPU; raises RuntimeError without one)."""
    return DeviceRing(buf=torch.zeros(
        (num_streams, channels, window), dtype=torch.float32,
        device=checked_device(device, "init_ring")))


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
