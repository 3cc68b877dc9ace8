"""The spectrum tail on the card: one hand-written CUDA kernel pair.

Everything the spectrum step does after the |rFFT| (``dsp/spectrum.py``:
2/Σw and the slope, the EMA, silence and timeout gating, the mono or
stereo fold, dBFS, volume normalization, roll-off, the ``run`` freeze) as
two launches of ``csrc/spectrum_tail.cu``, built into the port's CUDA
library (``cuda_lib.build``) and counted there as ``LAUNCHES["tail"]``.

It replaces no Pallas kernel: the JAX package's tail
(``waveform_tpu/dsp/spectrum.py``) is jnp code that XLA fuses.  Run op by
op in PyTorch (``dsp/spectrum.spectrum_tail_ref``, the plain version) it
is about 95 elementwise kernels, each of which reads and writes whole
[S, C, N/2] arrays.  Bytes bound it: at (N, S) = (65536, 32) the work needs
33.6-46.1 MB of device memory traffic, 10-14 us at 3.35 TB/s.  The silence
gate is a reduction over a whole channel that every bin depends on, so
the first launch (the gate) tests slices of the old display channel and
the second (the fused tail) folds their flags with the stream's small
inputs and streams every bin once, in 16-byte vectors.  Each op rounds
once, as the torch op does, so the pair gives the plain version's bits.

A CUDA tensor launches the pair (a failed build or launch raises; there
is no fallback); the step sends CPU tensors to the plain version and
never builds the library.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import ResolvedConfig
from ..core.enums import TSmoothingMode
from ..dsp.windows import window_sum
from . import cuda_lib

THREADS = 256                   # a block's threads (csrc: kThreads)
GATE_BLOCKS = 132 * 2           # the gate's blocks over all streams: two on
                                # each of the H100's 132 SMs
VEC = 4                         # floats in a 16-byte vector

# flag bits of wf_spectrum_tail
STEREO, SMOOTH, FAST_PEAKS, NORMALIZE = 1, 2, 4, 8


@dataclass(frozen=True)
class TailConstants:
    """What the kernel pair takes from the config, fixed when a step is
    built: the branches ``make_spectrum_step`` takes."""

    channels: int           # C: capture channels
    outputs: int            # O: m_decibels channels
    display: int            # D: display channels
    stereo: bool
    smooth: bool            # temporal smoothing on: the EMA runs
    fast_peaks: bool
    normalize: bool
    coeff: float            # 2/Σw as f32
    floor_gate: float       # floor - 10 as f32
    volume_target: float    # as f32
    max_gain: float         # as f32

    @property
    def flags(self) -> int:
        return ((STEREO if self.stereo else 0) | (SMOOTH if self.smooth else 0)
                | (FAST_PEAKS if self.fast_peaks else 0)
                | (NORMALIZE if self.normalize else 0))


def _f32(v) -> float:
    return float(np.float32(v))


def tail_constants(cfg: ResolvedConfig) -> TailConstants:
    """The kernel's constants for ``cfg``: C and O as the step's
    ``_channels``, D = ``display_channels``, the step's EMA test
    (``tsmoothing`` not NONE), and its f32 scalars."""
    c = max(cfg.capture_channels, 1)
    return TailConstants(
        channels=c, outputs=max(cfg.output_channels, c),
        display=cfg.display_channels, stereo=bool(cfg.stereo),
        smooth=cfg.tsmoothing != TSmoothingMode.NONE,
        fast_peaks=bool(cfg.fast_peaks),
        normalize=bool(cfg.normalize_volume),
        coeff=_f32(2.0 / window_sum(cfg.window, cfg.fft_size,
                                    cfg.sine_exponent)),
        floor_gate=_f32(cfg.floor - 10), volume_target=_f32(cfg.volume_target),
        max_gain=_f32(cfg.max_gain))


def tail_grid(streams: int, nbins: int, vec: int) -> int:
    """The gate's blocks a stream (one flag each): enough for GATE_BLOCKS
    over all streams, no more than the stream's vectors fill.  The fused
    tail sizes its own grid from the card's occupancy."""
    per_stream = math.ceil(GATE_BLOCKS / max(streams, 1))
    return max(1, min(per_stream, math.ceil(nbins // vec / THREADS)))


def _check(name: str, t, shape, dtype) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spectrum_tail(k: TailConstants, mag, nz_k, valid, tsmooth, decibels,
                  last_silent, gravity, active, input_rms, run=None,
                  slope=None, rolloff=None, stages: int = 3):
    """The tail of the spectrum step on CUDA tensors: returns
    ``(tsmooth [S, C, nbins], decibels [S, O, nbins], last_silent [S])``,
    new tensors, bit for bit ``spectrum_tail_ref``'s.

    ``mag`` [S, C, nbins] f32 (the |rFFT| before 2/Σw), ``nz_k`` [S, C]
    bool, ``valid`` [S, C] bool or None (all), the old state's three
    tensors, ``gravity`` the EMA's (g, 1 − g) as a [2] f32 tensor on the
    device (the form a captured graph reads) or a pair of floats,
    ``active`` [S] bool, ``input_rms`` [S] f32 (read under normalize; may
    be None otherwise), ``run`` [S] bool or None (all), ``slope`` and
    ``rolloff`` [nbins] f32 tables or None.  Every tensor contiguous;
    anything else raises ValueError.  ``stages`` 1 or 2 launches the gate
    or the fused tail alone (for timing)."""
    S, C, n = mag.shape if mag.dim() == 3 else (0, 0, 0)
    if C != k.channels:
        raise ValueError(f"mag must be [S, {k.channels}, nbins] float32, got "
                         f"{tuple(mag.shape)}")
    f32, b8 = torch.float32, torch.bool
    _check("mag", mag, (S, C, n), f32)
    _check("nz_k", nz_k, (S, C), b8)
    if valid is not None:
        _check("valid", valid, (S, C), b8)
    _check("tsmooth", tsmooth, (S, C, n), f32)
    _check("decibels", decibels, (S, k.outputs, n), f32)
    _check("last_silent", last_silent, (S,), b8)
    _check("active", active, (S,), b8)
    rms = input_rms if k.normalize else None
    if rms is not None:
        _check("input_rms", rms, (S,), f32)
    if run is not None:
        _check("run", run, (S,), b8)
    for name, t in (("slope", slope), ("rolloff", rolloff)):
        if t is not None:
            _check(name, t, (n,), f32)
    grav, g, g2 = None, 0.0, 0.0
    if isinstance(gravity, torch.Tensor):
        _check("gravity", gravity, (2,), f32)
        grav = gravity
    else:
        g, g2 = (_f32(v) for v in gravity)
    inputs = (mag, nz_k, valid, tsmooth, decibels, last_silent, grav, active,
              rms, run, slope, rolloff)       # the C signature's order
    dev = mag.device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in inputs):
        raise ValueError("spectrum_tail takes CUDA tensors on one device; "
                         "the CPU runs dsp/spectrum.spectrum_tail_ref")
    if stages not in (1, 2, 3):
        raise ValueError(f"stages must be 1, 2 or 3, got {stages}")
    rows = (mag, tsmooth, decibels, slope, rolloff)
    vec = VEC if n % VEC == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in rows) else 1
    blocks = tail_grid(S, n, vec)
    tested = C if k.stereo else 1
    partial = torch.empty(S * tested * blocks, dtype=torch.uint8, device=dev)
    out = (torch.empty_like(tsmooth), torch.empty_like(decibels),
           torch.empty_like(last_silent))
    with torch.cuda.device(dev):
        err = cuda_lib.build().wf_spectrum_tail(
            *(None if t is None else t.data_ptr() for t in inputs),
            partial.data_ptr(), *(t.data_ptr() for t in out), S, n, C,
            k.outputs, k.display, k.flags, vec, blocks, g, g2, k.coeff,
            k.floor_gate, k.volume_target, k.max_gain, stages,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spectrum_tail kernel launch failed: cudaError "
                           f"{err}")
    cuda_lib.launched("tail", (stages & 1) + (stages >> 1))
    return out
