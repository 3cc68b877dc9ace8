"""Batched spectrum step: exact |rFFT| magnitudes -> EMA -> gated dBFS.

The PyTorch counterpart of ``waveform_tpu/dsp/spectrum.py`` with its
"exact", "matmul" and "xla" FFT backends (:func:`resolve_fft_backend`)
and a caller's ``rfft_fn``.  One function over a
``[S, C, N]`` batch replaces the reference's per-source tick
(reference src/source_generic.cpp:26-180).

State is a plain dataclass of tensors (EMA buffers, the ``m_decibels``
work buffers, the silence latch), every bin axis in natural order.
``decibels`` mirrors the reference's ``m_decibels`` exactly, including its
mixed-domain quirk: in mono downmix the fold writes dBFS into channel 0
while channel 1 keeps the pre-fold linear magnitude.  Silence and timeout
gating follow the JAX step line for line: channel-ordered latch, frozen
old frame when every channel is silent below the floor gate.

Everything after the FFT (the tail) runs on the card as one hand-written
CUDA kernel pair (``kernels/tail_cuda.py``) and on the CPU as torch ops
(:func:`spectrum_tail_ref`); both give the same bits.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import DB_MIN, ResolvedConfig, check_config
from ..core.device import checked_device
from ..core.enums import FFTWindow, TSmoothingMode
from ..kernels.exactfft import rfft_mag_exact, two_prod, two_sum
from ..kernels.matfft import rfft_mag
from ..kernels.tail_cuda import spectrum_tail, tail_constants
from ..runtime import profiler
from .oracle import TV_EMA_DENOM, rolloff_modifiers, slope_modifiers
from .windows import window_coefficients, window_sum


@dataclass
class SpectrumState:
    """Per-stream carried state (the functional ``m_*`` members)."""

    tsmooth: torch.Tensor      # [S, C, nbins] f32 — EMA magnitudes
    decibels: torch.Tensor     # [S, O, nbins] f32 — the m_decibels buffers
    last_silent: torch.Tensor  # [S] bool


def _channels(cfg: ResolvedConfig) -> tuple[int, int]:
    C = max(cfg.capture_channels, 1)
    return C, max(cfg.output_channels, C)


def init_state(cfg: ResolvedConfig, num_streams: int,
               device: torch.device | str = "cuda") -> SpectrumState:
    """A fresh state on ``device`` (the card unless the caller asks for
    the CPU; raises RuntimeError without one)."""
    check_config(cfg)
    device = checked_device(device, "init_state")
    nbins = cfg.fft_size // 2
    C, O = _channels(cfg)
    return SpectrumState(
        tsmooth=torch.zeros((num_streams, C, nbins), dtype=torch.float32,
                            device=device),
        decibels=torch.full((num_streams, O, nbins), DB_MIN,
                            dtype=torch.float32, device=device),
        last_silent=torch.zeros(num_streams, dtype=torch.bool, device=device),
    )


def state_from_numpy(tsmooth: np.ndarray, decibels: np.ndarray,
                     last_silent: np.ndarray,
                     device: torch.device | str = "cuda") -> SpectrumState:
    """A state from natural-order host arrays (copied) on ``device``, as
    :func:`init_state` places it."""
    device = checked_device(device, "state_from_numpy")
    return SpectrumState(
        tsmooth=torch.tensor(np.asarray(tsmooth, np.float32), device=device),
        decibels=torch.tensor(np.asarray(decibels, np.float32), device=device),
        last_silent=torch.tensor(np.asarray(last_silent, bool), device=device))


def state_to_numpy(state: SpectrumState):
    """(tsmooth, decibels, last_silent) as natural-order host arrays."""
    return (state.tsmooth.cpu().numpy(), state.decibels.cpu().numpy(),
            state.last_silent.cpu().numpy())


def display_decibels(cfg: ResolvedConfig,
                     state: SpectrumState) -> torch.Tensor:
    """The dB channels the renderer consumes: [S, display_channels, nbins]."""
    return state.decibels[:, :cfg.display_channels]


# df32 splits of 20*log10(2) and 20/ln(10): the exponent term can reach
# ±128 * 6.02 dB, so a plain f32 constant alone injects up to 4.6e-5 dB
_C_E = np.float64(20.0 * np.log10(2.0))
_C_E_HI = float(np.float32(_C_E))
_C_E_LO = float(np.float32(_C_E - np.float64(np.float32(_C_E))))
_C_M = np.float64(20.0 / np.log(10.0))
_C_M_HI = float(np.float32(_C_M))
_C_M_LO = float(np.float32(_C_M - np.float64(np.float32(_C_M))))
_INV = [float(np.float32(1.0 / k)) for k in (3, 5, 7, 9)]
_SQRT_HALF = float(np.float32(0.7071067811865476))


def _db_from_positive(mag: torch.Tensor) -> torch.Tensor:
    """20·log10(mag) to ~1e-6 dB absolute for mag > 0: exact frexp range
    reduction, an atanh-series ln on [sqrt(.5), sqrt(2)) and a df32
    constant recombination (the JAX package's own numerics, kept so both
    agree to rounding)."""
    f, e = torch.frexp(mag)                    # mag = f * 2^e, f in [.5, 1)
    small = f < _SQRT_HALF
    f = torch.where(small, f * 2.0, f)
    e = (e - small.to(e.dtype)).to(torch.float32)
    z = (f - 1.0) / (f + 1.0)                  # f-1 exact by Sterbenz
    w = z * z
    poly = 1.0 + w * (_INV[0] + w * (_INV[1] + w * (_INV[2] + w * _INV[3])))
    lnf = 2.0 * z * poly
    p, pe = two_prod(e, torch.full_like(e, _C_E_HI))
    q, qe = two_prod(lnf, torch.full_like(lnf, _C_M_HI))
    hi, err = two_sum(p, q)
    return hi + (err + pe + qe + e * _C_E_LO + lnf * _C_M_LO)


def dbfs(mag: torch.Tensor) -> torch.Tensor:
    """20·log10(mag) with DB_MIN for mag <= 0 (src/source.hpp:293-299)."""
    pos = mag > 0.0
    safe = torch.where(pos, mag, torch.ones_like(mag))
    return torch.where(pos, _db_from_positive(safe),
                       torch.full_like(mag, DB_MIN))


def gravity_coefficient(cfg: ResolvedConfig, dt: float) -> float:
    """EMA retain factor as an f32 value (src/source.hpp:301-312)."""
    if cfg.tsmoothing == TSmoothingMode.NONE or cfg.gravity <= 0.0:
        return 0.0
    if cfg.tsmoothing == TSmoothingMode.TVEXPONENTIAL:
        hi = np.float32(cfg.gravity * TV_EMA_DENOM * 5.0)
        return float(np.exp(-np.float32(dt) / hi, dtype=np.float32))
    return float(np.float32(cfg.gravity))


def gravity_pair(cfg: ResolvedConfig, dt: float) -> np.ndarray:
    """(g, 1 − g) as a [2] f32 host array, the values the step computes
    from ``dt`` on the host (:func:`gravity_coefficient`).  Written into a
    device tensor before each replay, they are the ``dt`` a captured tick
    reads (the JAX package's ``DeviceScalarCache`` of ``dt``)."""
    g = np.float32(gravity_coefficient(cfg, dt))
    return np.array([g, np.float32(1.0) - g], np.float32)


def gravity_terms(cfg: ResolvedConfig, dt: float | torch.Tensor):
    """The EMA's (g, 1 − g) for a step's ``dt``: from a float as host f32
    values, from a [2] :func:`gravity_pair` tensor as its 0-d elements."""
    if isinstance(dt, torch.Tensor):
        return dt[0], dt[1]
    g, g2 = gravity_pair(cfg, dt)
    return float(g), float(g2)


def window_pair(cfg: ResolvedConfig, device: torch.device | str = "cuda"):
    """The config's window as a df32 (hi, lo) pair of [N] tensors on
    ``device`` (as :func:`init_state` places them), or None for no window —
    the exact path applies it in double-float."""
    device = checked_device(device, "window_pair")
    if cfg.window == FFTWindow.NONE:
        return None
    w64 = window_coefficients(cfg.window, cfg.fft_size, cfg.sine_exponent,
                              dtype=np.float64)
    w_hi = w64.astype(np.float32)
    w_lo = (w64 - w_hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(w_hi).to(device), torch.from_numpy(w_lo).to(device))


def resolve_fft_backend() -> str:
    """The step's FFT backend, ``WAVEFORM_TPU_FFT_BACKEND`` read when a
    step is built, as the JAX package's ``resolve_fft_backend`` reads it.

    "exact" runs the exact |rFFT| (``kernels/exactfft.rfft_mag_exact``);
    "matmul" the GEMM FFT (``kernels/matfft.rfft_mag``) and "xla"
    ``torch.fft.rfft``, both of the f32-windowed frame, as the JAX
    package's "matmul" and "xla" run them.  Unset (or "auto") is "exact":
    the JAX package picks exact on its accelerator and "xla" on any other
    backend, and this card is the port's accelerator.  Any other value
    raises ValueError.
    """
    backend = os.environ.get("WAVEFORM_TPU_FFT_BACKEND", "auto")
    if backend == "auto":
        return "exact"
    if backend not in ("exact", "matmul", "xla"):
        raise ValueError(f"unknown fft_backend {backend!r}; expected 'auto', "
                         "'exact', 'matmul', or 'xla'")
    return backend


def reads_rotating_ring(cfg: ResolvedConfig, rfft_fn=None,
                        device: torch.device | str = "cuda") -> bool:
    """Whether the step :func:`make_spectrum_step` builds now reads a
    rotating ring's windows in place (its ``head`` argument), so that an
    engine keeps its sample ring rotating (``dsp/devring.py``): on a CUDA
    device, on the exact backend, at an N the pair kernels take
    (``exact_cuda.kernel_would_run``).  Any other step takes no heads
    and raises on them, as the exact router does where the route has
    changed since (``exactfft.check_rotated``)."""
    from ..kernels.exact_cuda import kernel_would_run

    return (torch.device(device).type == "cuda" and rfft_fn is None
            and resolve_fft_backend() == "exact"
            and kernel_would_run(cfg.fft_size))


def _mag_tail(cfg: ResolvedConfig, mag: torch.Tensor,
              slope: torch.Tensor | None) -> torch.Tensor:
    """2/Σw normalization and the slope modifiers."""
    coeff = float(np.float32(2.0 / window_sum(cfg.window, cfg.fft_size,
                                              cfg.sine_exponent)))
    mag = mag * coeff
    if slope is not None:
        mag = mag * slope
    return mag


def tail_tables(cfg: ResolvedConfig,
                device: torch.device | str = "cuda"):
    """The step's per-bin tables on ``device``: ``(slope, rolloff)``, each
    an [nbins] f32 tensor or None where the config has none."""
    nbins = cfg.fft_size // 2
    slope = None
    if cfg.slope > 0.0:
        slope = torch.from_numpy(
            slope_modifiers(nbins, cfg.slope).astype(np.float32)).to(device)
    rolloff = None
    if cfg.rolloff_q > 0.0 and cfg.rolloff_rate > 0.0:
        rolloff = torch.from_numpy(rolloff_modifiers(
            cfg.fft_size, cfg.audio.samples_per_sec, cfg.cutoff_low,
            cfg.cutoff_high, cfg.rolloff_q,
            cfg.rolloff_rate).astype(np.float32)).to(device)
    return slope, rolloff


def spectrum_tail_ref(cfg: ResolvedConfig, mag: torch.Tensor,
                      nz_k: torch.Tensor, valid: torch.Tensor | None,
                      state: SpectrumState, dt: float | torch.Tensor,
                      active: torch.Tensor, input_rms: torch.Tensor,
                      run: torch.Tensor | None = None,
                      slope: torch.Tensor | None = None,
                      rolloff: torch.Tensor | None = None) -> SpectrumState:
    """The step after the |rFFT|, in torch ops: 2/Σw and the slope, the
    EMA, silence and timeout gating, the channel fold, dBFS, volume
    normalization, roll-off and the ``run`` freeze.  ``mag`` [S, C, nbins]
    and ``nz_k`` [S, C] are the FFT's magnitudes and nonzero predicate,
    ``slope`` and ``rolloff`` the step's :func:`tail_tables`; the rest as
    the step takes them.  The step runs it on CPU tensors; on the card it
    is the plain version of ``kernels/tail_cuda.spectrum_tail``, which
    gives the same bits."""
    C, O = _channels(cfg)
    D = cfg.display_channels
    floor_gate = float(np.float32(cfg.floor - 10))
    if valid is None:
        valid = torch.ones(nz_k.shape, dtype=torch.bool, device=nz_k.device)
    g, g2 = gravity_terms(cfg, dt)
    mag = _mag_tail(cfg, mag, slope)                  # [S, C, nbins]

    if cfg.tsmoothing != TSmoothingMode.NONE:
        old = state.tsmooth
        if cfg.fast_peaks:
            old = torch.maximum(mag, old)
        mag_s = g * old + g2 * mag
    else:
        mag_s = mag

    # --- silence gating (src/source_generic.cpp:63-95) ---
    # channels whose ring lacked data neither scan nor count
    nz = nz_k & valid
    # latch value as seen by channel c: earlier channels may clear it
    ls0 = state.last_silent
    ls_seen_list = [ls0]
    for c in range(1, C):
        ls_seen_list.append(ls_seen_list[-1] & ~nz[:, c - 1])
    ls_seen = torch.stack(ls_seen_list, dim=1)        # [S, C]

    # outsilent: display-channel dB all <= floor-10 (channel 0 in mono)
    disp_ch = [c if cfg.stereo else 0 for c in range(C)]
    out_silent = torch.stack(
        [torch.all(state.decibels[:, disp_ch[c]] <= floor_gate, dim=-1)
         for c in range(C)], dim=1)                   # [S, C]

    silent = ~nz
    if not cfg.stereo and C > 1:
        # sequential-channel parity: the reference scans m_decibels[0]
        # MID-tick, so once an earlier channel processes, the buffer
        # holds fresh LINEAR magnitudes (>= 0, above the negative gate)
        # and a later silent channel can never read outsilent
        os0 = out_silent[:, 0]
        os_list = [os0]
        proc_before = valid[:, 0] & ~(silent[:, 0]
                                      & (ls_seen[:, 0] | os0))
        for c in range(1, C):
            osc = out_silent[:, c] & ~proc_before
            os_list.append(osc)
            proc_before = proc_before | (
                valid[:, c] & ~(silent[:, c] & (ls_seen[:, c] | osc)))
        out_silent = torch.stack(os_list, dim=1)
    skip = ~valid | (silent & (ls_seen | out_silent))  # keeps old state
    counted = valid & silent & ~ls_seen & out_silent   # adds to latch
    latch_survives = ls0 & torch.all(~nz, dim=1)
    latch_set = torch.all(counted, dim=1)
    new_last_silent = latch_survives | latch_set      # [S]

    pm = (~skip)[:, :, None]
    new_tsmooth = torch.where(pm, mag_s, state.tsmooth)
    # skipped channels keep their old m_decibels value verbatim
    work = torch.where(pm, mag_s, state.decibels[:, :C])

    # --- duplicate mono capture for stereo output (src:141-142) ---
    if O > C:
        work = torch.cat([work, work[:, :1]], dim=1)  # [S, O, nbins]

    # --- channel fold (src/source_generic.cpp:144-159) ---
    if cfg.stereo:
        folded = dbfs(work)
    elif C == 2:
        d0 = dbfs((work[:, :1] + work[:, 1:2]) * 0.5)
        folded = torch.cat([d0, work[:, 1:]], dim=1)
    else:
        folded = dbfs(work)

    # --- volume normalization, display channels, bins>=1 (src:161-167)
    if cfg.normalize_volume:
        comp = torch.clamp_max(cfg.volume_target - dbfs(input_rms),
                               cfg.max_gain)
        folded[:, :D, 1:] += comp[:, None, None]

    # --- roll-off, display channels, bins>=1 (src:169-179) ---
    if rolloff is not None:
        folded[:, :D, 1:] = torch.clamp_min(
            folded[:, :D, 1:] - rolloff[1:], DB_MIN)

    # streams that latched silent keep their previous frame verbatim
    frozen = new_last_silent[:, None, None]
    new_db = torch.where(frozen, state.decibels, folded)

    # --- timeout / hidden: decay to DB_MIN unless already latched ---
    # (src/source_generic.cpp:36-48); only display channels are cleared
    timed_out = ~active
    to_fresh = (timed_out & ~state.last_silent)[:, None, None]
    to_bc = timed_out[:, None, None]
    new_tsmooth = torch.where(
        to_fresh, torch.zeros_like(new_tsmooth),
        torch.where(to_bc, state.tsmooth, new_tsmooth))
    cleared = state.decibels.clone()
    cleared[:, :D] = DB_MIN
    new_db = torch.where(to_fresh, cleared,
                         torch.where(to_bc, state.decibels, new_db))
    new_last_silent = timed_out | new_last_silent

    if run is not None:
        # streams whose tick never ran freeze verbatim
        # (src/source.cpp:1333-1336 early return)
        rb = run[:, None, None]
        new_tsmooth = torch.where(rb, new_tsmooth, state.tsmooth)
        new_db = torch.where(rb, new_db, state.decibels)
        new_last_silent = torch.where(run, new_last_silent,
                                      state.last_silent)

    return SpectrumState(tsmooth=new_tsmooth, decibels=new_db,
                         last_silent=new_last_silent)


def make_spectrum_step(cfg: ResolvedConfig, rfft_fn=None,
                       device: torch.device | str = "cuda"):
    """Build the spectrum step for a resolved config on ``device`` (the
    card unless the caller asks for the CPU; raises RuntimeError without
    one), on the FFT backend :func:`resolve_fft_backend` reads now.

    A caller's ``rfft_fn`` overrides every backend: it takes the
    f32-windowed frame [S, C, N] and returns a complex tensor whose bins
    past N/2 are dropped (the exact kernels never run under it).  In a
    captured tick it is captured like any other op, so it must not
    synchronize with the host.

    After the FFT, CUDA tensors run the tail as one hand-written kernel
    pair (``kernels/tail_cuda.spectrum_tail``, two launches), CPU tensors
    as torch ops (:func:`spectrum_tail_ref`); both give the same bits.

    Returns ``step(samples, state, dt, active, input_rms, valid=None,
    run=None, head=None) -> SpectrumState``:

    * ``samples``   [S, C, N] f32 — assembled frames, or a rotating ring's
      buffer with its heads ``head`` [S, C] int32 (``dsp/devring.py``:
      frame (s, c) starts at ``head[s, c]`` and wraps), which only the
      exact pair kernels read (:func:`reads_rotating_ring`)
    * ``dt``        seconds since the last tick (Python float), or its
      :func:`gravity_pair` as a [2] f32 tensor on the step's device (the
      form a captured CUDA graph reads; the same bits)
    * ``active``    [S] bool — show && capture-fresh
    * ``input_rms`` [S] f32 — volume-normalization RMS (0 if unused)
    * ``valid``     [S, C] bool — channels whose ring held data (default all)
    * ``run``       [S] bool — streams whose tick ran (default all)
    """
    check_config(cfg)
    device = checked_device(device, "make_spectrum_step")
    nbins = cfg.fft_size // 2
    backend = "rfft_fn" if rfft_fn is not None else resolve_fft_backend()
    window = window_pair(cfg, device) if backend == "exact" else None
    w32 = None
    if backend != "exact" and cfg.window != FFTWindow.NONE:
        w32 = torch.from_numpy(window_coefficients(
            cfg.window, cfg.fft_size, cfg.sine_exponent,
            dtype=np.float32)).to(device)
    slope, rolloff = tail_tables(cfg, device)
    tail = tail_constants(cfg)

    def step(samples: torch.Tensor, state: SpectrumState,
             dt: float | torch.Tensor, active: torch.Tensor,
             input_rms: torch.Tensor, valid: torch.Tensor | None = None,
             run: torch.Tensor | None = None,
             head: torch.Tensor | None = None) -> SpectrumState:
        samples = samples.to(torch.float32)
        if backend == "exact":
            mag, nz_k = rfft_mag_exact(samples, window, head)
        else:
            if head is not None:
                raise ValueError(f"the {backend!r} backend reads no "
                                 f"rotating ring (reads_rotating_ring)")
            x = samples if w32 is None else samples * w32
            if backend == "matmul":
                mag = rfft_mag(x, nbins)
            elif backend == "xla":
                mag = torch.fft.rfft(x).abs()[..., :nbins]
            else:   # drop Nyquist, as the reference does
                mag = rfft_fn(x)[..., :nbins].abs().to(torch.float32)
            nz_k = torch.any(samples != 0.0, dim=-1)
        profiler.mark("tick.fft")
        if mag.device.type != "cuda":
            return spectrum_tail_ref(cfg, mag, nz_k, valid, state, dt, active,
                                     input_rms, run, slope, rolloff)
        gravity = dt if isinstance(dt, torch.Tensor) else gravity_pair(cfg, dt)
        return SpectrumState(*spectrum_tail(
            tail, mag.contiguous(), nz_k.contiguous(),
            None if valid is None else valid.contiguous(), state.tsmooth,
            state.decibels, state.last_silent, gravity, active.contiguous(),
            input_rms.contiguous() if tail.normalize else None,
            None if run is None else run.contiguous(), slope, rolloff))

    return step
