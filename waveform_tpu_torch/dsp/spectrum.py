"""Batched spectrum step: exact |rFFT| magnitudes -> EMA -> gated dBFS.

The PyTorch counterpart of ``waveform_tpu/dsp/spectrum.py`` with its
"exact" and "xla" FFT backends (:func:`resolve_fft_backend`).  One function over a
``[S, C, N]`` batch replaces the reference's per-source tick
(reference src/source_generic.cpp:26-180).

State is a plain dataclass of tensors (EMA buffers, the ``m_decibels``
work buffers, the silence latch), every bin axis in natural order.
``decibels`` mirrors the reference's ``m_decibels`` exactly, including its
mixed-domain quirk: in mono downmix the fold writes dBFS into channel 0
while channel 1 keeps the pre-fold linear magnitude.  Silence and timeout
gating follow the JAX step line for line: channel-ordered latch, frozen
old frame when every channel is silent below the floor gate.
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
    "xla" runs ``torch.fft.rfft`` of the f32-windowed frame, as the JAX
    package's "xla" runs ``jnp.fft.rfft``.  Unset (or "auto") is "exact":
    the JAX package picks exact on its accelerator and "xla" on any other
    backend, and this card is the port's accelerator.  "matmul" (the JAX
    package's ``kernels/matfft.py``) is not ported yet and raises
    NotImplementedError; any other value raises ValueError.
    """
    backend = os.environ.get("WAVEFORM_TPU_FFT_BACKEND", "auto")
    if backend == "auto":
        return "exact"
    if backend == "matmul":
        raise NotImplementedError(
            "WAVEFORM_TPU_FFT_BACKEND=matmul: the matmul FFT backend "
            "(waveform_tpu/kernels/matfft.py) is not ported yet (ROADMAP A14)")
    if backend not in ("exact", "xla"):
        raise ValueError(f"unknown fft_backend {backend!r}; expected 'auto', "
                         "'exact', 'matmul', or 'xla'")
    return backend


def _mag_tail(cfg: ResolvedConfig, mag: torch.Tensor,
              slope: torch.Tensor | None) -> torch.Tensor:
    """2/Σw normalization and the slope modifiers."""
    coeff = float(np.float32(2.0 / window_sum(cfg.window, cfg.fft_size,
                                              cfg.sine_exponent)))
    mag = mag * coeff
    if slope is not None:
        mag = mag * slope
    return mag


def make_spectrum_step(cfg: ResolvedConfig,
                       device: torch.device | str = "cuda"):
    """Build the spectrum step for a resolved config on ``device`` (the
    card unless the caller asks for the CPU; raises RuntimeError without
    one), on the FFT backend :func:`resolve_fft_backend` reads now.

    Returns ``step(samples, state, dt, active, input_rms, valid=None,
    run=None) -> SpectrumState``:

    * ``samples``   [S, C, N] f32 — assembled frames
    * ``dt``        seconds since the last tick (Python float)
    * ``active``    [S] bool — show && capture-fresh
    * ``input_rms`` [S] f32 — volume-normalization RMS (0 if unused)
    * ``valid``     [S, C] bool — channels whose ring held data (default all)
    * ``run``       [S] bool — streams whose tick ran (default all)
    """
    check_config(cfg)
    device = checked_device(device, "make_spectrum_step")
    nbins = cfg.fft_size // 2
    C, O = _channels(cfg)
    D = cfg.display_channels
    floor_gate = float(np.float32(cfg.floor - 10))
    backend = resolve_fft_backend()
    window = window_pair(cfg, device)
    w32 = None
    if backend == "xla" and cfg.window != FFTWindow.NONE:
        w32 = torch.from_numpy(window_coefficients(
            cfg.window, cfg.fft_size, cfg.sine_exponent,
            dtype=np.float32)).to(device)
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

    def step(samples: torch.Tensor, state: SpectrumState, dt: float,
             active: torch.Tensor, input_rms: torch.Tensor,
             valid: torch.Tensor | None = None,
             run: torch.Tensor | None = None) -> SpectrumState:
        samples = samples.to(torch.float32)
        if valid is None:
            valid = torch.ones(samples.shape[:2], dtype=torch.bool,
                               device=samples.device)
        g = gravity_coefficient(cfg, dt)
        g2 = float(np.float32(1.0) - np.float32(g))

        if backend == "exact":
            mag, nz_k = rfft_mag_exact(samples, window)
        else:
            x = samples if w32 is None else samples * w32
            mag = torch.fft.rfft(x).abs()[..., :nbins]
            nz_k = torch.any(samples != 0.0, dim=-1)
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

    return step
