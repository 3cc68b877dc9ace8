"""Log-frequency rebinning tables: pixel/bar → FFT-bin interpolation LUTs.

The reference computes, per output pixel, a fractional FFT-bin index
(reference src/source.cpp:837-896) and then convolves 8-tap Lanczos-4 or
4-tap Catmull-Rom weight LUTs over the dB bins at render time
(reference src/filter.hpp:107-131, 161-211; AVX form in
src/filter_fma3.cpp).  Per-pixel tap gathers are a sparse matrix in disguise;
here we materialize them as static ``(taps [W,T] int32, weights [W,T] f32)``
pairs that the TPU pipeline applies as one batched gather+reduce — the
TPU-idiomatic form of ``apply_interp_filter_fma3``.

All tables are computed on the host in float64 and baked into the jitted
function as constants, exactly as the reference precomputes them in
``update()``.

The port's own copy of ``waveform_tpu/rebin/interp.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.config import ResolvedConfig
from ..core.enums import DisplayMode, InterpMode
from ..dsp.oracle import band_widths as _band_widths
from ..dsp.oracle import expand_bar_samples, interp_indices

LANCZOS_RADIUS = 4  # reference: src/source.cpp:892


@dataclass(frozen=True)
class InterpTables:
    """Static gather tables for one rebin configuration."""

    taps: np.ndarray      # [P, T] int32, clamped to [0, nbins)
    weights: np.ndarray   # [P, T] float; 0 where the tap was out of range
    # bar banding (empty for curve mode)
    band_matrix: np.ndarray | None  # [num_bars, P] float averaging matrix
    num_outputs: int


def _lanczos_lut(indices: np.ndarray, radius: int = LANCZOS_RADIUS):
    """Taps j = floor(x)-r+1 .. floor(x)+r, weight sinc(d)·sinc(d/r)."""
    ix = indices.astype(np.int64)  # truncation; domain is non-negative
    offs = np.arange(-radius + 1, radius + 1, dtype=np.int64)
    taps = ix[:, None] + offs[None, :]
    d = indices[:, None] - taps
    w = np.where(np.abs(d) < radius, np.sinc(d) * np.sinc(d / radius), 0.0)
    return taps, w


def _catrom_lut(indices: np.ndarray, t: float = 0.5):
    """4-tap Catmull-Rom basis weights at u = frac(x)."""
    matrix = np.array([
        [0.0, -t, 2 * t, -t],
        [1.0, 0.0, t - 3, 2 - t],
        [0.0, t, 3 - 2 * t, t - 2],
        [0.0, 0.0, -t, t],
    ], dtype=np.float64)
    ix = indices.astype(np.int64)
    u = indices - np.floor(indices)
    rows = np.stack([np.ones_like(u), u, u * u, u ** 3], axis=-1)  # [P,4]
    w = rows @ matrix.T  # [P,4]
    taps = ix[:, None] + np.arange(-1, 3, dtype=np.int64)[None, :]
    return taps, w


def _point_lut(indices: np.ndarray):
    taps = indices.astype(np.int64)[:, None]
    return taps, np.ones_like(taps, dtype=np.float64)


def _mask_and_clamp(taps: np.ndarray, weights: np.ndarray, nbins: int):
    """Zero-pad semantics of kernel_convolve: drop out-of-range taps."""
    valid = (taps >= 0) & (taps < nbins)
    return (np.clip(taps, 0, nbins - 1).astype(np.int32),
            np.where(valid, weights, 0.0))


def build_interp_tables(cfg: ResolvedConfig, dtype=np.float32) -> InterpTables:
    """Build the full rebin LUT for the resolved config.

    Curve/waveform: P = width pixels, direct per-pixel interpolation.
    Bars: per-band expanded samples (src/source.cpp:876-889) averaged by a
    [num_bars, P] matrix (src/filter.hpp:196-211); point mode averages raw
    bins per band (src/source.cpp:1525-1532).
    """
    nbins = (cfg.fft_size if cfg.display_mode == DisplayMode.WAVEFORM
             else cfg.fft_size // 2)
    curve_like = cfg.display_mode in (DisplayMode.CURVE, DisplayMode.WAVEFORM)

    if curve_like:
        indices = interp_indices(cfg, cfg.width)
        per_sample_indices = indices
        band_matrix = None
        num_outputs = cfg.width
    else:
        edges = interp_indices(cfg, cfg.num_bars + 1)
        widths = _band_widths(edges, cfg.num_bars)
        if cfg.interp_mode == InterpMode.POINT:
            # point-mode bars average raw bins at (size_t)edge + j
            # (src/source.cpp:1525-1532): truncated start index per band
            per_sample_indices = np.concatenate([
                int(edges[i]) + np.arange(int(widths[i]), dtype=np.float64)
                for i in range(cfg.num_bars)
            ])
        else:
            per_sample_indices = expand_bar_samples(edges, widths)
        band_matrix = np.zeros((cfg.num_bars, len(per_sample_indices)))
        k = 0
        for i in range(cfg.num_bars):
            cnt = int(widths[i])
            band_matrix[i, k:k + cnt] = 1.0 / cnt
            k += cnt
        num_outputs = cfg.num_bars

    if cfg.interp_mode == InterpMode.LANCZOS:
        taps, w = _lanczos_lut(per_sample_indices)
    elif cfg.interp_mode == InterpMode.CATROM:
        taps, w = _catrom_lut(per_sample_indices)
    else:
        taps, w = _point_lut(per_sample_indices)

    taps, w = _mask_and_clamp(taps, w, nbins)
    return InterpTables(
        taps=taps,
        weights=w.astype(dtype),
        band_matrix=None if band_matrix is None else band_matrix.astype(dtype),
        num_outputs=num_outputs,
    )


def mirror_indices(n: int) -> np.ndarray:
    """Output index permutation for frequency-axis mirroring
    (src/source.cpp:1419-1424): i>half reads from half-(i-half)."""
    idx = np.arange(n)
    half = n // 2
    tail = idx > half
    idx[tail] = half - (idx[tail] - half)
    return idx.astype(np.int32)
