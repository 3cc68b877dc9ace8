"""Float64 NumPy oracle of the full spectrum pipeline.

This module is the correctness ground truth for the TPU pipeline, playing the
role FFTW's arbitrary-precision reference (`libbench2/mp.c`) plays in the
reference's verification harness.  It re-states, in plain NumPy float64, the
semantics of:

* the generic spectrum tick (reference src/source_generic.cpp:26-180):
  window multiply → r2c FFT → ``|z|·2/Σw`` → slope → EMA/fast-peaks → mono
  downmix or per-channel → dBFS → volume-normalization gain → roll-off;
* the render-time rebinning (reference src/source.cpp:837-918,
  1380-1423, 1512-1564 and src/filter.hpp): log/linear pixel→bin indices,
  Lanczos-4 / Catmull-Rom(t=0.5) convolution LUTs, Gaussian spatial filter
  with edge renormalization, bar band averaging, dB→pixel mapping, mirroring.

Everything is a pure function; no state, no JAX, no cleverness.  Slow is fine.

The port's own copy of ``waveform_tpu/dsp/oracle.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.config import DB_MIN, ResolvedConfig
from ..core.enums import DisplayMode, InterpMode, TSmoothingMode
from .windows import window_coefficients, window_sum

# Reference tuning constant for time-varying EMA (src/source.hpp:306).
TV_EMA_DENOM = 0.03868924705242879469662125316986


def dbfs(mag):
    """20·log10(mag), DB_MIN for non-positive input (src/source.hpp:293-299)."""
    mag = np.asarray(mag, dtype=np.float64)
    out = np.full_like(mag, DB_MIN)
    pos = mag > 0.0
    out[pos] = 20.0 * np.log10(mag[pos])
    return out


def log_interp(a: float, b: float, t):
    """a·(b/a)^t (src/math_funcs.hpp:25-29)."""
    return a * (b / a) ** np.asarray(t, dtype=np.float64)


def gravity_coefficient(tsmoothing: TSmoothingMode, gravity: float, dt: float) -> float:
    """EMA retain factor g (src/source.hpp:301-312)."""
    if tsmoothing == TSmoothingMode.NONE or gravity <= 0.0:
        return 0.0
    if tsmoothing == TSmoothingMode.TVEXPONENTIAL:
        hi = TV_EMA_DENOM * 5.0
        return math.exp(-dt / (gravity * hi))
    return gravity


def slope_modifiers(num_bins: int, slope: float) -> np.ndarray:
    """Treble-boost multipliers on linear magnitude (src/source.cpp:1283-1290).

    log10(log_interp(10, 10000, i·slope/max)) == 1 + 3·slope·i/max.
    """
    i = np.arange(num_bins, dtype=np.float64)
    maxmod = float(num_bins - 1)
    return np.log10(log_interp(10.0, 10000.0, i * slope / maxmod))


def rolloff_modifiers(fft_size: int, samples_per_sec: int, cutoff_low: int,
                      cutoff_high: int, q: float, rate: float) -> np.ndarray:
    """Band-edge dB attenuation table (src/source.cpp:898-918)."""
    sz = fft_size // 2
    coeff = samples_per_sec / float(fft_size)
    ratio = 2.0 ** q
    freq_low = cutoff_low * ratio
    freq_high = cutoff_high / ratio
    out = np.zeros(sz, dtype=np.float64)
    for i in range(1, sz):
        freq = i * coeff
        rl = freq_low / freq
        # the reference divides in float, so cutoff_high == 0 yields IEEE
        # +inf and an infinite attenuation (clamped to DB_MIN downstream,
        # source_generic.cpp:169-179) — Python float division would raise
        # ZeroDivisionError instead, so saturate explicitly.  With
        # rate == 0 the reference computes 0·inf = NaN; that NaN feeds
        # undefined vertex math, so the zero-rate guard below (a no-op
        # roll-off either way) is the one deliberate divergence.
        rh = freq / freq_high if freq_high > 0.0 else math.inf
        low_att = rate * math.log2(rl) if rl > 1.0 else 0.0
        high_att = rate * math.log2(rh) if rh > 1.0 and rate > 0.0 else 0.0
        out[i] = low_att + high_att
    return out


def spectrum_frame(samples: np.ndarray, tsmooth: np.ndarray | None,
                   cfg: ResolvedConfig, dt: float,
                   input_rms: float = 0.0):
    """One spectrum tick over ``samples [C, fft_size]`` (float64).

    Returns ``(decibels [display_channels, fft_size//2], new_tsmooth)``.
    Mirrors src/source_generic.cpp:97-179 (the non-silent path; silence gating
    lives in the runtime layer, not the math).
    """
    samples = np.asarray(samples, dtype=np.float64)
    C, N = samples.shape
    assert N == cfg.fft_size
    outsz = N // 2

    coeffs = window_coefficients(cfg.window, N, cfg.sine_exponent)
    wsum = window_sum(cfg.window, N, cfg.sine_exponent)
    mag_coeff = 2.0 / wsum

    g = gravity_coefficient(cfg.tsmoothing, cfg.gravity, dt)
    g2 = 1.0 - g

    slope_mods = slope_modifiers(outsz, cfg.slope) if cfg.slope > 0.0 else None

    mags = np.empty((C, outsz), dtype=np.float64)
    new_tsmooth = None if tsmooth is None else np.array(tsmooth, dtype=np.float64)
    for ch in range(C):
        z = np.fft.rfft(samples[ch] * coeffs)[:outsz]  # keep bins below Nyquist
        mag = np.abs(z) * mag_coeff
        if slope_mods is not None:
            mag = mag * slope_mods
        if cfg.tsmoothing != TSmoothingMode.NONE and new_tsmooth is not None:
            old = new_tsmooth[ch]
            if cfg.fast_peaks:
                old = np.maximum(mag, old)
            mag = g * old + g2 * mag
            new_tsmooth[ch] = mag
        mags[ch] = mag

    # channel fold (src/source_generic.cpp:141-159)
    if cfg.stereo:
        if C == 1:
            mags = np.vstack([mags, mags])
        db = dbfs(mags)
    elif C > 1:
        db = dbfs((mags[0] + mags[1]) * 0.5)[None, :]
    else:
        db = dbfs(mags[0])[None, :]

    # volume normalization gain, bins >= 1 (src/source_generic.cpp:161-167)
    if cfg.normalize_volume:
        comp = min(cfg.volume_target - float(dbfs(np.array([input_rms]))[0]),
                   cfg.max_gain)
        db[:, 1:] += comp

    # roll-off, bins >= 1 (src/source_generic.cpp:169-179)
    if cfg.rolloff_q > 0.0 and cfg.rolloff_rate > 0.0:
        mods = rolloff_modifiers(N, cfg.audio.samples_per_sec, cfg.cutoff_low,
                                 cfg.cutoff_high, cfg.rolloff_q, cfg.rolloff_rate)
        db[:, 1:] = np.maximum(db[:, 1:] - mods[1:], DB_MIN)

    return db, new_tsmooth


# ---------------------------------------------------------------------------
# Rebinning: pixel/bar → FFT-bin interpolation (src/source.cpp:837-896)
# ---------------------------------------------------------------------------

def interp_indices(cfg: ResolvedConfig, sz: int) -> np.ndarray:
    """Fractional FFT-bin index per output pixel/bar edge.

    Computed in FLOAT32 like the reference (init_interp uses float
    lowbin/highbin and log_interp<float>, src/source.cpp:841-863): the
    band widths downstream TRUNCATE index differences to int
    (source.cpp:866-871), so a ~1e-7-relative f64-vs-f32 drift lands
    whole-bin bar-layout changes when a difference sits within an ulp of
    an integer (measured: 9 of 3456 sampled configs flip a band width).
    Residual powf ulp differences vs a given libm build are the same
    class as the reference's own cross-platform (MSVC/glibc) variation."""
    f32 = np.float32
    maxbin = f32(cfg.fft_size // 2 - 1)
    sr = f32(cfg.audio.samples_per_sec)
    if cfg.display_mode == DisplayMode.WAVEFORM:
        lowbin, highbin = f32(0.0), f32(cfg.fft_size - 1)
    else:
        lowbin = np.clip(f32(cfg.cutoff_low) * f32(cfg.fft_size) / sr,
                         f32(1.0), maxbin)
        highbin = np.clip(f32(cfg.cutoff_high) * f32(cfg.fft_size) / sr,
                          f32(1.0), maxbin)
    i = np.arange(sz, dtype=np.float32)
    t = (i * f32(2.0) if cfg.mirror_freq_axis else i) / f32(sz - 1)
    if cfg.log_scale:
        idx = lowbin * (highbin / lowbin) ** t        # log_interp, f32
    else:
        idx = lowbin + (highbin - lowbin) * t
    return np.clip(idx, lowbin, highbin)


def band_widths(indices: np.ndarray, num_bars: int) -> np.ndarray:
    """Bins per bar band (src/source.cpp:866-871); indices has num_bars+1
    entries.  NOTE the reference truncates the float *difference*
    ((int)(idx[i+1]-idx[i])), not each index."""
    w = np.empty(num_bars, dtype=np.int64)
    for i in range(num_bars):
        w[i] = max(int(indices[i + 1] - indices[i]), 1)
    return w


def expand_bar_samples(indices: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Per-bin sample positions for bar interp (src/source.cpp:876-889)."""
    out = []
    for i in range(len(widths)):
        for j in range(int(widths[i])):
            out.append(indices[i] + j)
    return np.asarray(out, dtype=np.float64)


def _sinc(x):
    return np.sinc(x)  # np.sinc is sin(pi x)/(pi x)


def lanczos_weights(x: float, radius: int = 4):
    """Taps and weights for one fractional index (src/filter.hpp:107-131).

    Taps run j = floor(x)-radius+1 .. floor(x)+radius; weight lanczos(x-j, r).
    """
    ix = int(x)  # reference truncates (domain is non-negative)
    taps = np.arange(ix - radius + 1, ix + radius + 1, dtype=np.int64)
    d = x - taps
    w = np.where(np.abs(d) < radius, _sinc(d) * _sinc(d / radius), 0.0)
    return taps, w


def catrom_weights(x: float, t: float = 0.5):
    """4-tap Catmull-Rom weights for one fractional index (src/filter.hpp:68-103)."""
    matrix = np.array([
        [0.0, -t, 2 * t, -t],
        [1.0, 0.0, t - 3, 2 - t],
        [0.0, t, 3 - 2 * t, t - 2],
        [0.0, 0.0, -t, t],
    ], dtype=np.float64)
    ix = int(x)
    u = x - math.floor(x)
    row = np.array([1.0, u, u * u, u * u * u])
    w = matrix @ row
    # kernel_convolve with radius=2: taps j = floor(x)-1 .. floor(x)+2
    taps = np.arange(ix - 1, ix + 3, dtype=np.int64)
    return taps, w


def kernel_convolve(samples: np.ndarray, taps: np.ndarray, w: np.ndarray) -> float:
    """Zero-padded convolution: out-of-range taps dropped (src/filter.hpp:161-169)."""
    sz = len(samples)
    valid = (taps >= 0) & (taps < sz)
    return float(np.sum(samples[taps[valid]] * w[valid]))


def apply_interp_curve(values: np.ndarray, indices: np.ndarray,
                       mode: InterpMode) -> np.ndarray:
    """Curve-mode rebin of ``values [nbins]`` onto ``indices [width]``."""
    out = np.empty(len(indices), dtype=np.float64)
    for i, x in enumerate(indices):
        if mode == InterpMode.POINT:
            out[i] = values[int(x)]
        elif mode == InterpMode.LANCZOS:
            taps, w = lanczos_weights(float(x), 4)
            out[i] = kernel_convolve(values, taps, w)
        else:
            taps, w = catrom_weights(float(x))
            out[i] = kernel_convolve(values, taps, w)
    return out


def apply_interp_bars(values: np.ndarray, indices: np.ndarray,
                      widths: np.ndarray, mode: InterpMode) -> np.ndarray:
    """Bar-mode rebin: average of interpolated samples per band
    (src/filter.hpp:195-211; point mode src/source.cpp:1525-1532)."""
    num_bars = len(widths)
    out = np.empty(num_bars, dtype=np.float64)
    if mode == InterpMode.POINT:
        for i in range(num_bars):
            base = int(indices[i])
            cnt = int(widths[i])
            out[i] = np.mean([values[base + j] for j in range(cnt)])
        return out
    expanded = expand_bar_samples(indices, widths)
    per_sample = apply_interp_curve(values, expanded, mode)
    k = 0
    for i in range(num_bars):
        cnt = int(widths[i])
        out[i] = per_sample[k:k + cnt].mean()
        k += cnt
    return out


# ---------------------------------------------------------------------------
# Gaussian spatial filter (src/filter.hpp:40-65, 133-158)
# ---------------------------------------------------------------------------

def gauss_kernel(sigma: float):
    sigma = max(abs(sigma), 0.01)
    w = int(math.ceil(3.0 * sigma))
    offsets = np.arange(-w + 1, w, dtype=np.float64)
    weights = (1.0 / (math.sqrt(2.0 * math.pi) * sigma)) * np.exp(
        -(offsets * offsets) / (2.0 * sigma * sigma))
    return offsets.astype(np.int64), weights


def apply_gauss(values: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian smoothing with edge renormalization (weighted_avg semantics)."""
    offsets, weights = gauss_kernel(sigma)
    n = len(values)
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        taps = i + offsets
        valid = (taps >= 0) & (taps < n)
        # NOTE reference interior loop covers the full 2w-1 kernel; edges
        # renormalize by the partial weight sum (src/filter.hpp:139-157).
        wsum = weights[valid].sum() if not valid.all() else weights.sum()
        out[i] = (values[taps[valid]] * weights[valid]).sum() / wsum
    return out


# ---------------------------------------------------------------------------
# dB → pixel mapping + mirroring (src/source.cpp:1408-1424, 1548-1564)
# ---------------------------------------------------------------------------

def pixel_map(db_values: np.ndarray, ceiling: float, floor: float,
              top: float, bottom: float) -> np.ndarray:
    """lerp(top, bottom, clamp(ceiling - db, 0, range)/range)."""
    dbrange = ceiling - floor
    t = np.clip(ceiling - db_values, 0.0, dbrange) / dbrange
    return top + (bottom - top) * t


def mirror_axis(values: np.ndarray) -> np.ndarray:
    """In-place-style frequency-axis mirroring (src/source.cpp:1419-1424)."""
    out = np.array(values, dtype=np.float64)
    n = len(out)
    half = n // 2
    for i in range(half + 1, n):
        out[i] = out[half - (i - half)]
    return out
