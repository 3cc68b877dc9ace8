"""Float64 reference of one served spectrum look, tick by tick.

A frozen restatement of the phandasm/waveform v1.9.1 spectrum tick
(src/source_generic.cpp:26-180) and curve rebin (src/source.cpp:837-896,
src/filter.hpp), taken over from the float64 oracle and window tables
that the program carries (``dsp/oracle.py``, ``dsp/windows.py``) and
rewritten to take plain parameters: the OBS settings dict of a
configuration file and the audio a traffic generator fed.

What it models: every stream is shown and fed without a gap longer than
the capture timeout from its first packet on, and no window it reads is
all zeros, so the silence latch and the timeout decay never fire after
a stream's first packet.  Before that packet a stream is timed out, which
zeroes its smoothing state: the reference starts each stream's smoothing
from zero at that tick.  A setting outside what is modelled raises.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

DB_MIN = 20.0 * math.log10(1.1754943508222875e-38)   # 20·log10(FLT_MIN)
TV_EMA_DENOM = 0.03868924705242879469662125316986    # src/source.hpp:306


@dataclass(frozen=True)
class Look:
    """The settings one spectrum look is computed from."""

    fft_size: int
    window: str
    sine_exponent: int
    smoothing: str
    gravity: float
    fast_peaks: bool
    slope: float
    rolloff_q: float
    rolloff_rate: float
    cutoff_low: int
    cutoff_high: int
    stereo: bool
    channels: int            # captured channels, 1 or 2
    width: int
    log_scale: bool
    mirror: bool
    interp: str
    gauss_radius: float | None
    sample_rate: int
    fps: float

    @property
    def nbins(self) -> int:
        return self.fft_size // 2

    @property
    def display_channels(self) -> int:
        return 2 if self.stereo else 1


def look_from_settings(settings: dict, audio: dict, fps: float) -> Look:
    """A :class:`Look` from an OBS settings dict, refusing what the
    reference does not model rather than guessing at it."""
    s = settings
    refuse = []
    if s["display_mode"] != "curve":
        refuse.append(f"display_mode {s['display_mode']}")
    if s["normalize_volume"]:
        refuse.append("normalize_volume")
    if s["auto_fft_size"]:
        refuse.append("auto_fft_size")
    if s["channel_mode"] not in ("mono", "stereo"):
        refuse.append(f"channel_mode {s['channel_mode']}")
    n = int(s["fft_size"])
    top = 65536 if s["enable_large_fft"] else 8192
    if n % 16 or not 128 <= n <= top:
        refuse.append(f"fft_size {n} (the resolver would change it)")
    if not 0 <= s["cutoff_low"] < s["cutoff_high"]:
        refuse.append("inverted cutoffs")
    if refuse:
        raise NotImplementedError("the reference does not model: "
                                  + ", ".join(refuse))
    return Look(
        fft_size=n, window=s["window"], sine_exponent=int(s["sine_exponent"]),
        smoothing=s["temporal_smoothing"], gravity=float(s["gravity"]),
        fast_peaks=bool(s["fast_peaks"]), slope=float(s["slope"]),
        rolloff_q=float(s["rolloff_q"]),
        rolloff_rate=float(s["rolloff_rate"]),
        cutoff_low=int(s["cutoff_low"]), cutoff_high=int(s["cutoff_high"]),
        stereo=s["channel_mode"] == "stereo",
        channels=min(int(audio["channels"]), 2), width=int(s["width"]),
        log_scale=bool(s["log_scale"]), mirror=bool(s["mirror_freq_axis"]),
        interp=s["interp_mode"],
        gauss_radius=(float(s["filter_radius"])
                      if s["filter_mode"] == "gauss" else None),
        sample_rate=int(audio["samples_per_sec"]), fps=float(fps))


# -- the tick (src/source_generic.cpp:97-179) --------------------------------

def window_coefficients(kind: str, n: int, sine_exponent: int) -> np.ndarray:
    """src/source.cpp:1190-1234: denominator n - 1, the "exact" Hamming."""
    if kind == "none":
        return np.ones(n)
    i = np.arange(n, dtype=np.float64)
    t = 2.0 * np.pi * i / (n - 1)
    if kind == "hamming":
        return 0.53836 - 0.46164 * np.cos(t)
    if kind == "blackman":
        return 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2.0 * t)
    if kind == "blackman_harris":
        return (0.35875 - 0.48829 * np.cos(t) + 0.14128 * np.cos(2.0 * t)
                - 0.01168 * np.cos(3.0 * t))
    if kind == "power_of_sine":
        return np.sin(np.pi * i / (n - 1)) ** sine_exponent
    return 0.5 * (1.0 - np.cos(t))


def dbfs(mag: np.ndarray) -> np.ndarray:
    """20·log10(mag), DB_MIN where mag <= 0 (src/source.hpp:293-299)."""
    out = np.full(mag.shape, DB_MIN)
    pos = mag > 0.0
    out[pos] = 20.0 * np.log10(mag[pos])
    return out


def gravity(look: Look) -> float:
    """The smoothing's retain factor for one video frame
    (src/source.hpp:301-312)."""
    if look.smoothing == "none" or look.gravity <= 0.0:
        return 0.0
    if look.smoothing == "tv_exp_moving_avg":
        return math.exp(-(1.0 / look.fps)
                        / (look.gravity * TV_EMA_DENOM * 5.0))
    return look.gravity


def rolloff(look: Look) -> np.ndarray:
    """Band-edge attenuation in dB per bin (src/source.cpp:898-918)."""
    freq = np.arange(look.nbins) * (look.sample_rate / look.fft_size)
    ratio = 2.0 ** look.rolloff_q
    low, high = look.cutoff_low * ratio, look.cutoff_high / ratio
    out = np.zeros(look.nbins)
    with np.errstate(divide="ignore"):
        rl = low / freq[1:]
        rh = freq[1:] / high if high > 0 else np.full(look.nbins - 1, np.inf)
    out[1:] = (np.where(rl > 1.0, look.rolloff_rate * np.log2(
        np.maximum(rl, 1.0)), 0.0)
        + np.where(rh > 1.0, look.rolloff_rate * np.log2(
            np.maximum(rh, 1.0)), 0.0))
    return out


def _rfft_abs(x: np.ndarray) -> np.ndarray:
    """|rFFT| along the last axis in float64 (SciPy's, where it is
    there, which leaves the interpreter lock while it works)."""
    try:
        import scipy.fft
    except ImportError:
        return np.abs(np.fft.rfft(x, axis=-1))
    return np.abs(scipy.fft.rfft(x, axis=-1, overwrite_x=True))


def magnitudes(look: Look, frames: np.ndarray) -> np.ndarray:
    """frames [..., C, N] float64 (windowed in place) -> the normalized,
    sloped magnitudes [..., C, N/2]."""
    w = window_coefficients(look.window, look.fft_size, look.sine_exponent)
    wsum = float(look.fft_size) if look.window == "none" else float(w.sum())
    frames *= w
    mag = _rfft_abs(frames)[..., :look.nbins] * (2.0 / wsum)
    if look.slope > 0.0:
        i = np.arange(look.nbins)
        mag = mag * (1.0 + 3.0 * look.slope * i / (look.nbins - 1))
    return mag


def smooth(look: Look, mags: np.ndarray) -> np.ndarray:
    """Run the smoothing over ``mags`` [..., T, C, N/2], the magnitudes of
    T successive ticks, from a zero state; returns the last tick's state
    [..., C, N/2].  Leading zero ticks leave the state at zero."""
    g = gravity(look)
    if look.smoothing == "none":
        return mags[..., -1, :, :]
    state = np.zeros_like(mags[..., 0, :, :])
    for t in range(mags.shape[-3]):
        mag = mags[..., t, :, :]
        old = np.maximum(mag, state) if look.fast_peaks else state
        state = g * old + (1.0 - g) * mag
    return state


def decibels(look: Look, state: np.ndarray) -> np.ndarray:
    """Smoothed magnitudes [..., C, N/2] -> the display dB channels
    [..., D, N/2] (the channel fold, then the roll-off)."""
    if look.stereo:
        db = dbfs(state if state.shape[-2] == 2
                  else np.concatenate([state, state], axis=-2))
    elif state.shape[-2] == 2:
        db = dbfs((state[..., :1, :] + state[..., 1:, :]) * 0.5)
    else:
        db = dbfs(state)
    if look.rolloff_q > 0.0 and look.rolloff_rate > 0.0:
        db[..., 1:] = np.maximum(db[..., 1:] - rolloff(look)[1:], DB_MIN)
    return db


# -- the curve rebin (src/source.cpp:837-896, src/filter.hpp) ----------------

def pixel_bins(look: Look) -> np.ndarray:
    """The fractional bin each pixel reads.  The plugin computes these in
    float32 (init_interp's float lowbin/highbin and log_interp<float>),
    and so does the reference: that rounding is the plugin's, not a loss
    of the reference's precision."""
    f32 = np.float32
    maxbin = f32(look.nbins - 1)
    sr = f32(look.sample_rate)
    lo = np.clip(f32(look.cutoff_low) * f32(look.fft_size) / sr,
                 f32(1.0), maxbin)
    hi = np.clip(f32(look.cutoff_high) * f32(look.fft_size) / sr,
                 f32(1.0), maxbin)
    i = np.arange(look.width, dtype=np.float32)
    t = (i * f32(2.0) if look.mirror else i) / f32(look.width - 1)
    idx = lo * (hi / lo) ** t if look.log_scale else lo + (hi - lo) * t
    return np.clip(idx, lo, hi).astype(np.float64)


def rebin_matrix(look: Look) -> np.ndarray:
    """The interpolation as a [N/2, width] float64 matrix: taps outside
    the bins dropped (kernel_convolve's zero padding)."""
    x = pixel_bins(look)
    ix = np.floor(x).astype(np.int64)
    if look.interp == "lanczos":
        taps = ix[:, None] + np.arange(-3, 5)
        d = x[:, None] - taps
        w = np.where(np.abs(d) < 4, np.sinc(d) * np.sinc(d / 4.0), 0.0)
    elif look.interp == "catmull_rom":
        t = 0.5
        basis = np.array([[0.0, -t, 2 * t, -t],
                          [1.0, 0.0, t - 3, 2 - t],
                          [0.0, t, 3 - 2 * t, t - 2],
                          [0.0, 0.0, -t, t]])
        u = x - ix
        w = np.stack([np.ones_like(u), u, u * u, u ** 3], -1) @ basis.T
        taps = ix[:, None] + np.arange(-1, 3)
    else:
        taps, w = ix[:, None], np.ones((len(x), 1))
    m = np.zeros((look.nbins, look.width))
    ok = (taps >= 0) & (taps < look.nbins)
    cols = np.broadcast_to(np.arange(look.width)[:, None], taps.shape)
    np.add.at(m, (taps[ok], cols[ok]), w[ok])
    return m


def finish_pixels(look: Look, px: np.ndarray) -> np.ndarray:
    """The Gaussian filter with edge renormalization
    (src/filter.hpp:133-158) and the mirror (src/source.cpp:1419-1424)
    over the pixel axis of ``px`` [..., width]."""
    n = px.shape[-1]
    if look.gauss_radius is not None:
        sigma = max(abs(look.gauss_radius), 0.01)
        r = int(math.ceil(3.0 * sigma))
        offs = np.arange(-r + 1, r)
        wts = np.exp(-(offs * offs) / (2.0 * sigma * sigma)) / (
            math.sqrt(2.0 * math.pi) * sigma)
        out = np.zeros_like(px)
        norm = np.zeros(n)
        for o, w in zip(offs, wts):
            lo, hi = max(0, -o), min(n, n - o)
            out[..., lo:hi] += w * px[..., lo + o:hi + o]
            norm[lo:hi] += w
        px = out / norm
    if look.mirror:
        idx = np.arange(n)
        half = n // 2
        idx[idx > half] = half - (idx[idx > half] - half)
        px = px[..., idx]
    return px


def expected_pixels(look: Look, ends_of, frames_at, first_tick: np.ndarray,
                    ticks: list[int], history: int) -> np.ndarray:
    """The pixels [len(ticks), S, D, width] that ticks ``ticks`` should
    return.

    ``ends_of(ks)`` gives, for each tick of ``ks``, every stream's count
    of samples fed by then ([len(ks), S]); ``frames_at(s, ends)`` the
    last N of stream ``s``'s fed samples at each count of ``ends``, zeros
    before its first, as float64 [len(ends), C, N]; ``first_tick[s]`` is
    the tick of stream ``s``'s first packet.  Each stream's smoothing runs
    from zero over the ``history`` ticks up to a checked tick (or from its
    first packet, where that is later): what is left out weighs
    gravity**history, 3e-8 at the plugin's 0.65 and 40 ticks."""
    S = len(first_tick)
    db = np.empty((len(ticks), S, look.display_channels, look.nbins))
    spans = [np.arange(k - history + 1, k + 1) for k in ticks]
    all_ticks = np.unique(np.concatenate(spans))
    ends = dict(zip(all_ticks.tolist(), ends_of(all_ticks)))

    def one_stream(s: int) -> None:
        if any(int(first_tick[s]) > k for k in ticks):
            raise ValueError(f"stream {s} has no packet by a checked tick")
        # each checked tick's history, its ticks before the stream's first
        # packet left at zero magnitude
        live = [[int(ends[j][s]) if j >= first_tick[s] else None
                 for j in sp.tolist()] for sp in spans]
        need = sorted({e for q in live for e in q if e is not None})
        mag = magnitudes(look, frames_at(s, need))
        if not (mag.max(axis=-1) > 0.0).all():
            raise ValueError(f"stream {s}: a silent channel window; the "
                             "reference models no silence gating")
        row = {e: i for i, e in enumerate(need)}
        seq = np.zeros((len(ticks), history, *mag.shape[1:]))
        for i, q in enumerate(live):
            for t, e in enumerate(q):
                if e is not None:
                    seq[i, t] = mag[row[e]]
        db[:, s] = decibels(look, smooth(look, seq))

    # streams are independent; NumPy and SciPy release the interpreter
    # lock inside their loops, so threads spread them over the cores
    with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as pool:
        list(pool.map(one_stream, range(S)))
    px = db.reshape(-1, look.nbins) @ rebin_matrix(look)
    return finish_pixels(look, px.reshape(*db.shape[:-1], look.width))
