"""Float64 PyTorch reference of one served spectrum look, tick by tick.

The whole tick of a phandasm/waveform v1.9.1 curve look, from the OBS
settings dict of a configuration and the audio fed: window, |rFFT|, 2/Σw,
slope, temporal smoothing with fast peaks, the stereo or mono fold, dBFS
and roll-off (src/source_generic.cpp:97-179, src/source.cpp:898-918,
1283-1290), then the curve rebin: the plugin's float32 pixel bins, the
Lanczos, Catmull-Rom or point matrix, the Gaussian filter with edge
renormalization and the mirror (src/source.cpp:837-896, 1419-1424,
src/filter.hpp).

It imports only ``torch``, ``math`` and ``numpy``, so a benchmark can hold
the program to it without loading the program, and it runs on any torch
device, a block of streams at a time, so that a card's worth of streams is
computed on the card.

Departures from the plugin, each deliberate:

* the arithmetic is float64 (the plugin's is float32: FFTW's float
  transform, float smoothing state); only the pixel bins are float32, as
  the plugin computes them.  ``dtype`` and ``product`` put the same code
  in a lower precision, for a control;
* each stream's smoothing runs from zero over the ``history`` ticks up to
  a checked tick, or from its first packet where that is later: what is
  left out weighs gravity**history of the state (fast peaks' max is
  1-Lipschitz, so it leaves out no more);
* it models streams fed without a gap longer than the capture timeout
  from their first packet on, whose windows are never all zeros: no
  silence latch and no timeout decay after the first packet (before it a
  stream is timed out, which zeroes its state, as here).  A silent channel
  window raises;
* the window with ``window`` "none" is all ones and Σw is N, as in the
  plugin; roll-off applies only where both its band and its rate are
  positive (at rate 0 the plugin computes 0·inf where the high cutoff is
  0, which feeds undefined vertex math).

A setting outside what is modelled raises NotImplementedError.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DB_MIN = 20.0 * math.log10(1.1754943508222875e-38)   # 20·log10(FLT_MIN)
TV_EMA_DENOM = 0.03868924705242879469662125316986    # src/source.hpp:306

WINDOWS = ("none", "hann", "hamming", "blackman", "blackman_harris",
           "power_of_sine")
SMOOTHING = ("none", "exp_moving_avg", "tv_exp_moving_avg")
INTERP = ("point", "lanczos", "catmull_rom")
FILTERS = ("none", "gauss")


class Look:
    """The settings one spectrum look is computed from: an OBS settings
    dict, the audio's ``samples_per_sec`` and the video frame rate (the
    channels are the audio fed's).  Refuses what the reference does not
    model rather than guessing at it."""

    def __init__(self, settings: dict, audio: dict, fps: float):
        s = settings
        refuse = []
        if s["display_mode"] != "curve":
            refuse.append(f"display_mode {s['display_mode']}")
        if s["normalize_volume"]:
            refuse.append("normalize_volume")
        if s["auto_fft_size"]:
            refuse.append("auto_fft_size")
        if s.get("audio_sync_offset", 0):
            refuse.append("audio_sync_offset")
        if s["channel_mode"] not in ("mono", "stereo"):
            refuse.append(f"channel_mode {s['channel_mode']}")
        for key, known in (("window", WINDOWS),
                           ("temporal_smoothing", SMOOTHING),
                           ("interp_mode", INTERP),
                           ("filter_mode", FILTERS)):
            if s[key] not in known:
                refuse.append(f"{key} {s[key]}")
        n = int(s["fft_size"])
        top = 65536 if s["enable_large_fft"] else 8192
        if n % 16 or not 128 <= n <= top:
            refuse.append(f"fft_size {n} (the resolver would change it)")
        if not 0 <= s["cutoff_low"] < s["cutoff_high"]:
            refuse.append("inverted cutoffs")
        if refuse:
            raise NotImplementedError("the reference does not model: "
                                      + ", ".join(refuse))
        self.fft_size = n
        self.window = s["window"]
        self.sine_exponent = int(s["sine_exponent"])
        self.smoothing = s["temporal_smoothing"]
        self.gravity = float(s["gravity"])
        self.fast_peaks = bool(s["fast_peaks"])
        self.slope = float(s["slope"])
        self.rolloff_q = float(s["rolloff_q"])
        self.rolloff_rate = float(s["rolloff_rate"])
        self.cutoff_low = int(s["cutoff_low"])
        self.cutoff_high = int(s["cutoff_high"])
        self.stereo = s["channel_mode"] == "stereo"
        self.width = int(s["width"])
        self.log_scale = bool(s["log_scale"])
        self.mirror = bool(s["mirror_freq_axis"])
        self.interp = s["interp_mode"]
        self.gauss_radius = (float(s["filter_radius"])
                             if s["filter_mode"] == "gauss" else None)
        self.sample_rate = int(audio["samples_per_sec"])
        self.fps = float(fps)

    @property
    def nbins(self) -> int:
        return self.fft_size // 2

    @property
    def display_channels(self) -> int:
        return 2 if self.stereo else 1


# -- the tick's tables (float64) ---------------------------------------------

def window_coefficients(look: Look) -> np.ndarray:
    """src/source.cpp:1190-1234: denominator n - 1, the "exact" Hamming."""
    n = look.fft_size
    if look.window == "none":
        return np.ones(n)
    i = np.arange(n, dtype=np.float64)
    t = 2.0 * np.pi * i / (n - 1)
    if look.window == "hamming":
        return 0.53836 - 0.46164 * np.cos(t)
    if look.window == "blackman":
        return 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2.0 * t)
    if look.window == "blackman_harris":
        return (0.35875 - 0.48829 * np.cos(t) + 0.14128 * np.cos(2.0 * t)
                - 0.01168 * np.cos(3.0 * t))
    if look.window == "power_of_sine":
        return np.sin(np.pi * i / (n - 1)) ** look.sine_exponent
    return 0.5 * (1.0 - np.cos(t))


def gravity(look: Look) -> float:
    """The smoothing's retain factor for one video frame
    (src/source.hpp:301-312)."""
    if look.smoothing == "none" or look.gravity <= 0.0:
        return 0.0
    if look.smoothing == "tv_exp_moving_avg":
        return math.exp(-(1.0 / look.fps)
                        / (look.gravity * TV_EMA_DENOM * 5.0))
    return look.gravity


def slope(look: Look) -> np.ndarray:
    """The treble boost on linear magnitude, log10 of log_interp(10,
    10000, i·slope/max) = 1 + 3·slope·i/max (src/source.cpp:1283-1290)."""
    i = np.arange(look.nbins, dtype=np.float64)
    return 1.0 + 3.0 * look.slope * i / (look.nbins - 1)


def rolloff(look: Look) -> np.ndarray:
    """Band-edge attenuation in dB per bin, 0 at bin 0
    (src/source.cpp:898-918)."""
    freq = np.arange(1, look.nbins) * (look.sample_rate / look.fft_size)
    ratio = 2.0 ** look.rolloff_q
    low, high = look.cutoff_low * ratio, look.cutoff_high / ratio
    rl = low / freq
    rh = freq / high
    out = np.zeros(look.nbins)
    out[1:] = (look.rolloff_rate * np.log2(np.maximum(rl, 1.0))
               + look.rolloff_rate * np.log2(np.maximum(rh, 1.0)))
    return out


def pixel_bins(look: Look) -> np.ndarray:
    """The fractional bin each pixel reads.  The plugin computes these in
    float32 (init_interp's float lowbin/highbin and log_interp<float>), and
    so does the reference, in NumPy's float32 as the benchmark's NumPy
    reference does: that rounding is the plugin's, not a loss of the
    reference's precision."""
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
    """The interpolation as a [N/2, width] float64 matrix: Lanczos over
    8 taps (radius 4), Catmull-Rom over 4 (tension 0.5), or the point;
    taps outside the bins dropped (kernel_convolve's zero padding)."""
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


# -- the tick ----------------------------------------------------------------

def dbfs(mag: torch.Tensor) -> torch.Tensor:
    """20·log10(mag), DB_MIN where mag <= 0 (src/source.hpp:293-299)."""
    pos = mag > 0.0
    db = 20.0 * torch.log10(torch.where(pos, mag, torch.ones_like(mag)))
    return torch.where(pos, db, torch.full_like(mag, DB_MIN))


def decibels(look: Look, state: torch.Tensor,
             roll: torch.Tensor | None) -> torch.Tensor:
    """Smoothed magnitudes [..., C, N/2] -> the display dB channels
    [..., D, N/2]: the channel fold (src/source_generic.cpp:141-159), then
    the roll-off on bins >= 1 (:169-179)."""
    if look.stereo:
        db = dbfs(state if state.shape[-2] == 2
                  else torch.cat([state, state], dim=-2))
    elif state.shape[-2] == 2:
        db = dbfs((state[..., :1, :] + state[..., 1:, :]) * 0.5)
    else:
        db = dbfs(state)
    if roll is not None:
        db[..., 1:] = torch.clamp(db[..., 1:] - roll[1:], min=DB_MIN)
    return db


def finish_pixels(look: Look, px: torch.Tensor) -> torch.Tensor:
    """The Gaussian filter with edge renormalization
    (src/filter.hpp:133-158) and the mirror (src/source.cpp:1419-1424)
    over the pixel axis of ``px`` [..., width]."""
    n = px.shape[-1]
    if look.gauss_radius is not None:
        sigma = max(abs(look.gauss_radius), 0.01)
        r = int(math.ceil(3.0 * sigma))
        out = torch.zeros_like(px)
        norm = torch.zeros(n, dtype=px.dtype, device=px.device)
        for o in range(-r + 1, r):
            w = math.exp(-(o * o) / (2.0 * sigma * sigma)) / (
                math.sqrt(2.0 * math.pi) * sigma)
            lo, hi = max(0, -o), min(n, n - o)
            out[..., lo:hi] += w * px[..., lo + o:hi + o]
            norm[lo:hi] += w
        px = out / norm
    if look.mirror:
        idx = np.arange(n)
        half = n // 2
        idx[idx > half] = half - (idx[idx > half] - half)
        px = px[..., torch.from_numpy(idx).to(px.device)]
    return px


def expected_pixels(look: Look, ends_of, frames_at, first_tick, ticks,
                    history: int, *, device="cpu", dtype=torch.float64,
                    product=None, block: int = 16) -> np.ndarray:
    """The pixels [len(ticks), S, D, width] (float64 NumPy, dBFS) that
    ticks ``ticks`` should return.

    ``ends_of(ks)`` gives, for each tick of ``ks``, every stream's count
    of samples fed by then ([len(ks), S]); ``frames_at(s, ends)`` the last
    N of stream ``s``'s fed samples at each count of ``ends``, zeros
    before its first, as [len(ends), C, N]; ``first_tick[s]`` is the tick
    of stream ``s``'s first packet.  ``block`` streams are computed at a
    time on ``device``, in ``dtype``; ``product(db [R, N/2], matrix [N/2,
    width])`` is the rebin's product (``torch.matmul`` by default)."""
    device = torch.device(device)
    product = torch.matmul if product is None else product

    def table(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=device)

    w = window_coefficients(look)
    wsum = float(look.fft_size) if look.window == "none" else float(w.sum())
    w = table(w)
    coeff = table(2.0 / wsum)
    gain = table(slope(look)) if look.slope > 0.0 else None
    roll = (table(rolloff(look))
            if look.rolloff_q > 0.0 and look.rolloff_rate > 0.0 else None)
    mat = table(rebin_matrix(look))
    g = gravity(look)
    S, T, H = len(first_tick), len(ticks), history
    spans = [np.arange(k - H + 1, k + 1) for k in ticks]
    all_ticks = np.unique(np.concatenate(spans))
    ends = dict(zip(all_ticks.tolist(), ends_of(all_ticks)))
    db = torch.empty((T, S, look.display_channels, look.nbins), dtype=dtype,
                     device=device)
    for s0 in range(0, S, block):
        streams = range(s0, min(S, s0 + block))
        frames, rows = [], []      # rows[b][i][t]: the frame of history t
        n = 0
        for s in streams:
            if any(int(first_tick[s]) > k for k in ticks):
                raise ValueError(f"stream {s} has no packet by a checked "
                                 "tick")
            # each checked tick's history; its ticks before the stream's
            # first packet read no frame (zero magnitude)
            live = [[int(ends[j][s]) if j >= first_tick[s] else None
                     for j in sp.tolist()] for sp in spans]
            need = sorted({e for q in live for e in q if e is not None})
            at = {e: n + i for i, e in enumerate(need)}
            frames.append(np.asarray(frames_at(s, need)))
            rows.append([[at.get(e, -1) for e in q] for q in live])
            n += len(need)
        x = torch.as_tensor(np.concatenate(frames), device=device).to(dtype)
        mag = torch.fft.rfft(x * w).abs()[..., :look.nbins] * coeff
        del x
        if gain is not None:
            mag = mag * gain
        if not bool((mag.amax(-1) > 0.0).all()):
            raise ValueError(f"streams {streams}: a silent channel window; "
                             "the reference models no silence gating")
        # row n (the appended zeros) stands for a tick without a frame
        mag = torch.cat([mag, torch.zeros_like(mag[:1])])
        idx = torch.tensor(rows, device=device)
        idx = torch.where(idx < 0, torch.full_like(idx, n), idx)
        if look.smoothing == "none":
            state = mag[idx[..., -1]]
        else:
            state = torch.zeros_like(mag[idx[..., 0]])
            for t in range(H):
                m = mag[idx[..., t]]
                old = torch.maximum(m, state) if look.fast_peaks else state
                state = g * old + (1.0 - g) * m
        db[:, s0:s0 + len(streams)] = decibels(look, state,
                                               roll).transpose(0, 1)
    px = product(db.reshape(-1, look.nbins), mat)
    px = finish_pixels(look, px.reshape(T, S, look.display_channels,
                                        look.width))
    return px.to(torch.float64).cpu().numpy()
