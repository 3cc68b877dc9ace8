"""Spectrum step of the PyTorch port against the JAX step.

Both steps take the same windows (made with numpy from a seed) and the
same per-tick masks for about six ticks, from the same start state; each
package resolves the same settings with its own ``resolve``.  The
JAX step runs the exact backend with its Pallas kernel in interpret mode.
Decibels must agree within 1e-4 dB wherever the reference is above -120,
and exactly where it is DB_MIN; the silence latch must agree exactly.

The windows are noise-dominated, like the input of the bench's accuracy
gate (waveform_tpu/bench.py:253-275): every visible bin then lies within
~60 dB of its row's peak.  Both exact paths round at ~1e-8 of the peak, in
different places (XLA on the CPU also contracts the df32 products into
FMAs), so a bin 80 dB under a loud tone may differ by a few 1e-4 dB while
each side stays within the kernel's 2.5e-7 |rFFT| bound.
"""

import enum

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu import (
    DB_MIN,
    AudioInfo,
    ChannelMode,
    FFTWindow,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu.dsp import spectrum as jspec
import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp import spectrum as tspec

N, S, TICKS = 1024, 4, 6


@pytest.fixture
def kernel_on(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")


def _cfg(channels=2, **kw):
    """The same settings resolved by the JAX package and by the port (enum
    members passed by name): ``(jax_cfg, port_cfg)``."""
    port_kw = {k: (getattr(wt, type(v).__name__)[v.name]
                   if isinstance(v, enum.Enum) else v) for k, v in kw.items()}
    return (resolve(Settings(fft_size=N, **kw), AudioInfo(48000, channels)),
            wt.resolve(wt.Settings(fft_size=N, **port_kw),
                       wt.AudioInfo(48000, channels)))


def _windows(rng, cfg, tick, silent=()):
    """[S, C, N] frames: noise plus a quieter per-stream tone; ``silent``
    lists (stream, channel) pairs held at zero (channel None: whole
    stream)."""
    C = max(cfg.capture_channels, 1)
    t = (np.arange(N) + tick * 800) / 48000.0
    x = 0.3 * rng.standard_normal((S, C, N))
    for s in range(S):
        x[s] += 0.05 * (1 + s) * np.sin(2 * np.pi * (300.0 + 700.0 * s) * t)
    for s, c in silent:
        x[s, slice(None) if c is None else c] = 0.0
    return x.astype(np.float32)


def _assert_db_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])


def _run(cfgs, frames, active=None, rms=None, valid=None, run=None,
         start=None, dt=1 / 60):
    """Drive both steps over ``frames`` (``cfgs`` from :func:`_cfg`);
    per-tick masks are lists of [S] (or [S, C]) numpy arrays or None.
    Returns the final (jax, port) states after asserting agreement every
    tick."""
    jcfg, tcfg = cfgs
    jstep = jspec.make_spectrum_step(jcfg, fft_backend="exact")
    tstep = tspec.make_spectrum_step(tcfg, device="cpu")
    if start is None:
        jst = jspec.init_state(jcfg, S)
        tst = tspec.init_state(tcfg, S, device="cpu")
    else:
        jst = jspec.SpectrumState(*(jnp.asarray(a) for a in start))
        tst = tspec.state_from_numpy(*start, device="cpu")
    for k, x in enumerate(frames):
        act = np.ones(S, bool) if active is None else active[k]
        r = np.zeros(S, np.float32) if rms is None else rms[k]
        kw_j, kw_t = {}, {}
        if valid is not None:
            kw_j["valid"] = jnp.asarray(valid[k])
            kw_t["valid"] = torch.from_numpy(valid[k])
        if run is not None:
            kw_j["run"] = jnp.asarray(run[k])
            kw_t["run"] = torch.from_numpy(run[k])
        jst = jstep(jnp.asarray(x), jst, jnp.float32(dt), jnp.asarray(act),
                    jnp.asarray(r), **kw_j)
        tst = tstep(torch.from_numpy(x), tst, dt, torch.from_numpy(act),
                    torch.from_numpy(r), **kw_t)
        _assert_db_close(tst.decibels.numpy(), jst.decibels)
        np.testing.assert_array_equal(tst.last_silent.numpy(),
                                      np.asarray(jst.last_silent))
        want_ts = np.asarray(jst.tsmooth)
        np.testing.assert_allclose(tst.tsmooth.numpy(), want_ts, rtol=0,
                                   atol=1e-6 * max(np.abs(want_ts).max(), 1))
    return jst, tst


@pytest.mark.parametrize("kw", [
    dict(channel_mode=ChannelMode.STEREO),
    dict(),                                              # mono downmix, C=2
    dict(channel_mode=ChannelMode.STEREO, window=FFTWindow.BLACKMAN,
         fast_peaks=True),
    dict(temporal_smoothing=TSmoothingMode.TVEXPONENTIAL, gravity=0.8),
    dict(temporal_smoothing=TSmoothingMode.NONE, window=FFTWindow.NONE),
    dict(slope=1.5, rolloff_q=1.0, rolloff_rate=12.0, cutoff_low=200,
         cutoff_high=9000),
], ids=["stereo", "mono_downmix", "stereo_fastpeaks", "tvexp", "nosmooth",
        "rolloff_slope"])
def test_step_matches_jax(kw, kernel_on):
    rng = np.random.default_rng(len(str(kw)))
    cfgs = _cfg(**kw)
    _run(cfgs, [_windows(rng, cfgs[0], k, silent=[(1, 1)])
                for k in range(TICKS)])


def test_mono_capture(kernel_on):
    """One capture channel (C=1, duplicated to stereo output)."""
    rng = np.random.default_rng(3)
    cfgs = _cfg(channels=1, channel_mode=ChannelMode.STEREO)
    _run(cfgs, [_windows(rng, cfgs[0], k) for k in range(TICKS)])


@pytest.mark.parametrize("stereo", [False, True])
def test_silence_latch_set_and_released(stereo, kernel_on):
    """Stream 2 starts silent (latches at once: the fresh dB buffer sits
    at DB_MIN), then sound releases it; stream 3 goes silent on one channel
    only, and in mono downmix the later silent channel reads the fresh
    linear magnitudes of channel 0 (the mixed-domain quirk)."""
    rng = np.random.default_rng(4 + stereo)
    cfgs = _cfg(channel_mode=(ChannelMode.STEREO if stereo
                              else ChannelMode.MONO))
    frames = [_windows(rng, cfgs[0], k,
                       silent=([(2, None)] if k < 3 else [])
                       + ([(3, 1)] if k >= 2 else []))
              for k in range(TICKS)]
    jst, tst = _run(cfgs, frames)
    assert not tst.last_silent.numpy()[2]


def test_timeout_and_hidden(kernel_on):
    """Stream 1 times out for two ticks mid-run; stream 3 is hidden from
    the start (cleared to DB_MIN, latched); stream 0 never runs on tick 4;
    one channel lacks data on tick 2."""
    rng = np.random.default_rng(6)
    cfgs = _cfg(channel_mode=ChannelMode.STEREO)
    active, run, valid = [], [], []
    for k in range(TICKS):
        a = np.ones(S, bool)
        a[3] = False
        if k in (2, 3):
            a[1] = False
        active.append(a)
        r = np.ones(S, bool)
        r[0] = k != 4
        run.append(r)
        v = np.ones((S, 2), bool)
        if k == 2:
            v[2, 0] = False
        valid.append(v)
    frames = [_windows(rng, cfgs[0], k) for k in range(TICKS)]
    _run(cfgs, frames, active=active, run=run, valid=valid)


def test_volume_normalization(kernel_on):
    rng = np.random.default_rng(8)
    cfgs = _cfg(normalize_volume=True, volume_target=-12, max_gain=20)
    rms = [rng.uniform(0.0, 0.5, S).astype(np.float32) for _ in range(TICKS)]
    for r in rms:
        r[0] = 0.0                   # silent input: the gain caps at max_gain
    _run(cfgs, [_windows(rng, cfgs[0], k) for k in range(TICKS)], rms=rms)


def test_start_from_shared_mid_stream_state(kernel_on):
    """Both steps resume one mid-stream state handed over as natural-order
    numpy arrays: a latched-silent stream stays frozen while silent, the
    others carry their EMA trails on."""
    rng = np.random.default_rng(9)
    cfgs = _cfg(channel_mode=ChannelMode.STEREO)
    nb = N // 2
    tsmooth = rng.uniform(0.0, 0.05, (S, 2, nb)).astype(np.float32)
    db = rng.uniform(-110.0, -10.0, (S, 2, nb)).astype(np.float32)
    latched = np.zeros(S, bool)
    latched[1] = True
    db[1] = rng.uniform(-100.0, -80.0, (2, nb))
    start = (tsmooth, db, latched)
    frames = [_windows(rng, cfgs[0], k, silent=[(1, None)])
              for k in range(TICKS)]
    jst, tst = _run(cfgs, frames, start=start)
    got = tspec.state_to_numpy(tst)
    np.testing.assert_array_equal(got[1][1], db[1])     # frozen verbatim
    assert got[2][1]


def test_dbfs_matches_jax():
    rng = np.random.default_rng(10)
    mag = np.concatenate([
        10.0 ** rng.uniform(-37, 6, 4000), [0.0, -1.0, 1.0, 2.0 ** -126,
                                            3.4e38]]).astype(np.float32)
    got = tspec.dbfs(torch.from_numpy(mag)).numpy()
    want = np.asarray(jspec.dbfs(jnp.asarray(mag)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-5)
    ref = 20.0 * np.log10(mag[mag > 0].astype(np.float64))
    np.testing.assert_allclose(got[mag > 0], ref, rtol=2e-7, atol=1e-5)
    assert (got[mag <= 0] == np.float32(DB_MIN)).all()
