"""The port's host copies against the JAX package's: ``StreamSource``,
``WaveformScroller``, ``BatchedWaveformScroller`` and ``ts_to_frames``.

Both sides are numpy, so every output must be EQUAL: the same seeded
packets and clock go into a port object and a JAX object built from the
same settings (each package resolving them with its own ``resolve``), and
every tick's frames, windows, displays, latches and sync state are
compared bit for bit.  The schedules cover mute, a 50 ms sync lag, a
capture timeout, the capture retry loop and volume normalization.
"""

import numpy as np
import pytest

from test_torch_serving import _jax_cfg
from waveform_tpu.runtime.source import StreamSource as JaxSource
from waveform_tpu.runtime.waveform_host import (
    BatchedWaveformScroller as JaxBatched,
)
from waveform_tpu.runtime.waveform_host import WaveformScroller as JaxScroller
from waveform_tpu.runtime.waveform_host import ts_to_frames as jax_ts_to_frames
from waveform_tpu_torch import (
    AudioInfo,
    ChannelMode,
    DisplayMode,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.runtime.source import StreamSource
from waveform_tpu_torch.runtime.waveform_host import (
    BatchedWaveformScroller,
    WaveformScroller,
    ts_to_frames,
)

SR, T0, STEP = 48000, 10_000_000_000, 10_000_000   # a tick every 10 ms
LAG = 50_000_000


def _wf_cfg(channels=2, **kw):
    return resolve(Settings(display_mode=DisplayMode.WAVEFORM,
                            temporal_smoothing=TSmoothingMode.NONE,
                            width=160, meter_buf=100, **kw),
                   AudioInfo(SR, channels))


def _sync_state(src):
    return (src.capture_ts, src.audio_ts, src.tick_ts, src.waveform_ts,
            src.capture_attached, src.retries, src.next_retry,
            src.input_rms, [r.size for r in src.rings])


def _retry_after(n):
    """An ``on_retry`` callback that re-attaches at its ``n``-th call."""
    calls = [0]

    def retry():
        calls[0] += 1
        return calls[0] >= n
    return retry


# name: (settings, capture channels, lag ns, muted ticks, silent gap
#        ticks, detach tick, the scroller's dt)
SCROLLER_CASES = {
    "plain": ({}, 2, 0, (), (), None, 1 / 60),
    "mute": ({}, 2, 0, (8, 9, 10, 11), (), None, 1 / 60),
    "lag_50ms": ({}, 2, LAG, (), (), None, 1 / 60),
    "timeout": ({}, 2, 0, (), tuple(range(12, 30)), None, 1 / 60),
    "normalize": (dict(normalize_volume=True, volume_target=-8,
                       max_gain=30), 2, 0, (5, 6), (), None, 1 / 60),
    "normalize_offset": (dict(normalize_volume=True, audio_sync_offset=30),
                         2, LAG, (), (), None, 1 / 60),
    "stereo_of_mono": (dict(channel_mode=ChannelMode.STEREO), 1, 0, (),
                       (), None, 1 / 60),
    "retry": ({}, 2, 0, (), (), 10, 0.25),
}


@pytest.mark.parametrize("case", list(SCROLLER_CASES))
def test_waveform_scroller_matches_jax(case):
    settings, channels, lag, mute, gap, detach, dt = SCROLLER_CASES[case]
    cfg = _wf_cfg(channels, **settings)
    pairs = [(StreamSource(cfg), WaveformScroller(cfg)),
             (JaxSource(_jax_cfg(cfg)), JaxScroller(_jax_cfg(cfg)))]
    rng = np.random.default_rng(len(case))
    now = T0
    latched = []
    for k in range(40):
        x = (0.3 * rng.standard_normal((channels, 480))).astype(np.float32)
        if case == "normalize" and k > 20:
            x *= 4.0                                   # a loudness step
        if k == detach:
            for src, _ in pairs:
                src.detach()
                src.on_retry = _retry_after(2)
        if k not in gap:
            for src, _ in pairs:
                src.capture_audio(x, now - lag, now, muted=k in mute)
        # the timeout case's gap holds a 600 ms jump of the clock
        now += STEP if not (case == "timeout" and k == 14) else 600_000_000
        outs = [scr.tick(src, now, dt).copy() for src, scr in pairs]
        np.testing.assert_array_equal(outs[0], outs[1], err_msg=f"tick {k}")
        assert pairs[0][1].last_silent == pairs[1][1].last_silent, k
        assert _sync_state(pairs[0][0]) == _sync_state(pairs[1][0]), k
        latched.append(pairs[0][1].last_silent)
    if case == "retry":
        assert pairs[0][0].capture_attached and pairs[0][0].retries == 2
    if case == "timeout":   # latched in the gap, live again after it
        assert latched[20] and not latched[-1]


@pytest.mark.parametrize("lag", [0, LAG])
@pytest.mark.parametrize("mode", ["spectrum", "meter"])
def test_stream_source_matches_jax(mode, lag):
    """prepare_spectrum_tick (with the volume-normalization RMS window) and
    drain_meter_samples under mute, a lagging clock and a timeout gap."""
    if mode == "spectrum":
        cfg = resolve(Settings(fft_size=1024, normalize_volume=True),
                      AudioInfo(SR, 2))
    else:
        cfg = resolve(Settings(display_mode=DisplayMode.METER, meter_buf=50),
                      AudioInfo(SR, 2))
    srcs = [StreamSource(cfg), JaxSource(_jax_cfg(cfg))]
    windows = [np.zeros((2, cfg.fft_size), np.float32) for _ in srcs]
    rng = np.random.default_rng(40 + lag % 7)
    now = T0
    for k in range(40):
        frames = 480 + 37 * (k % 3)
        x = (0.3 * rng.standard_normal((2, frames))).astype(np.float32)
        if not 20 <= k < 30:                           # a 100 ms gap
            for src in srcs:
                src.capture_audio(x, now - lag, now, muted=5 <= k < 8)
        now += STEP if k != 25 else 600_000_000        # ... then a timeout
        if mode == "spectrum":
            got = [src.prepare_spectrum_tick(now, 1 / 60) for src in srcs]
            for f in ("frame", "valid", "active", "run", "input_rms"):
                np.testing.assert_array_equal(getattr(got[0], f),
                                              getattr(got[1], f))
        else:
            got = [src.drain_meter_samples(now, 1 / 60, w)
                   for src, w in zip(srcs, windows)]
            assert got[0] == got[1], k
            np.testing.assert_array_equal(windows[0], windows[1])
            np.testing.assert_array_equal(srcs[0].meter_pos,
                                          srcs[1].meter_pos)
        assert _sync_state(srcs[0]) == _sync_state(srcs[1]), k


@pytest.mark.parametrize("normalize", [False, True])
def test_batched_scroller_matches_jax(normalize):
    """The shared-sync fan-out scroller: displays, latches and input RMS
    under mute, a 50 ms lag from tick 10 and a capture timeout."""
    cfg = _wf_cfg(2, normalize_volume=normalize)
    S = 3
    scrs = [BatchedWaveformScroller(cfg, S),
            JaxBatched(_jax_cfg(cfg), S)]
    rng = np.random.default_rng(50 + normalize)
    now = T0
    for k in range(45):
        x = (0.3 * rng.standard_normal((S, 2, 480))).astype(np.float32)
        x[2] = 0.0
        if k < 30:
            for scr in scrs:
                scr.feed_batch(x, now - (LAG if k >= 10 else 0), now,
                               muted=k in (4, 5))
        now += STEP if k != 35 else 600_000_000
        outs = [scr.tick(now).copy() for scr in scrs]
        np.testing.assert_array_equal(outs[0], outs[1], err_msg=f"tick {k}")
        np.testing.assert_array_equal(scrs[0].last_silent,
                                      scrs[1].last_silent)
        np.testing.assert_array_equal(scrs[0].input_rms, scrs[1].input_rms)
        assert scrs[0].waveform_ts == scrs[1].waveform_ts
    assert scrs[0].last_silent.all()


def test_ts_to_frames_matches_jax():
    ns = np.random.default_rng(60).integers(-10**12, 10**12, 1000)
    np.testing.assert_array_equal(ts_to_frames(SR, ns),
                                  jax_ts_to_frames(SR, ns))
