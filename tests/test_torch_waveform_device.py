"""The port's DeviceWaveformEngine (on the CPU) against the JAX engine.

The cases mirror ``tests/test_waveform_device.py``: the same seeded packet
schedule and clock go into the port's engine (``device="cpu"``) and the
JAX engine, each package resolving the same settings with its own
``resolve``; every tick's display must agree within 1e-4 dB, pixels at
DB_MIN and the silence latch exactly.  The port's engine is also held to
the port's host ``WaveformScroller`` (as the JAX suite holds the JAX
engine), its native assembly to its numpy assembly and its microbatch
flush to single ticks, bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_serving import _jax_cfg
from waveform_tpu.runtime.waveform_device import (
    DeviceWaveformEngine as JaxEngine,
)
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    ChannelMode,
    DisplayMode,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.native import load_library
from waveform_tpu_torch.runtime.source import StreamSource
from waveform_tpu_torch.runtime.waveform_device import (
    DeviceWaveformEngine,
    rms_window_sum,
)
from waveform_tpu_torch.runtime.waveform_host import WaveformScroller

NS, SR = 1_000_000_000, 48000
HOP_NS = 480 * NS // SR


def _cfg(channels=2, **kw):
    return resolve(Settings(display_mode=DisplayMode.WAVEFORM,
                            temporal_smoothing=TSmoothingMode.NONE, **kw),
                   AudioInfo(SR, channels))


def _assert_same(got, want):
    """Within 1e-4 dB, DB_MIN exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])
    np.testing.assert_allclose(got[~floor], want[~floor], rtol=0, atol=1e-4)


def _sine(k, freq, amp, frames=480):
    t = (np.arange(frames) + k * frames) / SR
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return np.stack([x, x])


def _shared(k, now):
    return [(s, _sine(k, 440, 0.1 * (s + 1)), now) for s in range(3)]


def _independent(k, now):
    """Stream 0 every tick, stream 1 double packets every other tick,
    stream 2 stamped 50 ms behind the clock."""
    out = [(0, _sine(k, 300, 0.3), now)]
    if k % 2 == 1:
        x1 = _sine((k - 1) // 2, 700, 0.2, frames=960)
        out.append((1, x1, now - 960 * NS // SR))
    out.append((2, _sine(k, 1100, 0.15), now - 50_000_000))
    return out


def _timeout(k, now):
    """A tone and a zero stream, then no packets (a capture timeout)."""
    if k >= 30:
        return []
    return [(0, _sine(k, 500, 0.5), now),
            (1, np.zeros((2, 480), np.float32), now)]


def _loud_step(k, now):
    amp = 0.02 if k < 25 else 0.5
    return [(s, _sine(k, 440, amp * (s + 1), frames=960), now)
            for s in range(2)]


def _lead(lead_ns):
    def feeds(k, now):
        return [(0, _sine(k, 500, 0.3), now + lead_ns)]
    return feeds


def _mono(k, now):
    return [(s, _sine(k, 440, 0.3)[:1], now) for s in range(2)]


def _noise(k, now):
    rng = np.random.default_rng(1000 + k)
    return [(s, (0.4 * rng.standard_normal((2, 480))).astype(np.float32),
             now) for s in range(3)]


# case: (settings, capture channels, S, feeds, ticks, ns a tick (or a
#        function of the tick), {tick: [(stream, show)]})
CASES = {
    "shared_schedule": (dict(width=320, meter_buf=150), 2, 3, _shared, 40,
                        HOP_NS, {}),
    "independent_sync": (dict(width=256, meter_buf=120), 2, 3, _independent,
                         50, HOP_NS, {}),
    "timeout_latch": (dict(width=160, meter_buf=100), 2, 2, _timeout, 40,
                      lambda k: HOP_NS if k < 30 else 100_000_000, {}),
    "normalize": (dict(width=200, meter_buf=100, normalize_volume=True,
                       volume_target=-8, max_gain=30), 2, 2, _loud_step, 50,
                  2 * HOP_NS, {}),
    "normalize_ts_offset": (dict(width=200, meter_buf=100,
                                 normalize_volume=True, volume_target=-8,
                                 max_gain=30, audio_sync_offset=80), 2, 2,
                            _loud_step, 50, 2 * HOP_NS, {}),
    "lead_within_budget": (dict(width=256, meter_buf=120), 2, 1,
                           _lead(100_000_000), 40, HOP_NS, {}),
    "lead_clamped": (dict(width=256, meter_buf=120), 2, 1, _lead(NS), 40,
                     HOP_NS, {}),
    "stereo_of_mono": (dict(width=192, meter_buf=100,
                            channel_mode=ChannelMode.STEREO), 1, 2, _mono,
                       30, HOP_NS, {}),
    "hidden_keeps_draining": (dict(width=160, meter_buf=100), 2, 3, _noise,
                              40, HOP_NS, {10: [(1, False)], 20: [(1, True)]}),
}


def _drive(engines, feeds, ticks, step_ns, shows=None, check=None):
    """Feed every engine the same schedule, the clock advancing
    ``step_ns`` (or ``step_ns(k)``) a tick; after each tick call
    ``check(k, outputs)``."""
    now = NS
    for k in range(ticks):
        for (s, data, ts) in feeds(k, now):
            for e in engines:
                e.feed(s, data, ts, now_ns=now)
        for s, show in (shows or {}).get(k, []):
            for e in engines:
                e.set_show(s, show)
        now += step_ns(k) if callable(step_ns) else step_ns
        outs = [e.tick(now_ns=now) for e in engines]
        if check is not None:
            check(k, outs)
    return now


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(case):
    settings, channels, S, feeds, ticks, step, shows = CASES[case]
    cfg = _cfg(channels, **settings)
    port = DeviceWaveformEngine(cfg, S, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S)

    def check(k, outs):
        _assert_same(outs[0].numpy(), outs[1])
        np.testing.assert_array_equal(port.last_silent, ref.last_silent,
                                      err_msg=f"tick {k}")

    _drive([port, ref], feeds, ticks, step, shows, check)
    vals = port.render_values()
    if case == "timeout_latch":
        assert (vals == np.float32(DB_MIN)).all() and port.last_silent.all()
    else:
        assert vals.max() > DB_MIN + 100


@pytest.mark.parametrize("case", ["shared_schedule", "independent_sync"])
def test_engine_matches_port_scroller(case):
    """The port's engine against S of the port's host scrollers, each on
    its own ``StreamSource`` (the JAX suite's spec check)."""
    settings, channels, S, feeds, ticks, step, _ = CASES[case]
    cfg = _cfg(channels, **settings)
    eng = DeviceWaveformEngine(cfg, S, device="cpu")
    srcs = [StreamSource(cfg) for _ in range(S)]
    scrs = [WaveformScroller(cfg) for _ in range(S)]
    now = NS
    for k in range(ticks):
        for (s, data, ts) in feeds(k, now):
            eng.feed(s, data, ts, now_ns=now)
            srcs[s].capture_audio(data, ts, now_ns=now)
        now += step
        got = eng.tick(now_ns=now).numpy()
        want = np.stack([scrs[s].tick(srcs[s], now, 1 / 60)
                         for s in range(S)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _native_or_skip():
    if load_library() is None:
        pytest.skip("native assembler unavailable (no g++)")


def test_native_assembly_matches_numpy_bitwise():
    """The C++ waveform assembly against the numpy ``_assemble`` under a
    torture schedule: uneven cadence, mutes, a bogus timestamp, sync lag
    and lead, show toggles, a capture dropout, volume normalization."""
    _native_or_skip()
    cfg = _cfg(width=192, meter_buf=110, normalize_volume=True,
               volume_target=-8, max_gain=30, audio_sync_offset=40)
    S = 4
    nat = DeviceWaveformEngine(cfg, S, use_native=True, device="cpu")
    pyt = DeviceWaveformEngine(cfg, S, use_native=False, device="cpu")
    assert nat._native is not None and pyt._native is None
    rng = np.random.default_rng(11)

    def feeds(k, now):
        out = []
        for s in range(S):
            if (s == 1 and k % 3 != 0) or (s == 3 and 30 <= k < 38):
                continue                  # uneven cadence; s3's dropout
            pkt = (0.25 * (s + 1) / S * rng.standard_normal(
                (2, [480, 960, 444][k % 3]))).astype(np.float32)
            ts = now + {2: -60_000_000, 3: 90_000_000}.get(s, 0)
            if k == 20 and s == 0:
                ts = now + 30 * NS                 # bogus (> 16 s)
            out.append((s, pkt, ts))
        return out

    muted = set(range(25, 28))

    class Muting:
        """Mute stream 0 for ticks 25-27 on both engines."""

        def __init__(self, eng):
            self.eng, self.k = eng, 0

        def feed(self, s, data, ts, now_ns):
            self.eng.feed(s, data, ts, now_ns=now_ns,
                          muted=(s == 0 and self.k in muted))

        def set_show(self, s, show):
            self.eng.set_show(s, show)

        def tick(self, now_ns):
            self.k += 1
            return self.eng.tick(now_ns=now_ns)

    def check(k, outs):
        assert torch.equal(outs[0], outs[1]), k

    _drive([Muting(nat), Muting(pyt)], feeds, 50, HOP_NS,
           {10: [(1, False)], 16: [(1, True)]}, check)
    np.testing.assert_array_equal(nat.last_silent, pyt.last_silent)


@pytest.mark.parametrize("native", [False, True])
def test_resized_keep_matches_jax(native):
    """resized(keep) carries ring, scroll buffer, latch, RMS ring and the
    host (or native) sync and scroll state: the next ticks match the JAX
    engine resized the same way."""
    if native:
        _native_or_skip()
    cfg = _cfg(width=128, meter_buf=100, normalize_volume=True)
    port = DeviceWaveformEngine(cfg, 3, use_native=native, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), 3, use_native=native)

    def check(k, outs):
        _assert_same(outs[0].numpy(), outs[1])

    now = _drive([port, ref], _noise, 20, HOP_NS, None, check)
    port2, ref2 = port.resized(4, keep=[2, 0]), ref.resized(4, keep=[2, 0])
    assert (port2._native is not None) == native
    _assert_same(port2.render_values(), ref2.render_values())
    for k in range(15):
        for (s, data, ts) in _noise(100 + k, now):
            for e in (port2, ref2):
                e.feed(s, data, ts, now_ns=now)
        now += HOP_NS
        _assert_same(port2.tick(now_ns=now).numpy(), ref2.tick(now_ns=now))
    np.testing.assert_array_equal(port2.last_silent, ref2.last_silent)
    with pytest.raises(ValueError):
        port.resized(2, keep=[0, 1, 2])
    with pytest.raises(ValueError):
        port.resized(2, keep=[3])


def test_microbatch_matches_single_ticks_bitwise():
    """microbatch=4 flushes four assembled ticks as one device call: each
    flush's outputs equal four single ticks bit for bit; between flushes
    ``tick`` returns the last flushed frame."""
    cfg = _cfg(width=96, meter_buf=80)
    one = DeviceWaveformEngine(cfg, 3, device="cpu")
    mb = DeviceWaveformEngine(cfg, 3, microbatch=4, device="cpu")
    singles = []

    def check(k, outs):
        singles.append(outs[0].clone())
        if k % 4 == 3:
            for i in range(4):
                assert torch.equal(mb.last_batch_pixels[i],
                                   singles[k - 3 + i]), (k, i)
        else:
            assert torch.equal(outs[1], singles[k - k % 4 - 1]
                               if k >= 4 else mb.display)

    _drive([one, mb], _noise, 12, HOP_NS, None, check)
    np.testing.assert_array_equal(mb.render_values(), one.render_values())
    np.testing.assert_array_equal(mb.last_silent, one.last_silent)


def test_auto_microbatch_resolves():
    """microbatch="auto" probes and locks in some k; frames keep flowing
    throughout (probe ticks are plain single ticks)."""
    cfg = _cfg(width=64, meter_buf=60)
    eng = DeviceWaveformEngine(cfg, 2, microbatch="auto", device="cpu")
    _drive([eng], lambda k, now: _shared(k, now)[:2], 20, HOP_NS)
    assert eng.microbatch >= 1 and not eng._mb_auto
    assert eng.render_values().max() > DB_MIN + 100


@pytest.mark.parametrize("native", [False, True])
def test_feed_batch_matches_per_stream(native):
    """feed_batch (one shared timestamp) equals S per-stream feeds with
    that timestamp, on both host paths, bit for bit."""
    if native:
        _native_or_skip()
    cfg = _cfg(width=96, meter_buf=80)
    a = DeviceWaveformEngine(cfg, 3, use_native=native, device="cpu")
    b = DeviceWaveformEngine(cfg, 3, use_native=native, device="cpu")
    rng = np.random.default_rng(3)
    now = NS
    for _ in range(15):
        pkt = (0.3 * rng.standard_normal((3, 2, 480))).astype(np.float32)
        a.feed_batch(pkt, now, now_ns=now)
        for s in range(3):
            b.feed(s, pkt[s], now, now_ns=now)
        now += HOP_NS
        assert torch.equal(a.tick(now_ns=now), b.tick(now_ns=now))


def test_rms_window_sum_is_the_clipped_slice():
    """rms_window_sum against numpy slices with the JAX step's clipped
    start (``dynamic_slice``), reserves past both ends included."""
    rng = np.random.default_rng(4)
    rows = rng.random((5, 40), dtype=np.float32)
    reserve = np.array([0, 3, 12, 30, -4])
    got = rms_window_sum(torch.from_numpy(rows), torch.from_numpy(reserve),
                         24).numpy()
    for s in range(5):
        start = int(np.clip(40 - reserve[s] - 24, 0, 16))
        np.testing.assert_allclose(got[s], rows[s, start:start + 24].sum(),
                                   rtol=1e-6)


def test_engine_refuses_other_modes():
    with pytest.raises(ValueError, match="waveform mode"):
        DeviceWaveformEngine(resolve(Settings(fft_size=1024),
                                     AudioInfo(SR, 2)), 2, device="cpu")
