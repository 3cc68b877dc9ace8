"""The port's OutputBus (``runtime/bus.py``) against the JAX OutputBus.

The cases mirror the 15 cases of ``tests/test_bus.py``: the same packets
and clock go into a JAX bus and a port bus (``device="cpu"``), each
package resolving the same settings with its own ``resolve``, under
``WAVEFORM_TPU_FFT_BACKEND=xla`` (the bus's mechanics are the point;
``tests/test_torch_backends.py`` holds the two xla steps together), and
one case on the exact path at N=1024.  Spectrum and meter values agree
within 1e-4 dB on bins above -120 dBFS, waveform displays within 1e-4 dB
with DB_MIN exact (and the latch exactly); the JAX case's own assertions
then run on the port.  Audio is noise-dominated where spectra are
compared, as in the other parity files.
"""

import numpy as np
import pytest
import torch

from test_torch_serving import _jax_cfg
from waveform_tpu.dsp import oracle as jax_oracle
from waveform_tpu.runtime.bus import OutputBus as JaxBus
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    DisplayMode,
    FFTWindow,
    Settings,
    TSmoothingMode,
    oracle,
    resolve,
)
from waveform_tpu_torch.render import raster
from waveform_tpu_torch.runtime.bus import OutputBus
from waveform_tpu_torch.runtime.serving import ServingEngine

NS, SR = 1_000_000_000, 48000


@pytest.fixture(autouse=True)
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def _cfg(**kw):
    return resolve(Settings(temporal_smoothing=TSmoothingMode.NONE, **kw),
                   AudioInfo(SR, 2))


def _meter_cfg(**kw):
    return _cfg(display_mode=DisplayMode.METER, **kw)


def _wf_cfg(**kw):
    kw = {"width": 512, "meter_buf": 100, **kw}
    return resolve(Settings(display_mode=DisplayMode.WAVEFORM, **kw),
                   AudioInfo(SR, 2))


def _assert_close(got, want):
    """Within 1e-4 dB where the JAX value is above -120 dBFS, DB_MIN
    exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)


class Pair:
    """A port bus and a JAX bus driven alike; handles are (port, JAX)."""

    def __init__(self, audio=AudioInfo(SR, 2), **kw):
        self.port = OutputBus(audio, device="cpu", **kw)
        self.ref = JaxBus(audio, **kw)
        self.now = NS

    def subscribe(self, cfg):
        return self.port.subscribe(cfg), self.ref.subscribe(_jax_cfg(cfg))

    def unsubscribe(self, h):
        self.port.unsubscribe(h[0])
        self.ref.unsubscribe(h[1])

    def feed(self, x, ts=None):
        ts = self.now if ts is None else ts
        self.port.feed(x, ts, now_ns=self.now)
        self.ref.feed(x, ts, now_ns=self.now)

    def tick(self, now=None):
        now = self.now if now is None else now
        self.port.tick(now_ns=now)
        self.ref.tick(now_ns=now)

    def run(self, packets):
        for x in packets:
            self.feed(x)
            self.now += x.shape[-1] * NS // SR
            self.tick()

    def check(self, *handles):
        """Every handle's decibels and pixels against the JAX bus; returns
        the port's decibels of the first."""
        for hp, hj in handles:
            _assert_close(self.port.read_decibels(hp),
                          self.ref.read_decibels(hj))
            _assert_close(self.port.read_pixels(hp),
                          self.ref.read_pixels(hj))
        return self.port.read_decibels(handles[0][0])


def _packets(n_ticks=40, freq=2250.0, frames=800, noise=0.3, amp=1.0,
             seed=0):
    """A tone (``amp``) plus seeded noise (``noise``), [2, frames] a tick."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_ticks):
        t = (np.arange(frames) + k * frames) / SR
        x = amp * np.sin(2 * np.pi * freq * t)
        out.append((x + noise * rng.standard_normal((2, frames))).astype(
            np.float32))
    return out


def test_bus_matches_serving_engine():
    """One consumer: the port bus against the JAX bus, and within 1e-3 dB
    of a standalone port ServingEngine fed the same packets."""
    cfg = _cfg(fft_size=1024, window=FFTWindow.HANN)
    bus = Pair()
    h = bus.subscribe(cfg)
    pkts = _packets()
    bus.run(pkts)
    got = bus.check(h)
    eng = ServingEngine(cfg, 1, device="cpu")
    now = NS
    for x in pkts:
        eng.feed(0, x, now, now_ns=now)
        now += x.shape[-1] * NS // SR
        eng.tick(now_ns=now)
    np.testing.assert_allclose(got, eng.read_decibels()[0], atol=1e-3)


def test_bus_heterogeneous_consumers_share_ring():
    cfgs = [_cfg(fft_size=512, window=FFTWindow.HANN),
            _cfg(fft_size=1024, window=FFTWindow.BLACKMAN),
            _cfg(fft_size=2048, window=FFTWindow.HANN, slope=0.5)]
    bus = Pair()
    handles = [bus.subscribe(cfgs[i % 3]) for i in range(6)]
    bus.run(_packets(freq=SR / 512 * 24))
    bus.check(*handles)
    assert bus.port.num_groups == 3
    assert bus.port.ring.buf.shape[0] == 1          # ONE shared ring
    for i, (hp, _) in enumerate(handles):
        n = cfgs[i % 3].fft_size
        pk = int(np.argmax(bus.port.read_decibels(hp)[0])) * SR / n
        assert abs(pk - SR / 512 * 24) < 2 * SR / n
    np.testing.assert_array_equal(bus.port.read_decibels(handles[0][0]),
                                  bus.port.read_decibels(handles[3][0]))


def test_bus_timeout_gates_active():
    cfg = _cfg(fft_size=512)
    bus = Pair()
    h = bus.subscribe(cfg)
    bus.run(_packets(n_ticks=10))
    bus.tick(now=bus.now + 600_000_000)   # > capture timeout
    assert (bus.check(h) == DB_MIN).all()


def test_bus_live_subscribe_and_unsubscribe():
    """Consumers attach to and detach from a RUNNING bus: a larger late
    subscriber grows the shared ring with its history carried into the
    tail, and the existing consumer's state is untouched."""
    cfg_a = _cfg(fft_size=512, window=FFTWindow.HANN)
    bus = Pair()
    ha = bus.subscribe(cfg_a)
    freq = SR / 512 * 24        # bin-exact for both sizes
    bus.run(_packets(n_ticks=30, freq=freq))
    L_before, ring_before = bus.port.L, bus.port.ring.buf.clone()
    pre = bus.port.read_decibels(ha[0])

    hb = bus.subscribe(_cfg(fft_size=2048, window=FFTWindow.HANN))
    assert bus.port.L == bus.ref.L > L_before
    assert torch.equal(bus.port.ring.buf[..., -L_before:], ring_before)
    assert (bus.port.ring.buf[..., :-L_before] == 0).all()
    np.testing.assert_array_equal(bus.port.read_decibels(ha[0]), pre)
    bus.run(_packets(n_ticks=1, freq=freq, seed=1))
    db_b = bus.check(hb, ha)
    assert int(np.argmax(db_b[0])) == 24 * 4 and db_b[0].max() > -2
    assert int(np.argmax(bus.port.read_decibels(ha[0])[0])) == 24

    ha2 = bus.subscribe(cfg_a)          # an existing config: no-op
    np.testing.assert_array_equal(bus.port.read_decibels(ha2[0]),
                                  bus.port.read_decibels(ha[0]))
    bus.unsubscribe(hb)
    assert bus.port.num_groups == 1
    bus.unsubscribe(ha2)
    assert bus.port.num_groups == 1     # ha still holds cfg_a
    with pytest.raises(KeyError):
        bus.port.read_decibels(ha2[0])
    bus.run(_packets(n_ticks=2, freq=freq, seed=2))
    assert DB_MIN <= bus.check(ha).max() <= 0.0


def test_bus_mixed_consumers_share_ring():
    """Spectrum + meter + waveform tick off ONE shared ring with one
    upload a tick."""
    spec = _cfg(fft_size=1024, window=FFTWindow.HANN)
    met = _meter_cfg(rms_mode=True, meter_buf=150)
    wf = _wf_cfg()
    bus = Pair()
    hs, hm, hw = bus.subscribe(spec), bus.subscribe(met), bus.subscribe(wf)
    assert bus.port.num_groups == 3
    # the JAX case's pure tone: the spectrum's deep sidelobes differ
    # between any two f32 FFTs, so the spectrum parity is held by the
    # noise-dominated cases; the meter and the waveform here
    bus.run(_packets(freq=SR / 1024 * 24, noise=0.0))
    bus.check(hm, hw)
    assert bus.port.ring.buf.shape[0] == 1
    assert int(np.argmax(bus.port.read_decibels(hs[0])[0])) == 24
    lv = bus.port.read_pixels(hm[0])
    assert lv.shape == (2,)
    np.testing.assert_allclose(lv, -3.0103, atol=0.1)
    disp = bus.port.read_pixels(hw[0])
    assert disp.shape == (1, 512) and np.isfinite(disp).all()
    assert -1.0 < disp.max() <= 0.0


def test_bus_meter_peak_mode_and_timeout_mask():
    met = _meter_cfg(rms_mode=False, meter_buf=150)
    bus = Pair()
    h = bus.subscribe(met)
    bus.run(_packets(n_ticks=30, amp=0.5, noise=0.0))
    steady = bus.check(h)
    np.testing.assert_allclose(steady, 20 * np.log10(0.5), atol=0.05)
    t = bus.now + 600_000_000
    bus.tick(now=t)                      # timeout: DB_MIN, latched
    assert (bus.check(h) == DB_MIN).all()
    # resume with ONE packet: pre-timeout ring samples are masked out
    tt = (np.arange(800) + 30 * 800) / SR
    x = (0.25 * np.sin(2 * np.pi * 2250.0 * tt)).astype(np.float32)
    bus.now = t
    bus.feed(np.stack([x, x]))
    bus.tick(now=t + 800 * NS // SR)
    lv = bus.check(h)
    assert (lv <= 20 * np.log10(0.25) + 0.1).all() and (lv > DB_MIN).all()


def test_bus_waveform_scrolls_and_blanks():
    wf = _wf_cfg()
    bus = Pair()
    h = bus.subscribe(wf)
    bus.run([np.full((2, 800), 0.5, np.float32) for _ in range(40)])
    np.testing.assert_allclose(bus.check(h)[0], 20 * np.log10(0.5),
                               atol=1e-4)
    bus.tick(now=bus.now + 600_000_000)
    assert (bus.check(h) == DB_MIN).all()
    assert bool(bus.port._groups[wf]["latch"])


def test_bus_waveform_silence_blanks():
    wf = _wf_cfg()
    bus = Pair()
    h = bus.subscribe(wf)
    bus.run([np.zeros((2, 800), np.float32) for _ in range(20)])
    assert (bus.check(h) == DB_MIN).all()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(channel_mode=None, normalize_volume=True),
    dict(width=700, meter_buf=300),
])
def test_bus_waveform_noise_matches_jax(kw):
    """Noise through waveform consumers (mono fold, stereo display with
    volume normalization, another width and window), packets of uneven
    size and a late stamp: every tick's display against the JAX bus."""
    from waveform_tpu_torch import ChannelMode
    if "channel_mode" in kw:
        kw["channel_mode"] = ChannelMode.STEREO
    wf = _wf_cfg(**kw)
    bus = Pair()
    h = bus.subscribe(wf)
    rng = np.random.default_rng(8)
    for k in range(24):
        frames = (480, 800, 1120)[k % 3]
        x = (0.3 * rng.standard_normal((2, frames))).astype(np.float32)
        bus.feed(x, ts=bus.now - (30_000_000 if k % 5 == 2 else 0))
        bus.now += 800 * NS // SR
        bus.tick()
        bus.check(h)
    assert bool(bus.port._groups[wf]["latch"]) == bool(
        bus.ref._groups[_jax_cfg(wf)]["latch"])


def test_bus_pixels_shape():
    cfg = _cfg(fft_size=1024, width=640)
    bus = Pair()
    h = bus.subscribe(cfg)
    bus.run(_packets(n_ticks=5))
    bus.check(h)
    px = bus.port.read_pixels(h[0])
    assert px.shape == (1, 640) and np.isfinite(px).all()


def test_bus_read_before_tick_raises_clearly():
    bus = OutputBus(AudioInfo(SR, 2), device="cpu")
    h = bus.subscribe(_cfg(fft_size=512))
    with pytest.raises(RuntimeError, match="tick"):
        bus.read_pixels(h)
    with pytest.raises(RuntimeError, match="tick"):
        bus.read_decibels(h)


def test_bus_rms_window_survives_push_longer_than_window():
    """A single tick pushing more samples than the 1 s RMS window leaves
    exactly the last R squares in the window; the normalized spectrum
    agrees with the JAX bus."""
    cfg = _cfg(fft_size=512, normalize_volume=True)
    R = cfg.input_rms_size
    bus = Pair(hop_budget=R + 512)
    h = bus.subscribe(cfg)
    rng = np.random.default_rng(11)
    big = (0.5 * rng.standard_normal((2, R + 512))).astype(np.float32)
    bus.run([big])
    port = bus.port
    assert np.isclose(port._rms_sum, port._rms_win.sum(dtype=np.float64),
                      rtol=1e-6)
    want = (np.max(np.abs(big[:, -R:]), axis=0).astype(np.float32)
            .astype(np.float64) ** 2).sum()
    assert np.isclose(port._rms_sum, want, rtol=1e-5)
    assert port._rms_sum == bus.ref._rms_sum
    bus.run([(0.5 * rng.standard_normal((2, 480))).astype(np.float32)])
    assert np.isclose(port._rms_sum, port._rms_win.sum(dtype=np.float64),
                      rtol=1e-6)
    bus.check(h)


def _render_both(bus, h, cfg):
    """The port's frame of consumer ``h``, within 1e-6 of the JAX
    renderer's frame of the port's values."""
    import jax
    from waveform_tpu.render import raster as jax_raster
    img = bus.port.render_frame(h[0])
    g = bus.port._groups[cfg]
    vals = (bus.port.read_decibels(h[0]) if g["mode"] != "meter"
            else bus.port.read_pixels(h[0])[None])
    want = np.asarray(jax.jit(jax_raster.make_renderer(_jax_cfg(cfg)))(vals))
    hidden = not np.array_equal(img, want)
    if hidden:          # hide_on_silent blanked the frame
        assert img.max() == 0.0
    else:
        np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)
    return img


def test_bus_render_frame_all_modes():
    """Every consumer mode renders an RGBA frame from its bus state; two
    consumers sharing a config share one renderer."""
    cfg_s = _cfg(fft_size=1024, width=80, height=60)
    cfg_m = _meter_cfg(meter_buf=100, width=40, height=90, bar_width=16,
                       bar_gap=4)
    cfg_w = _cfg(display_mode=DisplayMode.WAVEFORM, width=100, height=50,
                 meter_buf=100)
    bus = Pair()
    hs, hs2 = bus.subscribe(cfg_s), bus.subscribe(cfg_s)
    hm, hw = bus.subscribe(cfg_m), bus.subscribe(cfg_w)
    bus.run(_packets(noise=0.1))
    bus.check(hs, hm, hw)
    img_s = _render_both(bus, hs, cfg_s)
    img_m = _render_both(bus, hm, cfg_m)
    img_w = _render_both(bus, hw, cfg_w)
    assert img_s.shape == (60, 80, 4) and img_m.shape == (90, 40, 4)
    assert img_w.shape == (50, 100, 4)
    for img in (img_s, img_m, img_w):
        assert np.isfinite(img).all() and img[..., 3].max() > 0.5
    np.testing.assert_array_equal(img_s, bus.port.render_frame(hs2[0]))
    assert all((c, False, torch.device("cpu")) in raster._SHARED
               for c in (cfg_s, cfg_m, cfg_w))


def test_bus_render_frame_hide_on_silent():
    """hide_on_silent blanks silent spectrum and meter consumers but never
    waveform consumers (the reference's tick_waveform never sets
    m_last_silent, source_generic.cpp:271-390)."""
    cfg_s = _cfg(fft_size=1024, width=80, height=60, hide_on_silent=True)
    cfg_m = _meter_cfg(meter_buf=100, width=40, height=90, bar_width=16,
                       bar_gap=4, hide_on_silent=True)
    cfg_w = _cfg(display_mode=DisplayMode.WAVEFORM, width=100, height=50,
                 meter_buf=100, hide_on_silent=True)
    bus = Pair()
    hs, hm, hw = (bus.subscribe(c) for c in (cfg_s, cfg_m, cfg_w))
    bus.run(_packets(n_ticks=20, noise=0.1))
    for h, c in ((hs, cfg_s), (hm, cfg_m), (hw, cfg_w)):
        assert _render_both(bus, h, c)[..., 3].max() > 0.5
    bus.run([np.zeros((2, 800), np.float32) for _ in range(40)])
    bus.check(hs, hm, hw)
    assert bus.port.render_frame(hs[0]).max() == 0.0
    assert bus.port.render_frame(hm[0]).max() == 0.0
    assert np.isfinite(_render_both(bus, hw, cfg_w)).all()


def test_resolve_clamps_cutoffs_and_survives_zero_cutoff_high():
    """Scene-JSON cutoffs clamp to the 0-24000 sliders, and the
    cutoff_high=0 + roll-off corner saturates like the reference's IEEE
    float division (source.cpp:898-918): the port's resolve and oracle as
    the JAX package's."""
    cfg = resolve(Settings(cutoff_low=-5, cutoff_high=30000),
                  AudioInfo(SR, 2))
    assert cfg.cutoff_low == 0 and cfg.cutoff_high == 24000
    cfg0 = _cfg(cutoff_low=0, cutoff_high=0, rolloff_q=1.0,
                rolloff_rate=12.0, fft_size=512)
    assert cfg0.cutoff_high == 0
    x = np.sin(2 * np.pi * 440.0 * np.arange(512) / SR)[None].repeat(2, 0)
    db, _ = oracle.spectrum_frame(x, None, cfg0, dt=1 / 60)
    want, _ = jax_oracle.spectrum_frame(x, None, _jax_cfg(cfg0), dt=1 / 60)
    np.testing.assert_array_equal(db, want)
    assert np.all(db[:, 1:] == DB_MIN) and np.isfinite(db).all()


def test_bus_all_unsubscribed_tick_is_noop():
    bus = Pair()
    h = bus.subscribe(_cfg(fft_size=512))
    bus.unsubscribe(h)
    bus.feed(np.zeros((2, 800), np.float32))
    bus.tick(now=NS + 800 * NS // SR)
    assert bus.port.num_groups == 0


def test_bus_exact_path(monkeypatch):
    """The exact path at N=1024 (the JAX kernel in interpret mode): a
    spectrum consumer and a mono-capture one on the ring's strided tail."""
    from waveform_tpu_torch import ChannelMode
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    bus = Pair()
    h1 = bus.subscribe(_cfg(fft_size=1024))
    h2 = bus.subscribe(_cfg(fft_size=1024, channel_mode=ChannelMode.SINGLE,
                            channel=1))
    h3 = bus.subscribe(_wf_cfg())         # a longer window than the FFTs
    bus.run(_packets(n_ticks=4, seed=3))
    bus.check(h1, h2)


def test_bus_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        OutputBus(AudioInfo(SR, 2))
