"""The port's meter step and MeterServingEngine against the JAX package's.

The same numpy-seeded windows and packets go through both packages, each
resolving the same settings: levels within 1e-4 dB (exactly where the
reference reads DB_MIN), latches and ring zeroing exact.  The engine
cases cover the reference's gate order (timeout zeroes the ring the
first time and then freezes, hide zeroes only the levels), microbatching,
``tick_many`` and checkpoints, all inherited from ``ServingEngine``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu.dsp import meter as jmeter
from waveform_tpu.dsp.devring import DeviceRing as JaxRing
from waveform_tpu.runtime.meter_serving import MeterServingEngine as JaxMeter
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    DisplayMode,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.dsp import meter as tmeter
from waveform_tpu_torch.dsp.devring import DeviceRing
from waveform_tpu_torch.dsp.spectrum import gravity_pair
from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine

from test_torch_serving import _jax_cfg

SR, NS = 48000, 1_000_000_000


def _cfg(**kw):
    kw.setdefault("meter_buf", 100)
    return resolve(Settings(display_mode=DisplayMode.METER, **kw),
                   AudioInfo(SR, 2))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])
    np.testing.assert_allclose(got[~floor], want[~floor], rtol=0, atol=1e-4)


@pytest.mark.parametrize("smoothing", [TSmoothingMode.EXPONENTIAL,
                                       TSmoothingMode.TVEXPONENTIAL,
                                       TSmoothingMode.NONE])
@pytest.mark.parametrize("rms", [True, False])
def test_meter_steps_match_jax(rms, smoothing):
    """Both step forms over three ticks with every gate: live, hidden,
    timed out (latched then frozen) and a silent stream; the serving
    step's ring zeroing on the first timeout only.  ``dt`` as a float and
    as the device pair give the same bits."""
    cfg = _cfg(rms_mode=rms, temporal_smoothing=smoothing)
    jcfg = _jax_cfg(cfg)
    S, C, M = 5, 2, cfg.fft_size
    rng = np.random.default_rng(61 + rms)
    fresh = np.array([True, True, False, True, False])
    show = np.array([True, False, True, True, True])
    tstep, jstep = tmeter.make_meter_step(cfg), jmeter.make_meter_step(jcfg)
    tsrv = tmeter.make_meter_serving_step(cfg)
    jsrv = jmeter.make_meter_serving_step(jcfg)
    ts = tmeter.init_meter_state(cfg, S, device="cpu")
    js = jmeter.init_meter_state(jcfg, S)
    ts2, js2 = tmeter.init_meter_state(cfg, S, device="cpu"), js
    for k in range(3):
        w = (0.3 * rng.standard_normal((S, C, M))).astype(np.float32)
        w[3] = 0.0
        dt = 1 / 60 + 0.01 * k
        ts = tstep(torch.from_numpy(w), ts, dt, torch.from_numpy(fresh),
                   torch.from_numpy(show))
        js = jstep(jnp.asarray(w), js, jnp.float32(dt), jnp.asarray(fresh),
                   jnp.asarray(show))
        ring = DeviceRing(buf=torch.from_numpy(w.copy()))
        pair = torch.from_numpy(gravity_pair(cfg, dt))
        ring, ts2 = tsrv(ring, ts2, pair, torch.from_numpy(fresh),
                         torch.from_numpy(show))
        jring, js2 = jsrv(JaxRing(buf=jnp.asarray(w)), js2, jnp.float32(dt),
                          jnp.asarray(fresh), jnp.asarray(show))
        for t, j in ((ts, js), (ts2, js2)):
            _close(t.meter_val.numpy(), j.meter_val)
            np.testing.assert_allclose(t.meter_buf.numpy(), j.meter_buf,
                                       rtol=1e-6, atol=0)
            np.testing.assert_array_equal(t.last_silent.numpy(),
                                          j.last_silent)
        np.testing.assert_array_equal(ring.buf.numpy(), jring.buf)
        # stream 2 times out: its ring zeroed on the first tick only (then
        # latched and frozen); the hidden stream 1 keeps its ring
        assert bool(ring.buf[2].any()) == (k > 0) and ring.buf[1].any()
    assert ts2.last_silent[2] and ts2.last_silent[1] and ts2.last_silent[3]


def _session(engine, S, ticks, rng, now, dt=0.02, hidden=()):
    """Feed 2 x 10 ms packets per stream per tick (stream S-1 silent),
    tick every 20 ms; returns the clock."""
    for _ in range(ticks):
        for _ in range(2):
            x = (0.4 * rng.standard_normal((S, 2, 480))).astype(np.float32)
            x[-1] = 0.0
            for eng in engine:
                for s in range(S):
                    eng.feed(s, x[s], now, now_ns=now)
            now += 480 * NS // SR
        for eng in engine:
            for s in range(S):
                eng.set_show(s, s not in hidden)
            eng.tick(now_ns=now, dt=dt)
    return now


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("rms", [True, False])
def test_meter_engine_matches_jax(rms, native):
    """The engine tick by tick against the JAX engine, a hidden stream
    part of the way, then a capture gap: the first timed-out tick zeroes
    the rings and latches, the next freezes."""
    cfg = _cfg(rms_mode=rms)
    S = 3
    port = MeterServingEngine(cfg, S, use_native=None if native else False,
                              device="cpu")
    if native and port._native is None:
        pytest.skip("no C++ toolchain for the native assembler")
    ref = JaxMeter(_jax_cfg(cfg), S, use_native=native)
    rng = np.random.default_rng(62)
    now = NS
    for hidden in ((), (0,), ()):
        now = _session((port, ref), S, 3, rng, now, hidden=hidden)
        _close(port.meter_values.numpy(), ref.meter_values)
        np.testing.assert_array_equal(port.last_silent, ref.last_silent)
        if hidden:
            assert (port.meter_values[0] == DB_MIN).all()
            assert port.ring.buf[0].any()            # hide keeps the ring
    for dt_ns in (600_000_000, 700_000_000):
        for eng in (port, ref):
            eng.tick(now_ns=now + dt_ns, dt=0.02)
        assert (port.meter_values == DB_MIN).all() and port.last_silent.all()
        assert not port.ring.buf.any()
        np.testing.assert_array_equal(port.ring.buf.numpy(),
                                      np.asarray(ref.ring.buf))
    np.testing.assert_array_equal(port.read_decibels(), ref.read_decibels())


def test_meter_microbatch_tick_many_and_checkpoints(tmp_path):
    """Through the base class: k=4 flushes equal k=1 ticks bit for bit and
    the JAX k=4 engine within 1e-4 dB; ``tick_many`` against JAX's; a
    checkpoint (ring stored [S, C, L], as the JAX meter engine stores it)
    saved by the port loads into the JAX engine and back."""
    cfg = _cfg()
    jcfg = _jax_cfg(cfg)
    S = 2
    one = MeterServingEngine(cfg, S, use_native=False, device="cpu")
    mb = MeterServingEngine(cfg, S, use_native=False, microbatch=4,
                            device="cpu")
    ref = JaxMeter(jcfg, S, use_native=False, microbatch=4)
    rng = np.random.default_rng(63)
    now = _session((one, mb, ref), S, 8, rng, NS)
    np.testing.assert_array_equal(mb.meter_values.numpy(),
                                  one.meter_values.numpy())
    assert tuple(mb.last_batch_pixels.shape) == (4, S, 1, 2)
    _close(mb.meter_values.numpy(), ref.meter_values)

    T, hop = 5, 800
    audio = (0.3 * rng.standard_normal((T, S, 2, hop))).astype(np.float32)
    active = np.ones((T, S), bool)
    active[2:, 1] = False
    bulk = MeterServingEngine(cfg, S, use_native=False, device="cpu")
    jbulk = JaxMeter(jcfg, S, use_native=False)
    got = bulk.tick_many(audio, active=active, dt=0.02)
    want = jbulk.tick_many(audio, active=active, dt=0.02)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(bulk.ring.buf.numpy(), jbulk.ring.buf)

    path = str(tmp_path / "meter.npz")
    one.save_state(path)
    assert np.load(path)["leaf_3"].shape == (S, 2, cfg.fft_size)
    back, jback = (MeterServingEngine(cfg, S, use_native=False, device="cpu"),
                   JaxMeter(jcfg, S, use_native=False))
    jback.load_state(path)
    jpath = str(tmp_path / "meter_jax.npz")
    jback.save_state(jpath)
    back.load_state(jpath)
    np.testing.assert_array_equal(np.asarray(jback.meter_values),
                                  one.meter_values.numpy())
    np.testing.assert_array_equal(back.meter_values.numpy(),
                                  one.meter_values.numpy())
    np.testing.assert_array_equal(back.ring.buf.numpy(), one.ring.buf.numpy())
