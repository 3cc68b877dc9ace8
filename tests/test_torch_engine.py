"""The port's per-stream WaveformEngine (on the CPU) against the JAX one.

Both engines run S ``StreamSource``s on the host and one step a tick; the
same seeded per-stream packets and clock go into each (settings resolved
by each package's own ``resolve``), through mute, a 50 ms sync lag, a
hidden stream and a capture timeout.  Spectrum and meter outputs must
agree within 1e-4 dB on values above -120 dB, exactly at DB_MIN, latches
exactly (``test_torch_serving._assert_same``'s bounds); waveform mode
runs the host scrollers on both sides and must be equal.  Spectrum mode
runs under ``WAVEFORM_TPU_FFT_BACKEND=xla`` (the engine's mechanics are
the point; ``tests/test_torch_backends.py`` holds the two xla steps
together), plus one exact case through the JAX kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

from test_torch_serving import _jax_cfg
from waveform_tpu.runtime.engine import WaveformEngine as JaxEngine
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    DisplayMode,
    FFTWindow,
    Settings,
    resolve,
)
from waveform_tpu_torch.runtime.engine import WaveformEngine

SR, T0, FRAME = 48000, 10_000_000_000, 16_666_667


def _assert_close(got, want, floor=True):
    """Within 1e-4 dB above -120 dB and, with ``floor``, exactly at
    DB_MIN (rebinned pixels mix DB_MIN columns by interpolation weights,
    so ``_assert_same`` holds pixels to the visible bound alone)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
    if floor:
        at = want == np.float32(DB_MIN)
        np.testing.assert_array_equal(got[at], want[at])


def _host(out):
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _drive(engines, S, ticks, seed, compare, k0=0, now=T0):
    """Per-stream packets of noise (uneven sizes), stream 1 stamped 50 ms
    behind the clock and muted on ticks 3-4, stream 0 hidden on ticks 5-7,
    the last stream silent from tick 8 and stopped from tick 10 (a capture
    timeout); ``compare(k, outputs)`` after each tick."""
    rng = np.random.default_rng(seed)
    for k in range(k0, k0 + ticks):
        for s in range(S):
            frames = 800 + 37 * s * (1 if k % 2 else -1)
            x = (0.3 * rng.standard_normal((2, frames))).astype(np.float32)
            if s == S - 1 and k >= 8:
                if k >= 10:
                    continue
                x[:] = 0.0
            ts = now - (50_000_000 if s == 1 else 0)
            for e in engines:
                e.feed(s, x, ts, now_ns=now, muted=(s == 1 and k in (3, 4)))
        for e in engines:
            e.set_show(0, not 5 <= k < 8)
        now += FRAME if k != 12 else 600_000_000
        compare(k, [_host(e.tick(now_ns=now)) for e in engines])
    return now


def _engines(cfg, S, **kw):
    return (WaveformEngine(cfg, S, device="cpu", **kw),
            JaxEngine(_jax_cfg(cfg), S))


def _check(port, ref):
    def compare(k, outs):
        _assert_close(outs[0], outs[1])
        np.testing.assert_array_equal(port.last_silent, ref.last_silent,
                                      err_msg=f"tick {k}")
    return compare


MODES = {
    "spectrum": dict(fft_size=1024, width=300, window=FFTWindow.HANN),
    "meter": dict(display_mode=DisplayMode.METER, meter_buf=50),
    "waveform": dict(display_mode=DisplayMode.WAVEFORM, width=200,
                     meter_buf=100),
}


@pytest.fixture
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(mode, jit, xla_backend):
    cfg = resolve(Settings(**MODES[mode]), AudioInfo(SR, 2))
    S = 3
    port, ref = _engines(cfg, S, jit=jit)
    if mode == "waveform":
        def compare(k, outs):
            np.testing.assert_array_equal(outs[0], outs[1])
            np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    else:
        compare = _check(port, ref)
    _drive([port, ref], S, 16, 70, compare)
    _assert_close(port.render_values(), ref.render_values(),
                  floor=mode != "spectrum")
    assert port.last_silent[-1]


def test_spectrum_exact_matches_jax(monkeypatch):
    """The exact backend (the port's K1-gen twin here, the JAX kernel in
    interpret mode) at N=1024, S=2."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    cfg = resolve(Settings(**MODES["spectrum"]), AudioInfo(SR, 2))
    port, ref = _engines(cfg, 2)
    _drive([port, ref], 2, 6, 71, _check(port, ref))
    _assert_close(port.render_values(), ref.render_values(), floor=False)


@pytest.mark.parametrize("mode", list(MODES))
def test_resized_matches_jax(mode, xla_backend):
    """resized(4, keep=[2, 0]) moves each kept row's host source and
    analysis state; the next ticks (row 1 a fresh stream) match the JAX
    engine resized the same way."""
    cfg = resolve(Settings(**MODES[mode]), AudioInfo(SR, 2))
    port, ref = _engines(cfg, 3)
    now = _drive([port, ref], 3, 6, 72, lambda k, outs: None)
    port, ref = port.resized(4, keep=[2, 0]), ref.resized(4, keep=[2, 0])
    _assert_close(port.render_values(), ref.render_values(),
                  floor=mode != "spectrum")
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    _drive([port, ref], 4, 8, 73, _check(port, ref), k0=6, now=now)
    with pytest.raises(ValueError):
        port.resized(1, keep=[0, 1])
    with pytest.raises(ValueError):
        port.resized(2, keep=[7])


def test_rfft_fn_is_not_ported_yet():
    """The rfft_fn override, now ported: ``WaveformEngine(rfft_fn=
    torch.fft.rfft)`` against the JAX engine with ``jnp.fft.rfft`` (the
    exact backend set, so only the override can make the two agree), and
    ``resized`` keeps the function."""
    import jax.numpy as jnp
    cfg = resolve(Settings(**MODES["spectrum"]), AudioInfo(SR, 2))
    port = WaveformEngine(cfg, 3, rfft_fn=torch.fft.rfft, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), 3, rfft_fn=jnp.fft.rfft)
    now = _drive([port, ref], 3, 12, 74, _check(port, ref))
    _assert_close(port.render_values(), ref.render_values(), floor=False)
    port, ref = port.resized(2, keep=[2]), ref.resized(2, keep=[2])
    assert port._rfft_fn is torch.fft.rfft
    _drive([port, ref], 2, 4, 75, _check(port, ref), k0=12, now=now)
