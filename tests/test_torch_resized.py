"""``resized`` of the port's ServingEngine against the JAX engine's.

A live resize carries each kept row's device window, EMA trail, dB
buffer, latch and RMS window, and its host sync bookkeeping, into a new
engine; rows beyond ``keep`` start fresh.  Both engines take the same
numpy-seeded packets under ``WAVEFORM_TPU_FFT_BACKEND=xla``, resize the
same way and tick on: within 1e-4 dB (exactly where the reference reads
DB_MIN), latches exact.
"""

import numpy as np
import pytest

from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.runtime.serving import ServingEngine

from test_torch_serving import _assert_same, _jax_cfg

SR, NS = 48000, 1_000_000_000


@pytest.fixture(autouse=True)
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def _feed(engines, S, rng, now, silent=()):
    for s in range(S):
        x = (0.4 * rng.standard_normal((2, 480))).astype(np.float32)
        if s in silent:
            x[:] = 0.0
        for eng in engines:
            eng.feed(s, x, now, now_ns=now)


@pytest.mark.parametrize("keep", [[2, 0], None, [1, 2, 0]])
def test_resized_carries_state_like_jax(keep):
    cfg = resolve(Settings(fft_size=1024, width=300, normalize_volume=True),
                  AudioInfo(SR, 2))
    S, S2 = 3, 4
    rng = np.random.default_rng(41)
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False)
    now = NS
    for _ in range(5):
        _feed((port, ref), S, rng, now, silent=(1,))
        now += 10_000_000
        for eng in (port, ref):
            eng.tick(now_ns=now)
    old_db, old_ring = port.read_decibels(), port.ring.buf.clone()
    port2, ref2 = port.resized(S2, keep), ref.resized(S2, keep)
    rows = keep if keep is not None else list(range(S))
    k = len(rows)
    np.testing.assert_array_equal(port2.read_decibels()[:k], old_db[rows])
    np.testing.assert_array_equal(port2.ring.buf[:k].numpy(),
                                  old_ring[rows].numpy())
    assert (port2.read_decibels()[k:] == np.float32(DB_MIN)).all()
    assert not port2.ring.buf[k:].any()
    _assert_same_state(port2, ref2)
    for _ in range(3):
        _feed((port2, ref2), S2, rng, now)
        now += 10_000_000
        for eng in (port2, ref2):
            eng.tick(now_ns=now)
        _assert_same(port2, ref2)


def _assert_same_state(port, ref):
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    got, want = port.read_decibels(), ref.read_decibels()
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[want == np.float32(DB_MIN)],
                                  want[want == np.float32(DB_MIN)])


@pytest.mark.parametrize("S2,keep", [(4, [0, 9]), (4, [-1]),
                                     (1, [0, 1])])
def test_resized_refuses_bad_keep_like_jax(S2, keep):
    cfg = resolve(Settings(fft_size=512), AudioInfo(SR, 2))
    port = ServingEngine(cfg, 4, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), 4, use_native=False)
    msgs = []
    for eng in (port, ref):
        with pytest.raises(ValueError) as err:
            eng.resized(S2, keep=keep)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_resized_native_sync_survives():
    """resized() migrates the native assembler's per-stream sync, so
    surviving streams stay ACTIVE across the swap instead of reading
    capture_ts=0 and decaying as timed out; the JAX engine agrees."""
    cfg = resolve(Settings(fft_size=1024,
                           temporal_smoothing=TSmoothingMode.NONE),
                  AudioInfo(SR, 2))
    port = ServingEngine(cfg, 2, use_native=None, device="cpu")
    if port._native is None:
        pytest.skip("no C++ toolchain for the native assembler")
    ref = JaxEngine(_jax_cfg(cfg), 2, use_native=True)
    now, ph = NS, 0
    for _ in range(20):
        t = (np.arange(800) + ph) / SR
        ph += 800
        x = np.sin(2 * np.pi * 1125.0 * t).astype(np.float32)
        for eng in (port, ref):
            for s in range(2):
                eng.feed(s, np.stack([x, x]), now, now_ns=now)
        now += 800 * NS // SR
        for eng in (port, ref):
            eng.tick(now_ns=now)
    assert port.read_decibels().max() > -2
    port2, ref2 = port.resized(3), ref.resized(3)
    assert port2._native.get_sync(1) == port._native.get_sync(1)
    # tick WITHOUT feeding, inside the 500 ms capture window
    for eng in (port2, ref2):
        eng.tick(now_ns=now + 10_000_000)
    # (a pure tone: bins far below it differ between the two FFT
    # libraries by more than 1e-4 dB, so the peaks and latches are held)
    for eng in (port2, ref2):
        db = eng.read_decibels()
        assert db[0].max() > -2 and db[1].max() > -2
        assert (db[2] == np.float32(DB_MIN)).all()
    np.testing.assert_allclose(port2.read_decibels().max(-1),
                               ref2.read_decibels().max(-1), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(port2.last_silent, ref2.last_silent)
