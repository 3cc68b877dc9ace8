"""``tick_many`` of the port's ServingEngine against the JAX engine's.

Bulk mode: [T, S, C, hop] samples through T ticks (on a card T replays of
one captured bulk tick; here the same tick eagerly).  Both engines take
the same numpy-seeded samples under ``WAVEFORM_TPU_FFT_BACKEND=xla``;
pixels [T, S, D, P] and the final decibels agree within 1e-4 dB (exactly
where the reference reads DB_MIN), latches exactly.
"""

import numpy as np
import pytest

from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import AudioInfo, FFTWindow, Settings, resolve
from waveform_tpu_torch.runtime.serving import ServingEngine

from test_torch_serving import _assert_same, _jax_cfg

SR = 48000


@pytest.fixture(autouse=True)
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def _close(got, want):
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)


@pytest.mark.parametrize("form", ["default", "uniform", "per_stream"])
def test_tick_many_matches_jax(form):
    """Default counts (a uniform hop, every stream active), a [T] count
    vector, and [T, S] counts with an [T, S] active mask; volume
    normalization on, so the RMS ring takes the squares of the raw
    samples."""
    cfg = resolve(Settings(fft_size=1024, width=300, window=FFTWindow.HANN,
                           normalize_volume=True), AudioInfo(SR, 2))
    T, S, hop = 5, 3, 480
    rng = np.random.default_rng(31)
    new = (0.4 * rng.standard_normal((T, S, 2, hop))).astype(np.float32)
    new[:, -1] = 0.0
    kw = {}
    if form == "uniform":
        kw["counts"] = np.array([hop, 300, hop, 0, 200], np.int32)
    elif form == "per_stream":
        kw["counts"] = rng.integers(0, hop + 1, (T, S)).astype(np.int32)
        active = np.ones((T, S), bool)
        active[3:, 1] = False
        kw["active"] = active
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False)
    got = port.tick_many(new, dt=1 / 50, **kw)
    want = np.asarray(ref.tick_many(new, dt=1 / 50, **kw))
    assert tuple(got.shape) == want.shape == (T, S, 1, 300)
    _close(got.numpy(), want)
    _assert_same(port, ref)
    assert port.last_silent[-1]
    if form == "per_stream":
        assert port.last_silent[1]


def test_tick_many_continues_a_live_engine():
    """tick_many after live ticks continues the same ring and state, and
    its frames are T distinct tensors; a later live tick continues from
    the bulk run, as in the JAX engine."""
    cfg = resolve(Settings(fft_size=1024, width=200), AudioInfo(SR, 2))
    S, T, hop = 2, 4, 480
    rng = np.random.default_rng(32)
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False)
    now = 10_000_000_000
    for _ in range(3):
        x = (0.4 * rng.standard_normal((S, 2, hop))).astype(np.float32)
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
        now += 10_000_000
    new = (0.4 * rng.standard_normal((T, S, 2, hop))).astype(np.float32)
    got = port.tick_many(new)
    want = np.asarray(ref.tick_many(new))
    _close(got.numpy(), want)
    assert all(not np.array_equal(got[t].numpy(), got[t + 1].numpy())
               for t in range(T - 1))
    x = (0.4 * rng.standard_normal((S, 2, hop))).astype(np.float32)
    for eng in (port, ref):
        eng.feed_batch(x, now, now_ns=now)
        eng.tick(now_ns=now)
    _assert_same(port, ref)
