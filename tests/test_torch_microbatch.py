"""Microbatching of the port's ServingEngine against the JAX engine's.

``microbatch=k`` accumulates k assembled ticks and runs them as one flush
(on a card one captured graph of k packed ticks; here the same packed
ticks eagerly).  Each case feeds the same numpy-seeded packets to the
port at k, the port at k=1 and the JAX engine at k, all under
``WAVEFORM_TPU_FFT_BACKEND=xla`` (the engines' mechanics are the point;
``tests/test_torch_backends.py`` holds the two xla steps together): the
port's k-flush is bit for bit its k=1 ticks, and within 1e-4 dB of the
JAX engine (exactly where it reads DB_MIN), latches exact.
"""

import numpy as np
import pytest
import torch

from waveform_tpu.runtime import serving as jserving
from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import (
    AudioInfo,
    FFTWindow,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.runtime import serving as tserving
from waveform_tpu_torch.runtime.serving import ServingEngine

from test_torch_serving import _assert_same, _jax_cfg

SR, NS = 48000, 1_000_000_000


@pytest.fixture(autouse=True)
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def _cfg(**kw):
    return resolve(Settings(fft_size=1024, width=300, window=FFTWindow.HANN,
                            **kw), AudioInfo(SR, 2))


def _packets(S, T, seed, per_stream=False):
    """T ticks of [S, 2, frames] packets (uneven per stream when
    ``per_stream``: the per-stream count form); stream S-1 silent."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(T):
        frames = [480 + (37 * s if k % 2 else -37 * s) * per_stream
                  for s in range(S)]
        out.append([(0.4 * rng.standard_normal((2, n))).astype(np.float32)
                    * (s != S - 1) for s, n in enumerate(frames)])
    return out


def _drive(eng, pkts, dts=None, per_stream=False):
    """Feed and tick every packet set; returns each tick's host pixels
    (None while a microbatch is filling)."""
    now = NS
    outs = []
    for k, pk in enumerate(pkts):
        if per_stream:
            for s, x in enumerate(pk):
                eng.feed(s, x, now, now_ns=now)
        else:
            eng.feed_batch(np.stack(pk), now, now_ns=now)
        now += 480 * NS // SR
        px = eng.tick(now_ns=now, dt=None if dts is None else dts[k])
        outs.append(None if px is None else np.array(px))
    return outs


@pytest.mark.parametrize("per_stream", [False, True])
def test_microbatch_matches_jax_and_single_ticks(per_stream):
    """k=3 against JAX k=3 and the port's own k=1 bit for bit: every
    flush's ``last_batch_pixels`` holds the k=1 engine's three frames."""
    cfg = _cfg(normalize_volume=per_stream)
    S, T, k = 3, 9, 3
    pkts = _packets(S, T, 11 + per_stream, per_stream)
    one = ServingEngine(cfg, S, use_native=False, device="cpu")
    mb = ServingEngine(cfg, S, use_native=False, microbatch=k, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False, microbatch=k)
    singles = _drive(one, pkts, per_stream=per_stream)
    now = NS
    for t, pk in enumerate(pkts):
        for eng in (mb, ref):
            if per_stream:
                for s, x in enumerate(pk):
                    eng.feed(s, x, now, now_ns=now)
            else:
                eng.feed_batch(np.stack(pk), now, now_ns=now)
        now += 480 * NS // SR
        for eng in (mb, ref):
            eng.tick(now_ns=now)
        if (t + 1) % k == 0:
            batch = mb.last_batch_pixels
            assert tuple(batch.shape) == (k, S, 1, 300)
            for i in range(k):
                np.testing.assert_array_equal(batch[i].numpy(),
                                              singles[t + 1 - k + i])
            _assert_same(mb, ref)
    assert mb.last_silent[S - 1] and not mb.last_silent[:S - 1].any()


def test_microbatch_exact_kernel_matches_jax(monkeypatch):
    """One case on the exact FFT: the port's K1-gen twin against the JAX
    kernel in interpret mode (as tests/test_torch_serving.py runs it), k=2
    at S=2, N=1024."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    cfg = _cfg()
    S, k = 2, 2
    pkts = _packets(S, 4, 12)
    one = ServingEngine(cfg, S, use_native=False, device="cpu")
    mb = ServingEngine(cfg, S, use_native=False, microbatch=k, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False, microbatch=k)
    singles = _drive(one, pkts)
    _drive(mb, pkts)
    _drive(ref, pkts)
    np.testing.assert_array_equal(mb.last_batch_pixels[0].numpy(),
                                  singles[-2])
    np.testing.assert_array_equal(mb.read_pixels(), singles[-1])
    _assert_same(mb, ref)


def test_microbatch_per_frame_dt():
    """Each accumulated tick keeps its own dt: under the time-varying EMA
    k=4 fed jittery frame times equals k=1 ticks fed the same dts bit for
    bit, and the JAX k=4 engine within 1e-4 dB."""
    cfg = _cfg(temporal_smoothing=TSmoothingMode.TVEXPONENTIAL)
    S, k = 3, 4
    dts = [1 / 60, 1 / 20, 1 / 60, 1 / 30, 1 / 75, 1 / 60, 1 / 25, 1 / 50]
    pkts = _packets(S, len(dts), 13)
    one = ServingEngine(cfg, S, use_native=False, device="cpu")
    mb = ServingEngine(cfg, S, use_native=False, microbatch=k, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False, microbatch=k)
    singles = _drive(one, pkts, dts)
    _drive(mb, pkts, dts)
    _drive(ref, pkts, dts)
    np.testing.assert_array_equal(mb.read_pixels(), singles[-1])
    np.testing.assert_array_equal(mb.last_batch_pixels[0].numpy(),
                                  singles[-4])
    _assert_same(mb, ref)


def test_microbatch_frames_are_their_own():
    """The flushed frames and the pixels a tick returned stay as they were
    after later ticks (a captured graph's output buffers are rewritten by
    each replay; the engine hands out copies)."""
    cfg = _cfg()
    S, k = 2, 2
    eng = ServingEngine(cfg, S, use_native=False, microbatch=k, device="cpu")
    pkts = _packets(S, 6, 17)
    now = NS
    kept = []
    for t, pk in enumerate(pkts):
        eng.feed_batch(np.stack(pk), now, now_ns=now)
        now += 480 * NS // SR
        px = eng.tick(now_ns=now)
        if (t + 1) % k == 0:
            kept.append((px, px.clone(), eng.last_batch_pixels,
                         eng.last_batch_pixels.clone()))
    assert not torch.equal(kept[0][2][0], kept[0][2][1])
    for px, px0, batch, batch0 in kept:
        assert torch.equal(px, px0) and torch.equal(batch, batch0)


CASES = [(1 / 60, 0.0001, 0.002), (1 / 60, 0.030, 0.035),
         (1 / 60, 0.010, 0.015), (1 / 60, 0.037, 0.095),
         (1 / 60, 10.0, 10.1), (1 / 60, 0.1, 0.32), (1 / 60, 0.1, 0.26),
         (1 / 120, 0.004, 0.012), (1 / 30, 0.02, 0.05), (1 / 60, 0.0, 0.02)]


@pytest.mark.parametrize("budget,rtt,tick", CASES)
def test_policy_matches_jax(budget, rtt, tick):
    """``choose_microbatch`` and ``validate_flush`` on one grid: the port's
    copies give the JAX package's answers."""
    for mb_max in (4, 8):
        assert (tserving.choose_microbatch(budget, rtt, tick, mb_max)
                == jserving.choose_microbatch(budget, rtt, tick, mb_max))
    for k in (2, 4, 8):
        flushes = [9.9, k * tick * 0.7, k * tick * 0.9, k * (tick - rtt)]
        assert (tserving.validate_flush(flushes, k, tick, budget)
                == jserving.validate_flush(flushes, k, tick, budget))


@pytest.mark.parametrize("forced", [None, 4])
def test_auto_resolves_with_link_rtt_monkeypatched(forced, monkeypatch):
    """``microbatch="auto"``: after the probe ticks the engine asks
    ``link_rtt`` once (monkeypatched to a fixed 30 ms) and resolves k by
    the policy; a candidate forced to 4 is validated against measured
    flushes and then locks (or steps down).  Either way the frames equal
    the k=1 engine's bit for bit at the end of a flush."""
    calls = []

    def fake_rtt(device):
        calls.append(device)
        return 0.030

    monkeypatch.setattr(tserving, "link_rtt", fake_rtt)
    if forced:
        monkeypatch.setattr(ServingEngine, "_choose_microbatch",
                            lambda self, budget, rtt, tick: forced)
    cfg = _cfg(temporal_smoothing=TSmoothingMode.NONE)
    S = 2
    auto = ServingEngine(cfg, S, use_native=False, microbatch="auto",
                         device="cpu")
    pkts = _packets(S, 40, 19)
    t = 0
    now = NS
    while t < len(pkts) and (auto._mb_auto or auto._mb_fill):
        auto.feed_batch(np.stack(pkts[t]), now, now_ns=now)
        now += 480 * NS // SR
        auto.tick(now_ns=now)
        t += 1
    assert not auto._mb_auto and auto._mb_fill == 0
    assert calls == [torch.device("cpu")]
    if forced is None:
        assert auto.microbatch == tserving.choose_microbatch(
            1 / cfg.fps, 0.030, auto._probe_tick)
    else:
        assert auto.microbatch in (1, 2, 4)
        if auto.microbatch > 1:
            assert auto.microbatch_completion is not None
    one = ServingEngine(cfg, S, use_native=False, device="cpu")
    singles = _drive(one, pkts[:t])
    np.testing.assert_array_equal(auto.read_pixels(), singles[-1])
