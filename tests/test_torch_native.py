"""The port's native stage: one call into the C++ assembler
(``NativeAssembler.stage_packed``) writes a tick's packed rows, its
scalars and its count form.  Held byte for byte against the same stage in
pieces (``_assemble`` on the same assembler, ``_uniform_count`` and
``gravity_pair`` in Python) on the same packets."""

import numpy as np
import pytest

import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp.spectrum import gravity_pair
from waveform_tpu_torch.native import load_library
from waveform_tpu_torch.runtime import profiler, serving
from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
from waveform_tpu_torch.runtime.serving import ServingEngine

pytestmark = pytest.mark.skipif(load_library() is None,
                                reason="native toolchain unavailable")

NS, SR, S = 1_000_000_000, 48000, 4


def _engines(traffic, native=(True, True)):
    """Two CPU engines (the meter engine for the meter layout), S = 4 at
    N = 1024, on the native assembler or not as ``native`` says."""
    if traffic == "meter":
        cfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER,
                                     meter_buf=100), wt.AudioInfo(SR, 2))
        make = MeterServingEngine
    else:
        cfg = wt.resolve(wt.Settings(fft_size=1024,
                                     normalize_volume=traffic == "normalize"),
                         wt.AudioInfo(SR, 2))
        make = ServingEngine
    return [make(cfg, S, use_native=n, device="cpu") for n in native]


def _feed(engines, traffic, rng, k, now):
    """One tick's packets into every engine: one ``feed_batch``, or one
    ``feed`` a stream of equal or (``unequal``) stream-dependent length;
    stream 1 muted in every third tick."""
    n = 800 if k % 4 else 0
    x = (0.4 * rng.standard_normal((S, 2, n))).astype(np.float32)
    for eng in engines:
        if traffic == "batch":
            eng.feed_batch(x, now, now_ns=now)
            continue
        for s in range(S):
            m = n - 37 * s if traffic == "unequal" else n
            eng.feed(s, x[s, :, :m], now, now_ns=now,
                     muted=(s == 1 and k % 3 == 0))


def _stage_in_pieces(eng, now, dt):
    """The stage as separate steps on the bound upload: the assembler's
    rows, then the count form and the scalars in Python."""
    eng._assemble(now)
    uniform, c0 = eng._uniform_count()
    eng._tail[:2] = gravity_pair(eng.cfg, dt)
    eng._tail[2] = c0
    return uniform


@pytest.mark.parametrize("traffic", ["batch", "equal", "unequal",
                                     "normalize", "meter"])
def test_native_stage_matches_the_stage_in_pieces(traffic, rng):
    """``_stage`` on the native assembler (one call: rows, scalars, the
    count form) against the same stage in pieces on the same packets:
    the same upload byte for byte and the same uniform flag, tick after
    tick, with ``dt`` changing between ticks."""
    ref, nat = _engines(traffic)
    now = 10 * NS
    forms = set()
    for k in range(12):
        now += 16_666_667
        _feed((ref, nat), traffic, rng, k, now)
        dt = 1.0 / 60 if k < 7 else 1.0 / 30
        for eng in (ref, nat):
            eng._flip ^= 1
            eng._bind_buf(eng._flip)
        want = _stage_in_pieces(ref, now, dt)
        got = nat._stage(now, dt)
        assert got is want, k
        forms.add(got)
        a, b = ref._host[ref._flip].numpy(), nat._host[nat._flip].numpy()
        assert a.tobytes() == b.tobytes(), k
    assert forms == ({False, True} if traffic == "unequal" else {True})


def test_native_stage_is_not_uniform_across_processes(rng, monkeypatch):
    """With more than one ``torch.distributed`` process every tick takes
    the gather form, as ``_uniform_count`` rules (each process sees only
    its own rows' counts); the rows are the same."""
    monkeypatch.setattr(serving, "process_count", lambda: 2)
    ref, nat = _engines("batch")
    now = 10 * NS
    for k in range(1, 4):
        now += 16_666_667
        _feed((ref, nat), "batch", rng, k, now)
        for eng in (ref, nat):
            eng._bind_buf(0)
        assert _stage_in_pieces(ref, now, 1.0 / 60) is False
        assert nat._stage(now, 1.0 / 60) is False
        a, b = ref._host[0].numpy(), nat._host[0].numpy()
        assert a[:-1].tobytes() == b[:-1].tobytes(), k


def test_native_stage_counts_its_ticks(rng):
    """Each tick staged by one native call counts as ``ticks.native``; an
    engine on the pure-Python assembly counts none.  Both give the same
    pixels."""
    nat, py = _engines("batch", native=(True, False))
    assert nat._native is not None and py._native is None
    seen = {}
    for eng in (nat, py):
        profiler.set_tracing(True)
        profiler.reset()
        run = np.random.default_rng(7)
        try:
            pixels = []
            for k in range(1, 4):
                now = 10 * NS + k * 16_666_667
                _feed((eng,), "batch", run, k, now)
                pixels.append(np.asarray(eng.tick(now_ns=now)))
            seen[eng] = (pixels, profiler.snapshot()["counters"])
        finally:
            profiler.set_tracing(False)
            profiler.reset()
    (pa, ca), (pb, cb) = seen[nat], seen[py]
    assert ca.get("ticks.native") == 3 and ca.get("ticks.uniform") == 3
    assert "ticks.native" not in cb and cb.get("ticks.uniform") == 3
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a, b)
