"""The port's own tracing (``runtime/profiler.py``) on the CPU: the switch,
the host spans inside ``ServingEngine``'s tick, the stage marks of the
eager tick, the counters, the set-up timers, the stamped replays' reading
and the idle-gap arithmetic.  The card's half (the stamped twin of a
captured graph) is in ``tests/test_torch_cuda.py``."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waveform_tpu_torch import (AudioInfo, FFTWindow, InterpMode, Settings,
                                 resolve)
from waveform_tpu_torch.runtime import profiler
from waveform_tpu_torch.runtime.serving import ServingEngine

STAGES = ["tick.push", "tick.fft", "tick.tail", "tick.rebin"]
SPANS = ["serving.stage", "serving.upload", "serving.replay"]
S, HOP, FFT = 4, 800, 1024


@pytest.fixture(autouse=True)
def clean_registry():
    """Each test starts with the switch off and an empty registry."""
    profiler.set_tracing(False)
    profiler.reset()
    yield
    profiler.set_tracing(False)
    profiler.reset()


def _engine():
    cfg = resolve(Settings(fft_size=FFT, width=64, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, 2))
    return ServingEngine(cfg, S, device="cpu")


def _packet(k):
    t = (np.arange(HOP) + HOP * k) / 48000
    x = np.sin(2 * np.pi * 440 * t) * (1 + np.arange(S))[:, None] / S
    return np.stack([x, 0.5 * x], axis=1).astype(np.float32)   # [S, 2, HOP]


def _drive(eng, ticks, mode, k0=0):
    """``ticks`` ticks of one traffic form; returns (pixels, feed calls,
    per-tick uniform flags as the engine's staged counts say)."""
    pixels, feeds, uniform = [], 0, []
    for k in range(k0, k0 + ticks):
        now = 1_000_000_000 + k * 16_666_667
        x = _packet(k)
        if mode == "batch":
            eng.feed_batch(x, now, now_ns=now)
            feeds += 1
        else:   # every stream, but only stream 0 every third tick
            for s in range(S) if k % 3 != 2 else (0,):
                eng.feed(s, x[s], now, now_ns=now)
                feeds += 1
        px = eng.tick(now_ns=now)      # None before a first flush
        pixels.append(None if px is None else px.clone())
        counts = eng._meta_buf[:, 0]
        uniform.append(bool((counts == counts[0]).all()))
    return pixels, feeds, uniform


@pytest.mark.parametrize("switch", ["profiler", "set_tracing"])
@pytest.mark.parametrize("mode", ["batch", "mixed"])
def test_tick_records_spans_marks_and_push_counts(mode, switch):
    """8 ticks under a recording profiler, or with the operator's switch
    on, record the tick's host spans and its four stages 8 times each,
    the stages in their order, one feed span a feed call, and which push
    each tick took; nothing more once the switch is off."""
    eng = _engine()
    _drive(eng, 2, mode)                  # off: records nothing
    assert profiler.snapshot()["spans"] == {}
    if switch == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, feeds, uniform = _drive(eng, 8, mode, k0=2)
        names = [ev.name for ev in prof.events()]
        for name in SPANS:
            assert names.count(profiler.PREFIX + name) == 8
    else:
        profiler.set_tracing(True)
        _, feeds, uniform = _drive(eng, 8, mode, k0=2)
        profiler.set_tracing(False)
    snap = profiler.snapshot()
    assert {n: s["count"] for n, s in snap["spans"].items()} == {
        **{n: 8 for n in SPANS}, "serving.feed": feeds}
    assert list(snap["marks"]) == STAGES
    for name in STAGES:
        m = snap["marks"][name]
        assert m["count"] == 8 and 0 < m["max_us"] <= m["total_us"]
    n_uniform = sum(uniform)
    assert snap["counters"].get("ticks.uniform", 0) == n_uniform
    assert snap["counters"].get("ticks.gather", 0) == 8 - n_uniform
    if mode == "batch":
        assert n_uniform == 8
    else:
        assert 0 < n_uniform < 8
    _drive(eng, 2, mode, k0=10)
    assert profiler.snapshot() == snap


def test_tracing_leaves_the_pixels_bit_for_bit():
    """The same packets through two engines, one traced: the same pixels."""
    plain, traced = _engine(), _engine()
    want, _, _ = _drive(plain, 6, "batch")
    profiler.set_tracing(True)
    got, _, _ = _drive(traced, 6, "batch")
    assert profiler.snapshot()["marks"]["tick.rebin"]["count"] == 6
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_off_means_off(monkeypatch):
    """With tracing off a span site hands back the shared no-op context,
    and the tick path makes no profiler range, no CUDA event and no
    ``perf_counter_ns`` call."""
    assert not profiler.on
    assert profiler.span("serving.stage") is profiler.span("x") \
        is profiler._OFF
    eng = _engine()
    calls = []

    def counted(name, real):
        def f(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return f

    monkeypatch.setattr(time, "perf_counter_ns",
                        counted("perf_counter_ns", time.perf_counter_ns))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted(
        "range", torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted(
        "record_function", torch.autograd.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event", counted("event",
                                                     torch.cuda.Event))
    _drive(eng, 3, "batch")
    _drive(eng, 3, "mixed", k0=3)
    assert calls == []
    snap = profiler.snapshot()
    assert (snap["spans"], snap["marks"], snap["counters"]) == ({}, {}, {})


def test_setup_timers_stay_on():
    """Building an engine times its library load though tracing is off;
    the CPU captures no graph."""
    _engine()
    snap = profiler.snapshot()
    assert snap["setup"]["library.native"]["count"] == 1
    assert "graph.capture" not in snap["setup"]
    assert "graph.captures" not in snap["counters"]


def test_microbatch_flush_records_each_tick():
    """A flush of k = 2 ticks runs the tick's function twice: its stages
    twice, its pushes counted as 2 ticks (each staged by one native call
    where the native assembler is loaded); each tick's ``feed_batch``
    counts its S packets."""
    cfg = resolve(Settings(fft_size=FFT, width=64), AudioInfo(48000, 2))
    eng = ServingEngine(cfg, S, microbatch=2, device="cpu")
    profiler.set_tracing(True)
    _drive(eng, 4, "batch")
    snap = profiler.snapshot()
    native = {"ticks.native": 4} if eng._native is not None else {}
    assert snap["counters"] == {"ticks.uniform": 4, "feed.packets": 4 * S,
                                **native}
    assert [snap["marks"][n]["count"] for n in STAGES] == [4, 4, 4, 4]


def test_profiler_state_check_is_pinned():
    """The private check the switch reads, and the function-scope range a
    span opens, behave as the profiler relies on."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert not profiler.profiling()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert profiler.profiling() and profiler.refresh()
        with profiler.span("pinned"):
            torch.ones(4).sum()
    assert not profiler.profiling() and not profiler.refresh()
    ranges = [ev for ev in prof.events() if ev.name == "waveform.pinned"]
    assert len(ranges) == 1 and ranges[0].time_range.end > \
        ranges[0].time_range.start
    assert profiler.snapshot()["spans"]["pinned"]["count"] == 1


@pytest.mark.parametrize("seq,want", [
    ([("tick", 0), ("a", 3), ("b", 7)], [("a", 0, 3), ("b", 3, 7)]),
    # before the first OPEN nothing is a stage; a pair ending in OPEN
    # is none either (a flush's next tick)
    ([("x", 0), ("a", 1), ("tick", 2), ("a", 5), ("tick", 9), ("b", 10)],
     [("a", 2, 5), ("b", 9, 10)]),
    ([("tick", 0)], []),
    ([], []),
])
def test_stages_of_a_mark_sequence(seq, want):
    assert profiler.stages(seq) == want


class _Event:
    """A stand-in for a CUDA timing event: a time in ms and completion."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_stamped_replays_are_read_without_waiting():
    """A stamped replay is read before the next one when its events have
    completed, and counted in ``marks.missed`` when they have not;
    ``snapshot`` reads what has completed and leaves the rest."""
    profiler.set_tracing(True)
    st = profiler.Stamps()
    st.seq = [("tick", _Event(0.0)), ("tick.push", _Event(0.002)),
              ("tick.fft", _Event(0.005))]
    st.replaying()                     # first replay: nothing to read
    st.replaying()                     # the first has completed: read
    marks = profiler.snapshot()["marks"]   # reads the second
    assert marks["tick.push"]["count"] == 2
    assert marks["tick.fft"]["total_us"] == pytest.approx(6.0)
    st.seq[-1][1].done = False
    st.replaying()
    assert profiler.snapshot()["marks"]["tick.push"]["count"] == 2
    st.replaying()                     # still not complete: missed
    snap = profiler.snapshot()
    assert snap["counters"]["marks.missed"] == 1
    st.seq[-1][1].done = True
    assert profiler.snapshot()["marks"]["tick.push"]["count"] == 3


def test_idle_gaps_go_to_the_innermost_range():
    """Hand-made intervals: each gap between device operations goes whole
    to the innermost range that overlaps it most, else to the caller."""
    device = [("k", 10, 20), ("k", 18, 30), ("k", 60, 70), ("k", 90, 95)]
    ranges = [("serving.replay", 5, 100),      # the outer range
              ("serving.stage", 32, 45),       # inner, in gap (30, 60)
              ("serving.upload", 45, 58),
              ("serving.feed", 71, 75)]        # inner, 4 of gap (70, 90)
    got = profiler.idle_by_span(device, ranges, 0, 110)
    # (0, 10): 5 under replay, 5 under none -> replay (the only range);
    # (30, 60): stage 13, upload 13, replay 4 -> stage, the first of a tie;
    # (70, 90): replay 16, feed 4 -> replay; (95, 110): replay 5
    assert got == {"serving.replay": 10 + 20 + 15, "serving.stage": 30}
    assert profiler.idle_by_span(device, [], 0, 110) == {profiler.CALLER: 75}
    # the innermost of two nested ranges takes the time under both
    assert profiler.idle_by_span([], [("outer", 0, 10), ("inner", 2, 8)],
                                 0, 10) == {"inner": 10}
    assert profiler._innermost([("outer", 0, 10), ("inner", 2, 8)]) == [
        ("outer", 0, 2), ("inner", 2, 8), ("outer", 8, 10)]


def test_device_summary_reads_program_ranges_from_the_trace():
    """``device_summary`` on a stand-in trace: the busy union and the
    operation table as before, and the window's idle time (first to last
    event) put down to the ``waveform.*`` host ranges, the rest to the
    caller."""
    from types import SimpleNamespace as NS
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, a, b, dev):
        return NS(name=name, device_type=dev, time_range=NS(start=a, end=b))

    prof = NS(events=lambda: [
        ev("loop", 0, 100, cpu), ev("waveform.serving.stage", 5, 20, cpu),
        ev("k1", 20, 40, cuda), ev("k2", 30, 50, cuda),
        ev("k1", 60, 70, cuda)])
    assert profiler.device_summary(prof, 100e-6) == {
        "busy_us": 40, "busy_share": pytest.approx(0.4),
        "kernels": {"k1": (2, 30.0), "k2": (1, 20.0)},
        "idle_by_span": {"serving.stage": 20.0, profiler.CALLER: 40.0}}
