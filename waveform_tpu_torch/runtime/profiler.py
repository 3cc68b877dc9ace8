"""Frame profiler: throughput, latency percentiles, and the FFTW MFLOPS metric.

The PyTorch counterpart of ``waveform_tpu/runtime/profiler.py``.  FFTW's
harness reports MFLOPS = 5·N·log2(N)/t for complex transforms,
2.5·N·log2(N)/t for real ones (reference deps/fftw-3.3.11/libbench2/
mflops.c:20-27); the same definitions are kept, plus the serving metrics
the plugin never had: frames/s and p50/p99 tick latency.

:func:`trace` captures a ``torch.profiler`` window (CPU and CUDA
activity); :func:`device_summary` reads a finished window: the device's
busy share of the window's wall time and each device operation's (a
kernel's, a copy's, a fill's) time and count by name, and the window's
idle time put down to the program's ranges.

The program's own tracing lives here too, in one registry that
:func:`snapshot` reads and :func:`reset` clears:

* **spans** (:func:`span`): host stretches of the served tick, each
  ``(count, total, max)`` on ``time.perf_counter_ns``; while a
  ``torch.profiler`` records, each also opens a ``waveform.<name>`` range,
  so it lands in the same trace as the device operations;
* **marks** (:func:`mark`): points inside the tick's device function; the
  stage between two marks is named by the later one and timed on the host
  clock where the function runs eagerly (the CPU), on the device clock
  inside a captured graph's stamped twin (``runtime/graphs.py``);
* **counters** (:func:`count`): per-tick counts, and ``graph.captures``
  by tick kind;
* **set-up timers** (:func:`setup`): library builds and loads and graph
  captures, once an engine.

Tracing is on while a ``torch.profiler`` records in this process
(:func:`refresh` reads that at every tick and feed call), or after
``set_tracing(True)`` / ``WAVEFORM_TPU_TRACE=1`` (read at import).  Off,
a span site costs one test of the module flag :data:`on` and returns a
shared no-op context, and a captured tick replays its plain graph.  The
set-up timers and the capture counter are always on.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "waveform."     # the program's profiler ranges
OPEN = "tick"            # the mark that opens a tick: it ends no stage
CALLER = "caller"        # idle time under none of the program's ranges

_forced = os.environ.get("WAVEFORM_TPU_TRACE", "0") not in ("", "0")
on = _forced             # tracing: read at every span site
_recording = False       # a torch.profiler records: spans open ranges
_sink = None             # where a mark goes inside a tick's function
_spans: dict = {}        # name -> [count, total ns, max ns]
_marks: dict = {}        # name -> [count, total us, max us]
_counters: dict = {}     # name -> count; "graph.captures" -> {kind: n}
_setup: dict = {}        # name -> [count, total s]
_unread: set = set()     # stamped replays not read yet
_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process (the private
    flag ``torch.autograd.profiler._is_profiler_enabled``, which
    ``tests/test_torch_trace.py`` pins)."""
    return _autograd_profiler._is_profiler_enabled


def refresh() -> bool:
    """Read at each entry into an engine (a tick, a feed call): tracing is
    on while a profiler records or after ``set_tracing(True)``."""
    global on, _recording
    _recording = profiling()
    on = _forced or _recording
    return on


def set_tracing(enabled: bool) -> None:
    """Turn the operator's switch on or off (``WAVEFORM_TPU_TRACE=1`` sets
    it at import); a recording profiler turns tracing on regardless."""
    global _forced
    _forced = bool(enabled)
    refresh()


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _recording:
            # a function-scope range: it lands in the trace beside the
            # device operations, and leaves no device-side annotation
            self.rf = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _add(_spans, self.name, dt)
        return False


def _add(table: dict, name: str, value) -> None:
    s = table.get(name)
    if s is None:
        table[name] = [1, value, value]
    else:
        s[0] += 1
        s[1] += value
        if value > s[2]:
            s[2] = value


def span(name: str):
    """A context that times its block as span ``name`` while tracing is
    on; off, the shared no-op context."""
    if not on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to per-tick counter ``name`` while tracing is on."""
    if on:
        _counters[name] = _counters.get(name, 0) + n


def captured(kind) -> None:
    """Count one graph capture of tick kind ``kind`` (always on)."""
    by = _counters.setdefault("graph.captures", {})
    key = ",".join(map(str, kind)) if isinstance(kind, tuple) else str(kind)
    by[key] = by.get(key, 0) + 1


@contextlib.contextmanager
def setup(name: str):
    """Time a set-up phase (a library build or load, a graph capture):
    always on, once an engine, never a tick."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = _setup.setdefault(name, [0, 0.0])
        s[0] += 1
        s[1] += time.perf_counter() - t0


# -- marks ------------------------------------------------------------------

def mark(name: str) -> None:
    """A point inside a tick's device function (``runtime/graphs.GraphTick``
    decides what it records: a host time on the CPU while tracing is on,
    a timing event in a captured graph's stamped twin, nothing in its
    plain graph or outside a tick).  ``mark(OPEN)`` opens a tick; every
    later mark ends the stage it names."""
    if _sink is not None:
        _sink(name)


@contextlib.contextmanager
def marking(sink):
    """Send the block's marks to ``sink(name)``."""
    global _sink
    was, _sink = _sink, sink
    try:
        yield
    finally:
        _sink = was


def stages(seq) -> list:
    """``(name, a, b)`` of each stage of a sequence of ``(name, t)`` marks:
    consecutive marks after the first :data:`OPEN`, named by the later
    one; a pair that ends in ``OPEN`` is no stage."""
    out, opened = [], bool(seq) and seq[0][0] == OPEN
    for (_, a), (name, b) in zip(seq, seq[1:]):
        if name == OPEN:
            opened = True
        elif opened:
            out.append((name, a, b))
    return out


def host_marks(fn):
    """Run ``fn()`` with its marks on the host clock; record its stages."""
    seq: list = []
    with marking(lambda name: seq.append((name, time.perf_counter_ns()))):
        out = fn()
    for name, a, b in stages(seq):
        _add(_marks, name, (b - a) / 1e3)
    return out


class Stamps:
    """The timing events of one stamped twin (a captured graph whose marks
    record events): :meth:`stamp` makes them while the twin is captured;
    each replay re-records them, and the previous replay is read before
    the next one (:meth:`replaying`) or by :func:`snapshot`, never by
    waiting for the device."""

    def __init__(self):
        self.seq: list = []

    def stamp(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.seq.append((name, ev))

    def replaying(self) -> None:
        """Before a replay: read the last one, or count it missed (its
        events would be recorded anew before anyone read them)."""
        if self in _unread and not self.read():
            _unread.discard(self)
            count("marks.missed")
        _unread.add(self)

    def read(self) -> bool:
        """Fold the last replay's stages into the marks if its events have
        completed (``query``; no wait); whether they had."""
        if not self.seq[-1][1].query():
            return False
        _unread.discard(self)
        for name, a, b in stages(self.seq):
            _add(_marks, name, a.elapsed_time(b) * 1e3)
        return True


def snapshot() -> dict:
    """The registry: ``spans`` and ``marks`` {name: {count, total_us,
    max_us}} (a mark's stage on the device clock where a graph ran it),
    ``counters`` and ``setup`` {name: {count, total_s}}.  Stamped replays
    the device has finished are read first: synchronize before it to read
    them all."""
    for st in list(_unread):
        st.read()
    return {
        "spans": {n: {"count": c, "total_us": t / 1e3, "max_us": m / 1e3}
                  for n, (c, t, m) in _spans.items()},
        "marks": {n: {"count": c, "total_us": t, "max_us": m}
                  for n, (c, t, m) in _marks.items()},
        "counters": {n: dict(v) if isinstance(v, dict) else v
                     for n, v in _counters.items()},
        "setup": {n: {"count": c, "total_s": t}
                  for n, (c, t) in _setup.items()},
    }


def reset() -> None:
    """Clear the registry (spans, marks, counters, set-up timers)."""
    for table in (_spans, _marks, _counters, _setup):
        table.clear()
    _unread.clear()


def fft_mflops(n: int, seconds: float, real_input: bool = True,
               count: int = 1) -> float:
    """FFTW's benchmark metric (libbench2/mflops.c:20-27)."""
    ops = (2.5 if real_input else 5.0) * n * math.log2(n) * count
    return ops / (seconds * 1e6)


@dataclass
class FrameProfiler:
    """Rolling per-tick statistics for a serving engine."""

    num_streams: int
    fft_size: int
    window: int = 600            # ticks of history
    _durations: list = field(default_factory=list)
    _t0: float | None = None

    def tick_start(self) -> None:
        self._t0 = time.perf_counter()

    def tick_end(self) -> None:
        if self._t0 is None:
            return
        self._durations.append(time.perf_counter() - self._t0)
        self._t0 = None
        if len(self._durations) > self.window:
            del self._durations[:len(self._durations) - self.window]

    @contextlib.contextmanager
    def tick(self):
        self.tick_start()
        try:
            yield
        finally:
            self.tick_end()

    def stats(self) -> dict:
        if not self._durations:
            return {}
        d = np.asarray(self._durations)
        per_tick = float(d.mean())
        return {
            "ticks": len(d),
            "ms_per_tick": per_tick * 1e3,
            "frames_per_sec": self.num_streams / per_tick,
            "p50_ms": float(np.percentile(d, 50)) * 1e3,
            "p99_ms": float(np.percentile(d, 99)) * 1e3,
            "fft_mflops": fft_mflops(self.fft_size, per_tick,
                                     real_input=True,
                                     count=self.num_streams),
        }


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU and, where a card is
    present, CUDA activity), yielding the profiler; with ``logdir`` the
    Chrome trace is written to ``logdir/trace.json`` at the end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        import os
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _device_kernels(events) -> list:
    """(name, start µs, end µs) of every operation the device ran in the
    window: kernels, copies and fills."""
    out = []
    for ev in events:
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        tr = ev.time_range
        if tr.end > tr.start:
            out.append((ev.name, tr.start, tr.end))
    return out


def _innermost(ranges) -> list:
    """The disjoint, sorted ``(name, start, end)`` pieces of the timeline
    that ``ranges`` cover, each named by the innermost range over it (the
    latest to start; of two that start together, the shorter)."""
    ranges = sorted(ranges, key=lambda r: r[1])
    points = sorted({t for _, a, b in ranges for t in (a, b)})
    out, active, i = [], [], 0
    for p, q in zip(points, points[1:]):
        active = [r for r in active if r[2] > p]
        while i < len(ranges) and ranges[i][1] <= p:
            if ranges[i][2] > p:
                active.append(ranges[i])
            i += 1
        if active:
            name = max(active, key=lambda r: (r[1], -r[2]))[0]
            out.append((name, p, q))
    return out


def _union(ops, lo: float = -math.inf, hi: float = math.inf) -> list:
    """The union of ``(name, start, end)`` intervals clipped to ``[lo,
    hi]``: sorted, disjoint ``[start, end]`` pairs."""
    busy: list = []
    for _, a, b in sorted(ops, key=lambda k: k[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return busy


def idle_by_span(device, ranges, lo: float, hi: float) -> dict:
    """{range name: µs} of the device's idle time in ``[lo, hi]``: each
    gap between the device operations ``device`` goes whole to the
    innermost of ``ranges`` that overlaps it most, or to :data:`CALLER`
    where none does.  Both arguments hold ``(name, start, end)`` tuples on
    one clock."""
    gaps, t = [], lo
    for a, b in _union(device, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    pieces = _innermost(ranges)
    out: dict = {}
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][2] <= a:
            j += 1
        over: dict = {}
        for name, pa, pb in pieces[j:]:
            if pa >= b:
                break
            over[name] = over.get(name, 0.0) + min(b, pb) - max(a, pa)
        name = max(over, key=over.get) if over else CALLER
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def device_summary(prof, wall_s: float) -> dict:
    """The device's share of a profiled window: ``busy_us`` (the union of
    its kernels' intervals), ``busy_share`` (that over ``wall_s``, the
    window's host-clocked wall time, which ends in a synchronize),
    ``kernels`` {name: (count, total µs)} of its operations (copies and
    fills included) and ``idle_by_span`` (:func:`idle_by_span` over the
    trace's first to last event, by the program's ``waveform.*`` ranges).
    A window in which the device ran nothing raises: a trace without
    device activity cannot say where the time went."""
    events = list(prof.events())
    ks = _device_kernels(events)
    if not ks:
        raise RuntimeError("the profiled window holds no device kernel")
    busy = sum(b - a for a, b in _union(ks))
    by_name: dict = {}
    for name, a, b in ks:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (b - a))
    ranges = [(ev.name[len(PREFIX):], ev.time_range.start, ev.time_range.end)
              for ev in events if ev.name.startswith(PREFIX)
              and ev.device_type != torch.autograd.DeviceType.CUDA]
    lo = min(ev.time_range.start for ev in events)
    hi = max(ev.time_range.end for ev in events)
    return {"busy_us": busy, "busy_share": busy / (wall_s * 1e6),
            "kernels": by_name,
            "idle_by_span": idle_by_span(ks, ranges, lo, hi)}
