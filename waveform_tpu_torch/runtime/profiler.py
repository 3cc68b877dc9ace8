"""Frame profiler: throughput, latency percentiles, and the FFTW MFLOPS metric.

The PyTorch counterpart of ``waveform_tpu/runtime/profiler.py``.  FFTW's
harness reports MFLOPS = 5·N·log2(N)/t for complex transforms,
2.5·N·log2(N)/t for real ones (reference deps/fftw-3.3.11/libbench2/
mflops.c:20-27); the same definitions are kept, plus the serving metrics
the plugin never had: frames/s and p50/p99 tick latency.

:func:`trace` captures a ``torch.profiler`` window (CPU and CUDA
activity); :func:`device_summary` reads a finished window: the device's
busy share of the window's wall time and each device operation's (a
kernel's, a copy's, a fill's) time and count by name.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch


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


def _device_kernels(prof) -> list:
    """(name, start µs, end µs) of every operation the device ran in the
    window: kernels, copies and fills."""
    out = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        tr = ev.time_range
        if tr.end > tr.start:
            out.append((ev.name, tr.start, tr.end))
    return out


def device_summary(prof, wall_s: float) -> dict:
    """The device's share of a profiled window: ``busy_us`` (the union of
    its kernels' intervals), ``busy_share`` (that over ``wall_s``, the
    window's host-clocked wall time, which ends in a synchronize), and
    ``kernels`` {name: (count, total µs)} of its operations (copies and
    fills included).  A window in which the device ran nothing raises: a
    trace without device activity cannot say where the time went."""
    ks = sorted(_device_kernels(prof), key=lambda k: k[1])
    if not ks:
        raise RuntimeError("the profiled window holds no device kernel")
    busy, end = 0.0, -math.inf
    by_name: dict = {}
    for name, a, b in ks:
        if b > end:
            busy += b - max(a, end)
            end = b
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (b - a))
    return {"busy_us": busy, "busy_share": busy / (wall_s * 1e6),
            "kernels": by_name}
