"""What a profiled sub-window of ticks says: the device's busy time, its
operations by name, and its idle gaps labelled by the host span the loop
was in.

The arithmetic is that of ``waveform_tpu_torch.runtime.profiler``'s
``device_summary`` (the union of the device operations' intervals over a
window that ends in a synchronize), kept here so that the yardstick does
not move with the program.  The functions below take plain
``(name, start µs, end µs)`` tuples; :func:`profile_ticks` collects them.
"""

from __future__ import annotations

import re

def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(busy, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that the disjoint sorted ``busy``
    intervals leave uncovered."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def label(gap, host) -> str:
    """The host span (``(name, start, end)``) that overlaps ``gap`` most,
    or ``generator`` where the loop was in none of them (making the next
    tick's packets, or the profiler's own step)."""
    best, most = "generator", 0.0
    for name, a, b in host:
        over = min(b, gap[1]) - max(a, gap[0])
        if over > most:
            best, most = name, over
    return best


def short_name(name: str) -> str:
    """A device operation's name without its template and argument
    lists, at most 96 characters."""
    name = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "",
                  name)
    short = re.split(r"[<(]", name)[0].strip() or name
    for pat in (r"\w+_kernel_cuda", r"\w+Functor"):
        m = re.search(pat, name[len(short):])
        if "elementwise" in short and m:
            short = f"{short}<{m.group(0)}>"
            break
    return short[:96]


def summarize(device, host, ticks: int) -> dict | None:
    """The device's share of a profiled window of ``ticks`` ticks.

    ``device`` holds the device operations and ``host`` the loop's spans
    (``feed``, ``tick``, ``wait``), each ``(name, start µs, end µs)``
    on the profiler's clock.  The window runs from the first span's start
    to the last span's end (the last tick's synchronize).  None when the
    device ran nothing in it."""
    if not host:
        return None
    lo = min(a for _, a, _ in host)
    hi = max(b for _, _, b in host)
    ops = clip([(a, b) for _, a, b in device], lo, hi)
    if not ops:
        return None
    busy = merge(ops)
    by_name: dict = {}
    for name, a, b in device:
        key = short_name(name)
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + max(0.0, min(b, hi) - max(a, lo)))
    idle = [(label(g, host), g[1] - g[0]) for g in gaps(busy, lo, hi)]
    idle_by: dict = {}
    for name, us in idle:
        idle_by[name] = idle_by.get(name, 0.0) + us
    return {
        "ticks": ticks,
        "window_us": hi - lo,
        "busy_us": sum(b - a for a, b in busy),
        "ops": sorted(by_name.items(), key=lambda kv: -kv[1][1]),
        "idle_gaps": sorted(idle, key=lambda g: -g[1]),
        "idle_by_span": idle_by,
    }


def profile_ticks(step, ticks: int) -> tuple[list, list]:
    """Run ``step(span)`` ``ticks`` + 1 times under ``torch.profiler``,
    CPU and CUDA activity, and return the last ``ticks`` ticks' device
    operations and host spans.  ``step`` wraps its phases in
    ``span(name)`` (a ``record_function`` range).  The first tick is the
    profiler's warm-up and is dropped: a trace can lose its first
    activity records.  The events are read as the trace completes (after
    the profile they are gone)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    got: list = []
    cuda = torch.autograd.DeviceType.CUDA

    def ready(prof):
        dev, host = [], []
        for ev in prof.events():
            tr = ev.time_range
            ours = ev.name.startswith("wfbench.")
            if getattr(ev, "device_type", None) == cuda:
                # a range's device-side annotation spans its kernels and
                # the gaps between them: it is no device operation
                if tr.end > tr.start and not ours:
                    dev.append((ev.name, tr.start, tr.end))
            elif ours:
                host.append((ev.name[len("wfbench."):], tr.start, tr.end))
        got.append((dev, host))

    def span(name):
        return record_function(f"wfbench.{name}")

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=ticks),
                 on_trace_ready=ready) as prof:
        for _ in range(ticks + 1):
            step(span)
            prof.step()
    if len(got) != 1:
        raise RuntimeError(f"the profiler gave {len(got)} traces, not 1")
    return got[0]
