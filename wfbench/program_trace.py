"""What the program traced of itself in a run, read after it: the
registry of ``waveform_tpu_torch.runtime.profiler`` (host spans inside
the served tick, device stage marks inside its captured graph, set-up
timers).  The program records spans and marks while a ``torch.profiler``
records, which is the harness's traced sub-window, and its set-up timers
always.  Every function returns None where the registry holds nothing to
read, as where the program has no such registry at all."""

from __future__ import annotations


def snapshot() -> dict | None:
    """The program's registry, or None where it has none."""
    from waveform_tpu_torch.runtime import profiler
    read = getattr(profiler, "snapshot", None)
    return None if read is None else read()


def ticks(snap: dict) -> int:
    """The ticks the registry recorded: each counts the ring push it took."""
    c = snap["counters"]
    return c.get("ticks.uniform", 0) + c.get("ticks.gather", 0)


def span_us(name: str) -> float | None:
    """Host span ``name``'s time a recorded tick, µs (host clock)."""
    snap = snapshot()
    if snap is None or name not in snap["spans"] or not ticks(snap):
        return None
    return snap["spans"][name]["total_us"] / ticks(snap)


def mark_us(run, name: str) -> float | None:
    """Stage ``name``'s device time a recorded tick, µs: the time between
    its two marks in the captured graph (device clock); nothing off the
    card, where a mark reads the host's clock."""
    if run.device.type != "cuda":
        return None
    snap = snapshot()
    m = None if snap is None else snap["marks"].get(name)
    if not m or not m["count"]:
        return None
    return m["total_us"] / m["count"]


def setup_s(run, name: str) -> float | None:
    """Set-up timer ``name``'s total, s (host clock); logs every set-up
    timer and counter the registry holds."""
    snap = snapshot()
    if snap is None or name not in snap["setup"]:
        return None
    run.log("# program set-up (count, s): " + ", ".join(
        f"{n} ({s['count']}, {s['total_s']:.6f})"
        for n, s in snap["setup"].items())
        + f"; counters {snap['counters']}")
    return snap["setup"][name]["total_s"]
