"""Host ingest a packet: the span ``serving.feed`` around each ``feed`` /
``feed_batch`` call over counter ``feed.packets``, the packets those
calls delivered (one a ``feed``, S a ``feed_batch``), µs a packet (host
clock).  Logs the packets a recorded tick and the ticks' count forms
against the recorded ticks.  Nothing where the program counts no
packets."""

from wfbench import program_trace


def read(run):
    snap = program_trace.snapshot()
    if snap is None:
        return None
    c = snap["counters"]
    packets = c.get("feed.packets", 0)
    span = snap["spans"].get("serving.feed")
    if not packets or span is None:
        return None
    ticks = program_trace.ticks(snap)
    run.log(f"# feed.packets {packets} in {ticks} recorded ticks"
            + (f" ({packets / ticks:.3f} a tick)" if ticks else "")
            + "; " + ", ".join(f"{n} {c.get(n, 0)}" for n in (
                "ticks.gather", "ticks.rotating", "ticks.uniform",
                "marks.missed")))
    return span["total_us"] / packets
