"""The Gaussian filter of the rebin in the captured tick: device time
from the mark after the interp product to the mark after the filter, µs
a recorded tick (device clock).  Logs the program's ``ticks.filtered``
counter against the ticks it recorded, and ``marks.missed``."""

from wfbench import program_trace


def read(run):
    snap = program_trace.snapshot()
    if snap is not None:
        c = snap["counters"]
        run.log(f"# ticks.filtered {c.get('ticks.filtered', 0)} of "
                f"{program_trace.ticks(snap)} recorded ticks, marks.missed "
                f"{c.get('marks.missed', 0)}")
    return program_trace.mark_us(run, "tick.filter")
