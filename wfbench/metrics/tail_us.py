"""The magnitude and spectrum tail in the captured tick (smoothing,
gating, dBFS, the state written back, the display values): device time
from the mark after the transform to the mark before the rebin, µs a
recorded tick (device clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.mark_us(run, "tick.tail")
