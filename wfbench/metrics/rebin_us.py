"""The rebin in the captured tick: device time between the marks before
and after it, µs a recorded tick (device clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.mark_us(run, "tick.rebin")
