"""The ring push in the captured tick: device time from the mark at the
packed tick's entry (the upload's unpacking counts with it) to the mark
after the push, µs a recorded tick (device clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.mark_us(run, "tick.push")
