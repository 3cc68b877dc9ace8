"""The FFT layer in the captured tick, whatever implements it: device
time from the mark after the push to the mark after the transform, µs a
recorded tick (device clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.mark_us(run, "tick.fft")
