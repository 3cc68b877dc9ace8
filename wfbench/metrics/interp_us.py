"""The interp product of a filtered rebin in the captured tick (the
dense Lanczos or Catmull-Rom product, or the gather): device time from
the mark before the rebin to the mark after the product, µs a recorded
tick (device clock).  Only a rebin that runs the Gaussian filter marks
it."""

from wfbench import program_trace


def read(run):
    return program_trace.mark_us(run, "tick.interp")
