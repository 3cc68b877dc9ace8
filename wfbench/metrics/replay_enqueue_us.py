"""The graph replay's and the output copy's enqueue from inside the
program: the span ``serving.replay``, µs a recorded tick (host clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.span_us("serving.replay")
