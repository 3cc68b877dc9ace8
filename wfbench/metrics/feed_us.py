"""Host ingest from inside the program: the span ``serving.feed`` around
each ``feed`` / ``feed_batch`` call, µs a recorded tick (host clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.span_us("serving.feed")
