"""The tick's host assembly from inside the program: the span
``serving.stage`` (the wait on the buffer's last upload, the native
assembly, the push form and the scalars), µs a recorded tick (host
clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.span_us("serving.stage")
