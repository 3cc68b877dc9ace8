"""Set-up's graph captures: the program's set-up timer
``graph.capture`` (each tick kind's warm-up tick, its capture and its
stamped twin's), s in all (host clock)."""

from wfbench import program_trace


def read(run):
    return program_trace.setup_s(run, "graph.capture")
