"""The tick's host half: the benchmark's span around ``tick()`` up to its
return (assembly, upload, graph replay enqueue), mean over the window's
ticks (host clock)."""


def read(run):
    return float(run.tick_s.mean()) * 1e3
