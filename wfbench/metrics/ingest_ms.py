"""Host ingest: the benchmark's span around one tick's ``feed`` /
``feed_batch`` calls, mean over the window's ticks (host clock)."""


def read(run):
    return float(run.feed_s.mean()) * 1e3
