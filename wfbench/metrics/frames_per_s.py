"""Stream-frames completed over the whole measured window: S a tick, all
the ticks, all the time (the host clock, from the first tick's packets to
the last tick's synchronize)."""


def read(run):
    return run.S * run.ticks / run.window_s
