"""The 99th percentile, over every tick of the window, of the time from
the tick's first feed call to the completion of its pixels on the device
(host clock; a late tick is a dropped frame)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latency_s, 99)) * 1e3
