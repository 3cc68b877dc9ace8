"""The compiled tick on the device: the union of the device operations'
intervals over the profiled sub-window, a tick (torch.profiler)."""


def read(run):
    if run.profile is None or run.device.type != "cuda":
        return None
    return run.profile["busy_us"] / run.profile["ticks"]
