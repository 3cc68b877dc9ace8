"""The device's idle share of the profiled sub-window, which ends in the
last tick's synchronize: 100 × (1 − busy union / wall) (torch.profiler)."""


def read(run):
    if run.profile is None or run.device.type != "cuda":
        return None
    return 100.0 * (1.0 - run.profile["busy_us"] / run.profile["window_us"])
