"""The exact |rFFT| kernels' share of their roofline in the served tick:
the least time the card could take for the work the layer's inputs need
(``wfbench/roofline.py``, from the cell's S, C and N) over the device
time the trace gives the port's exact FFT kernels (``exact_*``: K1-gen,
K2, K3, each stage), a tick of the profiled sub-window.  Nothing where
the trace holds no such kernel (another FFT path) or there is no card."""

from wfbench import roofline


def read(run):
    if run.profile is None or run.device.type != "cuda":
        return None
    fft_us = sum(us for name, (_, us) in run.profile["ops"]
                 if name.startswith("exact_"))
    if fft_us <= 0.0:
        return None
    took = fft_us / run.profile["ticks"] * 1e-6
    nbytes, flops = roofline.rfft_mag_work(run.S, run.C, run.N)
    bound, by = roofline.bound_s(nbytes, flops)
    run.log(f"# fft kernels at (S={run.S}, C={run.C}, N={run.N}): "
            f"{took * 1e6:.3f} us a tick, bound {bound * 1e6:.3f} us by {by} "
            f"({nbytes:.0f} B, {flops:.0f} flop)")
    return 100.0 * bound / took
