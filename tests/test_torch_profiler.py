"""The port's runtime/profiler.py against the JAX package's.

``fft_mflops`` and ``FrameProfiler`` are the JAX package's, as they are;
``trace`` runs ``torch.profiler`` and ``device_summary`` reads a window's
device kernels, which a CPU-only window does not have.
"""

import os

import pytest
import torch

from waveform_tpu.runtime import profiler as jprof
from waveform_tpu_torch.runtime import profiler as tprof


@pytest.mark.parametrize("n,seconds,real,count", [
    (1024, 1e-3, True, 1), (4096, 2.5e-4, True, 256), (800, 3e-3, False, 7),
    (65536, 1e-2, False, 32)])
def test_fft_mflops_matches_jax(n, seconds, real, count):
    assert (tprof.fft_mflops(n, seconds, real, count)
            == jprof.fft_mflops(n, seconds, real, count))


def test_frame_profiler_matches_jax():
    """The same tick durations give the same statistics (p50, p99,
    frames/s, MFLOPS), with the window's history trimmed alike."""
    durations = [1e-3 * (1 + (7 * i) % 13) for i in range(40)]
    port = tprof.FrameProfiler(256, 4096, window=32)
    ref = jprof.FrameProfiler(256, 4096, window=32)
    for d in durations:
        for p in (port, ref):
            p._durations.append(d)
            if len(p._durations) > p.window:
                del p._durations[:len(p._durations) - p.window]
    assert port.stats() == ref.stats()
    assert tprof.FrameProfiler(4, 1024).stats() == {}
    with port.tick():
        pass
    assert port.stats()["ticks"] == 32


def test_trace_writes_and_device_summary_needs_the_device(tmp_path):
    """``trace`` profiles a block and writes its Chrome trace; on the CPU
    the window holds no device kernel, and ``device_summary`` refuses to
    call it idle or busy."""
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64) @ torch.ones(64)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no device kernel"):
        tprof.device_summary(prof, 1e-3)
