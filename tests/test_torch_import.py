"""The PyTorch port imports and serves without JAX and without the JAX
package.

Checked in a fresh interpreter: this test process has JAX and the JAX
package loaded already (tests/conftest.py imports jax), so only a
subprocess can show that the port's own import graph leaves both out.  The
probe blocks ``jax``, ``jaxlib``, ``flax`` and ``waveform_tpu`` (the JAX
package: the exact name and its submodules), imports every module of the
port's serving path (the graph tick, the meter engine, checkpoints, the
profiler, the waveform family's host copies and engines included), then
resolves a config with the port's own ``resolve`` and runs CPU ticks
through the port's native assembler: a microbatch flush, ``tick_many``, a
checkpoint saved and loaded into a resized engine, one
``MeterServingEngine`` tick, ``DeviceWaveformEngine`` ticks (one a k=2
microbatch flush) and a resize, and a ``WaveformEngine`` tick in each of
its three modes.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "waveform_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("blocked: " + name)
            return None

    for k in [k for k in sys.modules if blocked(k)]:
        del sys.modules[k]
    sys.meta_path.insert(0, Block())

    import waveform_tpu_torch
    import waveform_tpu_torch.dsp.devring
    import waveform_tpu_torch.dsp.spectrum
    import waveform_tpu_torch.kernels.exact_cuda
    import waveform_tpu_torch.kernels.exactfft
    import waveform_tpu_torch.rebin.apply
    import waveform_tpu_torch.dsp.meter
    import waveform_tpu_torch.runtime.graphs
    import waveform_tpu_torch.runtime.meter_serving
    import waveform_tpu_torch.runtime.profiler
    import waveform_tpu_torch.runtime.serving
    import waveform_tpu_torch.runtime.source
    import waveform_tpu_torch.runtime.waveform_host
    import waveform_tpu_torch.runtime.waveform_device
    import waveform_tpu_torch.runtime.engine
    import waveform_tpu_torch.utils.checkpoint

    import os
    import tempfile

    import numpy as np
    import waveform_tpu_torch as wt
    from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
    from waveform_tpu_torch.runtime.serving import ServingEngine

    cfg = wt.resolve(wt.Settings(fft_size=1024, width=200),
                     wt.AudioInfo(48000, 2))
    eng = ServingEngine(cfg, 2, use_native=True, microbatch=2,
                        device="cpu")
    assert type(eng._native).__module__ == "waveform_tpu_torch.native"
    x = np.random.default_rng(0).standard_normal((2, 2, 1024))
    for k in range(2):
        eng.feed_batch(x.astype(np.float32), 10**10, now_ns=10**10)
        px = eng.tick(now_ns=10**10)
    assert tuple(px.shape) == (2, 1, 200) and bool(px.isfinite().all())
    assert tuple(eng.tick_many(x[None, :, :, :800]).shape) == (1, 2, 1, 200)
    with tempfile.TemporaryDirectory() as d:
        eng.save_state(os.path.join(d, "s.npz"))
        eng.resized(3).load_state(os.path.join(d, "s.npz"), keep=[1, 0])
    mcfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER),
                      wt.AudioInfo(48000, 2))
    meter = MeterServingEngine(mcfg, 2, device="cpu")
    meter.feed_batch(x.astype(np.float32), 10**10, now_ns=10**10)
    assert tuple(meter.tick(now_ns=10**10).shape) == (2, 1, 2)

    from waveform_tpu_torch.runtime.engine import WaveformEngine
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine)
    wcfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.WAVEFORM,
                                  width=128), wt.AudioInfo(48000, 2))
    weng = DeviceWaveformEngine(wcfg, 2, use_native=True, microbatch=2,
                                device="cpu")
    assert type(weng._native).__module__ == "waveform_tpu_torch.native"
    for k in range(2):
        now = 10**10 + k * 10**7
        weng.feed_batch(x[..., :480].astype(np.float32), now, now_ns=now)
        disp = weng.tick(now_ns=now)
    assert tuple(disp.shape) == (2, 1, 128) and bool(disp.isfinite().all())
    assert weng.resized(3, keep=[1]).render_values().shape == (3, 1, 128)
    for mcfg_ in (cfg, mcfg, wcfg):
        e = WaveformEngine(mcfg_, 2, device="cpu")
        for s in range(2):
            e.feed(s, x[s].astype(np.float32), 10**10, now_ns=10**10)
        e.tick(now_ns=10**10)
        assert e.render_values().shape[0] == 2

    loaded = sorted(k for k in sys.modules if blocked(k))
    assert not loaded, loaded
    print("ok")
""")


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
