"""The PyTorch port imports and serves without JAX and without the JAX
package.

Checked in a fresh interpreter: this test process has JAX and the JAX
package loaded already (tests/conftest.py imports jax), so only a
subprocess can show that the port's own import graph leaves both out.  The
probe blocks ``jax``, ``jaxlib``, ``flax`` and ``waveform_tpu`` (the JAX
package: the exact name and its submodules), imports every module of the
port's serving path (the graph tick, the meter engine, checkpoints, the
profiler, the waveform family's host copies and engines, the scene, the
bus and the renderer included), then
resolves a config with the port's own ``resolve`` and runs CPU ticks
through the port's native assembler: a microbatch flush, ``tick_many``, a
checkpoint saved and loaded into a resized engine, one
``MeterServingEngine`` tick, ``DeviceWaveformEngine`` ticks (one a k=2
microbatch flush) and a resize, a ``WaveformEngine`` tick in each of
its three modes, a ``MultiEngine`` scene tick (a cohort and a solo group)
with its frames, an ``OutputBus`` tick with a spectrum read and a
meter frame, a tick under the matmul backend and one with an ``rfft_fn``,
``wisdom.warm`` and a run of the demo CLI on a WAV; the plan lookup finds
no packaged table on the CPU.  The sharded engines (``parallel``) and the
dry run (``dryrun``) import the same way, and the dry run runs over a
2-entry CPU mesh.  A second probe, blocked the same way, runs the bench
(``waveform_tpu_torch.bench``) whole at a small size on the CPU, loads the
three examples (``examples/torch_*.py``) and renders a showcase panel.
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
    import waveform_tpu_torch.runtime.multi
    import waveform_tpu_torch.runtime.bus
    import waveform_tpu_torch.render.colors
    import waveform_tpu_torch.render.image
    import waveform_tpu_torch.render.raster
    import waveform_tpu_torch.utils.checkpoint
    import waveform_tpu_torch.utils.log
    import waveform_tpu_torch.utils.plans
    import waveform_tpu_torch.utils.wisdom
    import waveform_tpu_torch.kernels.matfft
    import waveform_tpu_torch.core.locale
    import waveform_tpu_torch.core.settings_io
    import waveform_tpu_torch.demo
    import waveform_tpu_torch.parallel
    import waveform_tpu_torch.parallel.mesh
    import waveform_tpu_torch.parallel.sharded_serving
    import waveform_tpu_torch.parallel.sharded_waveform
    import waveform_tpu_torch.dryrun
    import waveform_tpu_torch.bench

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

    from waveform_tpu_torch.runtime.bus import OutputBus
    from waveform_tpu_torch.runtime.multi import MultiEngine
    scene = MultiEngine(device="cpu")
    sids = [scene.add_stream(c) for c in (cfg, cfg, mcfg, wcfg)]
    for s in sids:
        scene.feed(s, x[0, :, :480].astype(np.float32), 10**10, now_ns=10**10)
    scene.tick(now_ns=10**10)
    assert len(scene._cohorts) == 1 and len(scene._solo) == 1
    frames = scene.render_frames()
    assert frames[sids[0]].shape == (cfg.height, cfg.width, 4)
    bus = OutputBus(cfg.audio, device="cpu")
    hs = [bus.subscribe(c) for c in (cfg, mcfg, wcfg)]
    bus.feed(x[0, :, :800].astype(np.float32), 10**10, now_ns=10**10)
    bus.tick(now_ns=10**10)
    assert bus.read_pixels(hs[0]).shape == (1, 200)
    assert bus.render_frame(hs[1]).shape == (mcfg.height, mcfg.width, 4)

    import torch
    from waveform_tpu_torch.utils import plans, wisdom
    assert plans._packaged_plans() == {} and plans.plan_for(1024) is None
    os.environ["WAVEFORM_TPU_FFT_BACKEND"] = "matmul"
    mm = ServingEngine(cfg, 2, device="cpu")
    del os.environ["WAVEFORM_TPU_FFT_BACKEND"]
    fn = ServingEngine(cfg, 2, rfft_fn=torch.fft.rfft, device="cpu")
    for e in (mm, fn):
        e.feed_batch(x.astype(np.float32), 10**10, now_ns=10**10)
        assert bool(e.tick(now_ns=10**10).isfinite().all())
    wisdom.warm(cfg, 2, device="cpu")
    import wave
    from waveform_tpu_torch import demo
    with tempfile.TemporaryDirectory() as d:
        with wave.open(os.path.join(d, "in.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(48000)
            w.writeframes((x[0].T * 3000).astype("<i2").tobytes())
        assert demo.main([os.path.join(d, "in.wav"), "--out",
                          os.path.join(d, "f"), "--device", "cpu",
                          "--fps", "100"]) == 0
        assert os.listdir(os.path.join(d, "f"))
    from waveform_tpu_torch.dryrun import dryrun
    assert dryrun(2, device="cpu").startswith("dryrun OK")

    loaded = sorted(k for k in sys.modules if blocked(k))
    assert not loaded, loaded
    print("ok")
""")


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


_PROBE_BENCH = textwrap.dedent("""
    import importlib.util
    import sys
    from pathlib import Path

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

    from waveform_tpu_torch import bench
    assert bench.main(["--device", "cpu", "--streams", "2", "--fft", "1024",
                       "--scan", "2", "--reps", "1", "--warmup", "1",
                       "--sizes", ""]) == 0
    mods = {}
    for name in ("torch_showcase", "torch_live_ingest",
                 "torch_sharded_demo"):
        spec = importlib.util.spec_from_file_location(
            name, Path("examples") / (name + ".py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    show = mods["torch_showcase"]
    img = show.render_panel(dict(dict(show.PANELS)["meter"]), "cpu")
    assert img.shape[-1] == 4 and img[..., 3].any()

    loaded = sorted(k for k in sys.modules if blocked(k))
    assert not loaded, loaded
    print("ok")
""")


def test_bench_and_examples_import_without_jax():
    """The bench, run whole at a small size on the CPU, and the three
    examples (loaded, and a showcase panel rendered) import neither JAX
    nor the JAX package."""
    r = subprocess.run([sys.executable, "-c", _PROBE_BENCH], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"
