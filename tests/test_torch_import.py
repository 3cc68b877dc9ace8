"""The PyTorch port imports and serves without JAX and without the JAX
package.

Checked in a fresh interpreter: this test process has JAX and the JAX
package loaded already (tests/conftest.py imports jax), so only a
subprocess can show that the port's own import graph leaves both out.  The
probe blocks ``jax``, ``jaxlib``, ``flax`` and ``waveform_tpu`` (the JAX
package: the exact name and its submodules), then resolves a config with
the port's own ``resolve`` and runs one CPU ``ServingEngine`` tick through
the port's native assembler.
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
    import waveform_tpu_torch.runtime.serving

    import numpy as np
    import waveform_tpu_torch as wt
    from waveform_tpu_torch.runtime.serving import ServingEngine

    cfg = wt.resolve(wt.Settings(fft_size=1024, width=200),
                     wt.AudioInfo(48000, 2))
    eng = ServingEngine(cfg, 2, use_native=True, device="cpu")
    assert type(eng._native).__module__ == "waveform_tpu_torch.native"
    x = np.random.default_rng(0).standard_normal((2, 2, 1024))
    eng.feed_batch(x.astype(np.float32), 10**10, now_ns=10**10)
    px = eng.tick(now_ns=10**10)
    assert tuple(px.shape) == (2, 1, 200) and bool(px.isfinite().all())

    loaded = sorted(k for k in sys.modules if blocked(k))
    assert not loaded, loaded
    print("ok")
""")


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
