"""The PyTorch port imports without JAX.

Checked in a fresh interpreter: this test process has JAX loaded already
(tests/conftest.py imports it), so only a subprocess can show that the
port's own import graph leaves it out.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "flax")

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

    loaded = sorted(k for k in sys.modules if blocked(k))
    assert not loaded, loaded
    print("ok")
""")


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
