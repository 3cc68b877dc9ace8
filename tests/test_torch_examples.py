"""The port's examples (``examples/torch_*.py``) against the JAX ones.

Both packages run the "xla" FFT backend, the one the JAX examples run
on the CPU (the port's is ``torch.fft.rfft``; its exact path and the
kernels' twins are held to JAX by the other ``test_torch_*`` files, and
cost several times more CPU here).

* ``torch_sharded_demo.py`` over ``["cpu"] * 8`` prints each stream's
  peak at the bin nearest its fed tone, the same peaks as
  ``sharded_demo.py`` on the conftest's 8 JAX CPU devices.
* Two panels of ``torch_showcase.py`` (the spectrum curve and the level
  meter) are within one step of 255 per 8-bit channel of
  ``showcase.py``'s ``render_panel`` (the JAX engine's ticks blocked, as
  in ``tests/test_torch_demo.py``).
* ``torch_live_ingest.py --seconds 1`` runs its feeder thread, bus and
  60 fps loop to the end and returns 0.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from waveform_tpu_torch.render.image import to_rgba8

from test_torch_demo import synchronous_reference

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SR = 48000


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _peaks(out: str) -> dict:
    """{stream: (peak Hz, fed Hz)} from a sharded demo's output."""
    return {int(s): (float(p), float(f)) for s, p, f in re.findall(
        r"stream\s+(\d+): peak\s+([\d.]+) Hz \(fed\s+([\d.]+) Hz\)", out)}


@pytest.fixture
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def test_sharded_demo_peaks_match_jax(capsys, xla_backend):
    assert _load("torch_sharded_demo").main(["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert "devices: 8 x cpu" in port and "on mesh 4x2" in port
    assert _load("sharded_demo").main() == 0
    ref = capsys.readouterr().out
    got, want = _peaks(port), _peaks(ref)
    assert sorted(got) == [0, 50, 99] and got == want
    for peak, fed in got.values():
        assert abs(peak - fed) <= SR / 1024 / 2       # the nearest bin


def test_showcase_panels_match_jax(monkeypatch, xla_backend):
    synchronous_reference(monkeypatch)
    port, ref = _load("torch_showcase"), _load("showcase")
    for name in ("curve solid", "meter"):
        kw = dict(port.PANELS)[name]
        jkw = dict(ref.PANELS)[name]
        got = to_rgba8(port.render_panel(dict(kw), "cpu")).astype(np.int16)
        want = to_rgba8(np.asarray(ref.render_panel(dict(jkw)))).astype(
            np.int16)
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1, name
        assert got[..., 3].any(), name            # something was drawn


def test_live_ingest_runs_a_second(capsys):
    assert _load("torch_live_ingest").main(
        ["--seconds", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "peak=" in out and out.strip().splitlines()[-1].startswith("done:")
    assert "bar frame shape (2, 80)" in out
