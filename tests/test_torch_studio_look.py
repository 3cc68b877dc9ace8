"""The benchmark's studio look on the CPU: the port's ``ServingEngine``
against the JAX package's ``ServingEngine`` and against the benchmark's
float64 PyTorch reference ``wfbench/reference/spectrum_torch.py`` at a
small copy of the look, faults planted in the engine that the tolerance
catches, the reference against the port's NumPy oracle, and the rebin's
marks and counter that the look's per-layer metrics read.

The look is ``wfbench/configs/studio16384.json``'s settings (stereo,
Blackman-Harris, fast peaks, slope, roll-off, Lanczos, the Gaussian
filter) at N = 1024, 3 streams and 96 pixels, fed as the benchmark's
``synced`` traffic feeds it: one ``feed_batch`` of a 1024-frame packet at
the first tick after its last sample, stamped with its first sample's
time."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import waveform_tpu_torch as wt
from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch.core.enums import InterpMode
from waveform_tpu_torch.core.settings_io import settings_from_obs
from waveform_tpu_torch.dsp import oracle
from waveform_tpu_torch.runtime import profiler
from waveform_tpu_torch.runtime.serving import ServingEngine

from test_torch_serving import _jax_cfg

REPO = Path(__file__).resolve().parents[1]
DEPLOYMENT = json.loads(
    (REPO / "wfbench" / "configs" / "studio16384.json").read_text())
REFERENCE = REPO / "wfbench" / "reference" / "spectrum_torch.py"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location("studio_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _load(REFERENCE)
S, N, WIDTH, PACKET, HOP, SR, TICKS = 3, 1024, 96, 1024, 800, 48000, 60
T0 = 1_000_000_000
FIRST = 2            # the tick of the first packet: 2 · 800 >= 1024
# the ticks compared: a first tick's magnitudes are one window's, whose
# deepest noise bins dip ~60 dB below their neighbours, where the exact
# FFT's absolute error (~1e-7 of the peak) reads as ~0.02 dB; from the
# third tick on the smoothing (fast peaks' max) fills such dips
CHECKED = list(range(FIRST + 3, TICKS + 1))
STAGES = ["tick.push", "tick.fft", "tick.tail", "tick.interp",
          "tick.filter", "tick.rebin"]
# the port's float32 tail and rebin against float64: ~1e-6 relative after
# 60 ticks of smoothing, ~1e-5 dB, up to ~1e-4 dB in the deepest noise
# bins (8.5e-5 measured); each fault below moves some pixel by >= 2.5 dB
TOL_DB = 1e-3
# the port against the JAX engine, both float32 with the exact FFT: the
# whole-slice tolerance of test_torch_serving (3.8e-5 measured)
TOL_JAX_DB = 1e-4


def settings(**changed) -> dict:
    s = dict(DEPLOYMENT["settings"], fft_size=N, width=WIDTH)
    s.update(changed)
    return s


def _audio() -> np.ndarray:
    """[S, 2, samples] float32: a tone a stream (log-uniform 40 Hz-16 kHz
    at 0.5, its own phase a channel) and noise at rms 0.005."""
    rng = np.random.default_rng(25)
    L = TICKS * HOP + PACKET
    hz = np.exp(rng.uniform(np.log(40.0), np.log(16000.0), S))
    phase = rng.uniform(0.0, 2.0 * np.pi, (S, 2, 1))
    t = np.arange(L) / SR
    x = (0.5 * np.sin(2.0 * np.pi * hz[:, None, None] * t + phase)
         + 0.005 * rng.standard_normal((S, 2, L)))
    return x.astype(np.float32)


AUDIO = _audio()


def fed(k) -> np.ndarray:
    """Packets fed by tick ``k`` (an array of ticks)."""
    return np.asarray(k) * HOP // PACKET


def ends_of(ks) -> np.ndarray:
    return np.repeat((fed(ks) * PACKET)[:, None], S, axis=1)


def frames_at(s: int, ends) -> np.ndarray:
    out = np.zeros((len(ends), 2, N))
    for i, e in enumerate(ends):
        n = min(int(e), N)
        out[i, :, N - n:] = AUDIO[s, :, e - n:e]
    return out


def resolved(s: dict):
    return wt.resolve(settings_from_obs(s), wt.AudioInfo(SR, 2),
                      wt.VideoInfo(60))


def serve(s: dict, ticks: int = TICKS, engine=None) -> np.ndarray:
    """The engine's pixels [ticks, S, D, WIDTH] (dBFS) over ``ticks``
    ticks of batched packets, from tick 1 (the port's engine unless
    ``engine`` is given)."""
    eng = engine or ServingEngine(resolved(s), S, device="cpu")
    out, done = [], 0
    for k in range(1, ticks + 1):
        now = T0 + k * HOP * 1_000_000_000 // SR
        while done < fed(k):
            eng.feed_batch(AUDIO[:, :, done * PACKET:(done + 1) * PACKET],
                           T0 + done * PACKET * 1_000_000_000 // SR,
                           now_ns=now)
            done += 1
        out.append(np.array(eng.tick(now_ns=now), dtype=np.float64))
    return np.stack(out)


def expected(ticks, look=None) -> np.ndarray:
    """The reference's pixels at ``ticks``, smoothed from tick 1."""
    look = look or reference.Look(settings(), DEPLOYMENT["audio"], 60)
    return reference.expected_pixels(look, ends_of, frames_at,
                                        np.full(S, FIRST), ticks, TICKS)


@pytest.fixture(scope="module")
def want():
    return expected(CHECKED)


@pytest.fixture(scope="module")
def port():
    return serve(settings())[CHECKED[0] - 1:]


@pytest.fixture(scope="module")
def jax_px():
    """The JAX engine's pixels at the checked ticks, its exact FFT kernel
    in interpret mode (as test_torch_serving runs it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
        mp.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
        mp.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
        eng = JaxEngine(_jax_cfg(resolved(settings())), S, use_native=False)
        return serve(settings(), engine=eng)[CHECKED[0] - 1:]


@pytest.fixture(autouse=True)
def clean_registry():
    profiler.set_tracing(False)
    profiler.reset()
    yield
    profiler.set_tracing(False)
    profiler.reset()


def test_the_engine_serves_the_reference(port, want):
    assert port.shape == want.shape == (len(CHECKED), S, 2, WIDTH)
    assert np.abs(port - want).max() < TOL_DB


def test_the_engine_serves_what_the_jax_engine_serves(port, jax_px):
    assert jax_px.shape == port.shape
    assert np.abs(port - jax_px).max() < TOL_JAX_DB


def test_the_jax_engine_serves_the_reference(jax_px, want):
    """The second witness: the JAX package's engine holds to the same
    float64 reference as the port."""
    assert np.abs(jax_px - want).max() < TOL_DB


@pytest.mark.parametrize("fault", [
    {"channel_mode": "mono"},            # the two channels folded
    {"filter_mode": "none"},             # the filter skipped
    {"interp_mode": "catmull_rom"},      # Catmull-Rom for Lanczos
    {"fast_peaks": False},               # fast peaks off
    {"slope": 0.0},                      # the slope dropped
], ids=["folded", "unfiltered", "catmull_rom", "no_peaks", "no_slope"])
def test_a_planted_fault_fails_the_tolerance(want, fault):
    """The engine run with one part of the look missing: a folded look's
    one channel stands for both."""
    got = np.broadcast_to(serve(settings(**fault))[CHECKED[0] - 1:],
                          want.shape)
    assert np.abs(got - want).max() > 1000 * TOL_DB


def test_the_reference_agrees_with_the_numpy_oracle(want):
    """The port's NumPy oracle (``dsp/oracle.py``) tick by tick, its
    smoothing from zero at the first packet: the same float64 answer."""
    cfg = resolved(settings())
    idx = oracle.interp_indices(cfg, WIDTH)
    sigma = cfg.settings.filter_radius
    checked = {10: None, 35: None, TICKS: None}
    for s in range(S):
        state = np.zeros((2, N // 2))
        for k in range(FIRST, TICKS + 1):
            x = frames_at(s, [int(fed(k)) * PACKET])[0]
            db, state = oracle.spectrum_frame(x, state, cfg, dt=1 / 60)
            if k in checked:
                px = [oracle.apply_gauss(oracle.apply_interp_curve(
                    db[d], idx, InterpMode.LANCZOS), sigma) for d in range(2)]
                got = want[k - CHECKED[0], s]
                assert np.abs(got - np.stack(px)).max() < 1e-9, (s, k)


def test_the_reference_refuses_what_it_does_not_model():
    for bad in ({"display_mode": "bars"}, {"normalize_volume": True},
                {"channel_mode": "single"}, {"filter_mode": "box"},
                {"audio_sync_offset": 30}, {"fft_size": 1000}):
        with pytest.raises(NotImplementedError):
            reference.Look(settings(**bad), DEPLOYMENT["audio"], 60)


def _traced(s: dict, ticks: int = 8) -> dict:
    eng = ServingEngine(resolved(s), S, device="cpu")
    serve(s, ticks=2, engine=eng)
    profiler.set_tracing(True)
    for k in range(3, 3 + ticks):   # a packet on some ticks, none on others
        now = T0 + k * HOP * 1_000_000_000 // SR
        if fed(k) > fed(k - 1):
            p = int(fed(k)) - 1
            eng.feed_batch(AUDIO[:, :, p * PACKET:(p + 1) * PACKET],
                           T0 + p * PACKET * 1_000_000_000 // SR, now_ns=now)
        eng.tick(now_ns=now)
    profiler.set_tracing(False)
    return profiler.snapshot()


@pytest.mark.parametrize("look,stages", [
    ("filtered", STAGES),
    ("unfiltered", [m for m in STAGES
                    if m not in ("tick.interp", "tick.filter")]),
])
def test_the_rebin_marks_the_filter_only_where_it_runs(look, stages):
    s = settings() if look == "filtered" else settings(filter_mode="none")
    snap = _traced(s)
    assert list(snap["marks"]) == stages
    assert all(m["count"] == 8 for m in snap["marks"].values())
    filtered = snap["counters"].get("ticks.filtered", 0)
    assert filtered == (8 if look == "filtered" else 0)
    assert snap["counters"]["ticks.uniform"] == 8


def test_tracing_off_marks_and_counts_nothing():
    serve(settings(), ticks=6)
    snap = profiler.snapshot()
    assert snap["marks"] == {} and snap["counters"] == {}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, node.module
            names.add(node.module.split(".")[0])
    return names


LOADED = ("import importlib.util, json, sys\n"
          "spec = importlib.util.spec_from_file_location('ref', sys.argv[1])\n"
          "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")


def test_the_reference_imports_nothing_of_the_port(path=REFERENCE):
    """It names torch, math and numpy alone, and loaded on its own it
    loads neither the port, the JAX package nor JAX."""
    assert _imports(path) == {"__future__", "math", "numpy", "torch"}
    out = subprocess.run([sys.executable, "-c", LOADED, str(path)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"}, cwd=path.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"waveform_tpu_torch", "waveform_tpu", "jax",
                         "jaxlib", "wfbench"}
