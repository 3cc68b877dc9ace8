"""The benchmark's default look under per-stream packets, on the CPU.

The look is ``wfbench/configs/default4096.json``'s settings (the plugin's
defaults: curve, FFT 4096, Hann, Catmull-Rom, mono, gravity 0.65) at 4
streams, fed as the benchmark's ``packets`` traffic feeds it
(``wfbench.generator.Traffic``): one ``feed`` call a 1024-frame packet at
each stream's own phase, so most ticks advance the rows by different
counts (0 or 1024) and take the per-row push.  The port's
``ServingEngine``, on the shifting ring and on the rotating ring the card
runs (``tests/test_torch_rotating.py`` puts a CPU engine on it), is held
to the float64 PyTorch reference ``wfbench/reference/spectrum_torch.py``;
faults planted in the feed and in the count column fail that tolerance;
and the counters that the cell's per-layer metric ``feed_packet_us``
reads count what was fed."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import waveform_tpu_torch as wt
from waveform_tpu_torch.core.settings_io import settings_from_obs
from waveform_tpu_torch.runtime import profiler, serving
from waveform_tpu_torch.runtime.serving import ServingEngine
from wfbench.generator import Traffic

REPO = Path(__file__).resolve().parents[1]
DEPLOYMENT = json.loads(
    (REPO / "wfbench" / "configs" / "default4096.json").read_text())
MIX = json.loads((REPO / "wfbench" / "traffic" / "packets.json").read_text())
REFERENCE = REPO / "wfbench" / "reference" / "spectrum_torch.py"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location("default_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _load(REFERENCE)
S, TICKS, SEED = 4, 24, 2 ** 31 + 27
SR, FPS = DEPLOYMENT["audio"]["samples_per_sec"], DEPLOYMENT["fps"]
# the port's float32 tail and rebin against float64: the widest gap of a
# tick is 0.7-1.7e-4 dB, in the deepest noise bins; each fault below
# moves some pixel by more than 25 dB
TOL_DB = 1e-3
FAULT_TICK = 9       # the tick whose feed a fault changes


CFG = wt.resolve(settings_from_obs(DEPLOYMENT["settings"]),
                 wt.AudioInfo(SR, DEPLOYMENT["audio"]["channels"]),
                 wt.VideoInfo(FPS))
C = max(CFG.capture_channels, 1)
N = CFG.fft_size
GEN = Traffic(MIX, S, C, N, SR, FPS, SEED)
# the first tick at which every stream's ring holds a whole window, then
# three ticks for the smoothing to fill the deepest dips of the first
# windows' noise (as tests/test_torch_studio_look.py waits)
FULL = int(np.min(np.flatnonzero((GEN.ends(np.arange(TICKS + 1)) >= N)
                                 .all(axis=1))))
CHECKED = list(range(FULL + 3, TICKS + 1))


def _engine(monkeypatch, ring: str) -> ServingEngine:
    monkeypatch.setattr(serving, "reads_rotating_ring",
                        lambda *args: ring == "rotating")
    eng = ServingEngine(CFG, S, device="cpu")
    assert eng._rotating == (ring == "rotating")
    return eng


def serve(eng: ServingEngine, fault=None) -> np.ndarray:
    """The engine's pixels [TICKS, S, D, width] (dBFS) under the traffic,
    one ``feed`` a packet; ``fault(k, stream)`` may name another stream
    to feed a packet to, or None to drop it."""
    out = []
    for k in range(1, TICKS + 1):
        now = GEN.now_ns(k)
        for s, data, ts in GEN.packets(k):
            to = s if fault is None else fault(k, s)
            if to is not None:
                eng.feed(to, data, ts, now_ns=now)
        out.append(np.array(eng.tick(now_ns=now), dtype=np.float64))
    return np.stack(out)


@pytest.fixture(scope="module")
def want():
    """The reference's pixels at the checked ticks, each stream smoothed
    from its first packet."""
    look = reference.Look(DEPLOYMENT["settings"], DEPLOYMENT["audio"], FPS)
    return reference.expected_pixels(look, GEN.ends, GEN.frames,
                                     GEN.first_tick, CHECKED, TICKS)


@pytest.fixture(autouse=True)
def clean_registry():
    profiler.set_tracing(False)
    profiler.reset()
    yield
    profiler.set_tracing(False)
    profiler.reset()


def test_the_traffic_feeds_streams_at_their_own_phases():
    """The random phases put the streams' packets on different ticks: a
    tick in which the counts differ from row to row (the per-row push)
    comes before every checked tick."""
    assert len(set(GEN.offset.tolist())) == S
    counts = np.diff(GEN.ends(np.arange(TICKS + 1)), axis=0)
    assert set(np.unique(counts)) == {0, MIX["packet_frames"]}
    assert (counts != counts[:, :1]).any(axis=1)[:CHECKED[0]].sum() >= 3
    assert 1 <= FULL and CHECKED[0] <= TICKS - 8


@pytest.mark.parametrize("ring", ["shifting", "rotating"])
def test_the_engine_serves_the_reference(want, ring, monkeypatch):
    got = serve(_engine(monkeypatch, ring))[CHECKED[0] - 1:]
    assert got.shape == want.shape == (len(CHECKED), S, 1, 800)
    assert np.abs(got - want).max() < TOL_DB


def _to_neighbour(k, s):
    return (s + 1) % S if (k, s) == (FAULT_TICK, _victim()) else s


def _dropped(k, s):
    return None if (k, s) == (FAULT_TICK, _victim()) else s


def _victim() -> int:
    """A stream fed a packet at the fault's tick."""
    return next(s for s, _, _ in GEN.packets(FAULT_TICK))


def _uniform_counts(monkeypatch):
    """The staged count column forced to one count for every row (the
    largest): rows without a packet push that many stale samples."""
    stage = ServingEngine._stage

    def forced(self, now_ns, dt_f):
        stage(self, now_ns, dt_f)
        counts = self._meta_buf[:, 0]
        counts[:] = counts.max()
        self._tail[2] = counts[0]
        return True
    monkeypatch.setattr(ServingEngine, "_stage", forced)


@pytest.mark.parametrize("fault", ["to_neighbour", "dropped", "uniform"])
@pytest.mark.parametrize("ring", ["shifting", "rotating"])
def test_a_planted_fault_fails_the_tolerance(want, fault, ring, monkeypatch):
    eng = _engine(monkeypatch, ring)
    feed = {"to_neighbour": _to_neighbour, "dropped": _dropped}.get(fault)
    if fault == "uniform":
        _uniform_counts(monkeypatch)
    got = serve(eng, feed)[CHECKED[0] - 1:]
    assert np.abs(got - want).max() > 100 * TOL_DB


def test_feed_counts_a_packet_a_call_and_a_batch_s_packets():
    """``feed.packets``: one a ``feed`` call, S a ``feed_batch`` call,
    while tracing is on, and nothing while it is off; the ``serving.feed``
    span is one a call."""
    eng = ServingEngine(CFG, S, device="cpu")
    packet = np.zeros((C, 1024), np.float32)
    now = GEN.now_ns(3)
    eng.feed(0, packet, now, now_ns=now)
    eng.feed_batch(np.zeros((S, C, 1024), np.float32), now, now_ns=now)
    assert profiler.snapshot()["counters"] == {}
    profiler.set_tracing(True)
    for s in (0, 2, 3):
        eng.feed(s, packet, now, now_ns=now)
    assert profiler.snapshot()["counters"] == {"feed.packets": 3}
    eng.feed_batch(np.zeros((S, C, 1024), np.float32), now, now_ns=now)
    snap = profiler.snapshot()
    assert snap["counters"] == {"feed.packets": 3 + S}
    assert snap["spans"]["serving.feed"]["count"] == 4


@pytest.mark.parametrize("ring", ["shifting", "rotating"])
def test_the_traced_counters_count_the_packets_and_the_count_forms(
        ring, monkeypatch):
    """Traced over the traffic: every packet fed counts once, every tick
    whose rows advance by different counts counts as ``ticks.gather``
    (the rest as ``ticks.uniform``), and on the rotating ring every tick
    as ``ticks.rotating``."""
    eng = _engine(monkeypatch, ring)
    profiler.set_tracing(True)
    serve(eng)
    c = profiler.snapshot()["counters"]
    counts = np.diff(GEN.ends(np.arange(TICKS + 1)), axis=0)
    gather = int((counts != counts[:, :1]).any(axis=1).sum())
    assert c["feed.packets"] == int(GEN.fed(TICKS).sum())
    assert c["ticks.gather"] == gather and gather >= TICKS // 2
    assert c.get("ticks.uniform", 0) == TICKS - gather
    assert c.get("ticks.rotating", 0) == (TICKS if ring == "rotating" else 0)


def test_the_configuration_is_the_default_look_at_256_sources():
    """The cell's configuration: ``curve4096.json``'s look and guarantees,
    held to the float64 PyTorch reference, at 256 sources."""
    curve = json.loads(
        (REPO / "wfbench" / "configs" / "curve4096.json").read_text())
    assert DEPLOYMENT["settings"] == curve["settings"]
    assert DEPLOYMENT["guarantees"] == curve["guarantees"]
    assert DEPLOYMENT["engine"] == "serving_t64"
    assert DEPLOYMENT["streams"] == 256
    assert (CFG.fft_size, CFG.settings.width) == (4096, 800)
