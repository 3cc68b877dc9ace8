"""The readers of what the program traced of itself: on a stub registry
each returns its mean a recorded tick (the set-up total for
``capture_s``), and None on an empty registry or a program without one."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from wfbench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SPANS = {"feed_us": "serving.feed", "stage_us": "serving.stage",
         "upload_us": "serving.upload",
         "replay_enqueue_us": "serving.replay"}
MARKS = {"push_us": "tick.push", "fft_us": "tick.fft",
         "tail_us": "tick.tail", "rebin_us": "tick.rebin"}
STUB = {
    # 30 ticks recorded: 25 took the batch shift, 5 the per-stream gather
    "counters": {"ticks.uniform": 25, "ticks.gather": 5,
                 "graph.captures": {"tick,True": 1}},
    "spans": {name: {"count": 30 if name != "serving.feed" else 24,
                     "total_us": 60.0 * (i + 1), "max_us": 9.0}
              for i, name in enumerate(SPANS.values())},
    "marks": {name: {"count": 30, "total_us": 300.0 * (i + 1),
                     "max_us": 20.0 * (i + 1)}
              for i, name in enumerate(MARKS.values())},
    "setup": {"graph.capture": {"count": 2, "total_s": 0.25},
              "library.native": {"count": 1, "total_s": 0.01}},
}
EMPTY = {"counters": {}, "spans": {}, "marks": {}, "setup": {}}


def read(name, run):
    return harness.load_module(METRICS / f"{name}.py").read(run)


def stub_run(device="cuda"):
    logged = []
    return SimpleNamespace(device=SimpleNamespace(type=device),
                           log=logged.append, logged=logged)


@pytest.fixture
def registry(monkeypatch):
    from waveform_tpu_torch.runtime import profiler
    state = {"snap": STUB}
    monkeypatch.setattr(profiler, "snapshot", lambda: state["snap"])
    return state


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_readers(registry, metric):
    """A span's total over the recorded ticks (30), µs a tick, on the
    card or off it; None where the span or the ticks are missing."""
    i = list(SPANS).index(metric)
    assert read(metric, stub_run()) == pytest.approx(60.0 * (i + 1) / 30)
    assert read(metric, stub_run("cpu")) == pytest.approx(2.0 * (i + 1))
    registry["snap"] = EMPTY
    assert read(metric, stub_run()) is None
    registry["snap"] = {**STUB, "counters": {}}
    assert read(metric, stub_run()) is None


@pytest.mark.parametrize("metric", sorted(MARKS))
def test_mark_readers(registry, metric):
    """A stage's device time a recorded stage; None off the card (a mark
    there reads the host's clock) and on an empty registry."""
    i = list(MARKS).index(metric)
    assert read(metric, stub_run()) == pytest.approx(10.0 * (i + 1))
    assert read(metric, stub_run("cpu")) is None
    registry["snap"] = EMPTY
    assert read(metric, stub_run()) is None


def test_capture_reader(registry):
    run = stub_run()
    assert read("capture_s", run) == 0.25
    assert "graph.capture (2, 0.250000)" in run.logged[0]
    registry["snap"] = EMPTY
    assert read("capture_s", stub_run()) is None


@pytest.mark.parametrize("metric", [*sorted(SPANS), *sorted(MARKS),
                                    "capture_s"])
def test_a_program_without_a_registry_reads_nothing(monkeypatch, metric):
    """Run over a program whose profiler has no registry, every reader
    returns None and raises nothing."""
    from waveform_tpu_torch.runtime import profiler
    monkeypatch.delattr(profiler, "snapshot")
    assert read(metric, stub_run()) is None
