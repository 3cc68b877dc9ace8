"""The studio cell (``studio16384.s256.synced``) on the CPU, cut to a few
streams: the port through the ``serving_t64`` adapter is correct against
the float64 PyTorch reference, runs with the look broken underneath and
the TF32 control are not, the PyTorch reference agrees with the NumPy one,
and the readers of the rebin's marks read a stub registry and nothing
from a program without the marks."""

import json
import time

import numpy as np
import pytest
import torch

from wfbench import harness
from wfbench.control_t64 import control_gap
from wfbench.generator import Traffic
from wfbench.reference import spectrum as numpy_reference
from wfbench.reference import spectrum_torch as reference
from wfbench.tests.test_wfbench_program_trace import (EMPTY, STUB, read,
                                                      stub_run)

STUDIO = "studio16384.s256.synced"


def run(root, seed=2 ** 31 + 11, seconds=0.3):
    return harness.run_cell(STUDIO, seed, seconds, False, "cpu",
                            time.perf_counter(), log=lambda line: None,
                            root=root)


def test_the_studio_cell_is_correct(small):
    dep = json.loads((small / "wfbench" / "configs" / "studio16384.json")
                     .read_text())
    assert dep["engine"] == "serving_t64" and dep["streams"] == 2
    r = run(small)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    for c in r["checks"].values():
        assert 0.0 < c["value"] < c["limit"]


@pytest.fixture
def broken(monkeypatch):
    """Break a part of the look in the port, as a change could."""
    from waveform_tpu_torch.rebin import apply
    from waveform_tpu_torch.runtime import serving

    def unfiltered():
        # the rebin skips the Gaussian filter
        monkeypatch.setattr(apply, "filters", lambda cfg: False)

    def folded():
        # the two display channels handed out as their mean
        values = serving.ServingEngine._display_values

        def fold(self, state):
            v = values(self, state)
            return v.mean(-2, keepdim=True).expand_as(v)
        monkeypatch.setattr(serving.ServingEngine, "_display_values", fold)

    def unchanged():
        # the step hands back its state unchanged
        monkeypatch.setattr(serving, "assign", lambda dst, src: None)

    return {"unfiltered": unfiltered, "folded": folded,
            "unchanged": unchanged}


@pytest.mark.parametrize("fault", ["unfiltered", "folded", "unchanged"])
def test_a_broken_look_is_not_correct(small, broken, fault):
    broken[fault]()
    r = run(small)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_the_tf32_control_is_not_correct(small):
    r = control_gap(STUDIO, 11, "cpu", small)
    assert any(c["value"] > c["limit"] for c in r.values()), r


def test_the_two_references_agree_on_the_look(small):
    """At the cell's settings and two streams of its traffic: the PyTorch
    reference's float64 pixels are the NumPy reference's."""
    root = small
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, _, dep = harness.find_cell(STUDIO, bench, root)
    mix = json.loads((root / "wfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    gen = Traffic(mix, 2, 2, 16384, 48000, 60, 7)
    args = (gen.ends, gen.frames, gen.first_tick, [70, 93], 40)
    want = numpy_reference.expected_pixels(numpy_reference.look_from_settings(
        dep["settings"], dep["audio"], dep["fps"]), *args)
    look = reference.Look(dep["settings"], dep["audio"], dep["fps"])
    got = reference.expected_pixels(look, *args, block=1)
    assert got.shape == want.shape == (2, 2, 2, 800)
    assert np.abs(got - want).max() < 1e-9
    # the same code in float32: the control's first step, far off
    low = reference.expected_pixels(look, *args, dtype=torch.float32)
    assert np.abs(low - want).max() > 1e-4


MARKS = {"interp_us": "tick.interp", "filter_us": "tick.filter"}


@pytest.fixture
def registry(monkeypatch):
    from waveform_tpu_torch.runtime import profiler
    snap = {**STUB, "counters": {**STUB["counters"], "ticks.filtered": 30},
            "marks": {**STUB["marks"],
                      "tick.interp": {"count": 30, "total_us": 3600.0,
                                      "max_us": 150.0},
                      "tick.filter": {"count": 30, "total_us": 1500.0,
                                      "max_us": 60.0}}}
    state = {"snap": snap}
    monkeypatch.setattr(profiler, "snapshot", lambda: state["snap"])
    return state


@pytest.mark.parametrize("metric", sorted(MARKS))
def test_the_filter_readers(registry, metric):
    """A stage's device time a recorded stage on the card; None off it, on
    a registry without the marks (the parent's program) and on an empty
    one; ``filter_us`` logs ``ticks.filtered`` against the ticks."""
    run_ = stub_run()
    assert read(metric, run_) == {"interp_us": 120.0,
                                  "filter_us": 50.0}[metric]
    if metric == "filter_us":
        assert run_.logged == ["# ticks.filtered 30 of 30 recorded ticks, "
                               "marks.missed 0"]
    assert read(metric, stub_run("cpu")) is None
    registry["snap"] = STUB
    assert read(metric, stub_run()) is None
    registry["snap"] = EMPTY
    assert read(metric, stub_run()) is None


@pytest.mark.parametrize("metric", sorted(MARKS))
def test_a_program_without_a_registry_reads_nothing(monkeypatch, metric):
    from waveform_tpu_torch.runtime import profiler
    monkeypatch.delattr(profiler, "snapshot")
    assert read(metric, stub_run()) is None
