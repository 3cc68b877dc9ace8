"""The default look's cell (``default4096.s256.packets``): its
configuration is ``curve4096.json``'s look at 256 sources, the reader of
``feed_packet_us`` reads a stub registry and nothing from a program that
does not count packets, and a traced run of the cell on the CPU, cut to
a few streams, is correct and reports it."""

import json
import time

import pytest

from wfbench import harness
from wfbench.tests.conftest import REPO
from wfbench.tests.test_wfbench_program_trace import (EMPTY, STUB, read,
                                                      stub_run)

CELL = "default4096.s256.packets"
CONFIGS = REPO / "wfbench" / "configs"


def test_the_configuration_is_the_default_look():
    dep = json.loads((CONFIGS / "default4096.json").read_text())
    curve = json.loads((CONFIGS / "curve4096.json").read_text())
    assert dep["settings"] == curve["settings"]
    assert (dep["engine"], dep["streams"]) == ("serving_t64", 256)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell, conf, _ = harness.find_cell(CELL, bench)
    assert (cell["traffic"], cell["chips"], conf["reduced"]) == (
        "packets", 1, [])


@pytest.fixture
def registry(monkeypatch):
    from waveform_tpu_torch.runtime import profiler
    # 30 ticks recorded, 200 packets a tick at 15 us a packet
    snap = {**STUB, "counters": {**STUB["counters"], "feed.packets": 6000},
            "spans": {**STUB["spans"], "serving.feed": {
                "count": 6000, "total_us": 90000.0, "max_us": 40.0}}}
    state = {"snap": snap}
    monkeypatch.setattr(profiler, "snapshot", lambda: state["snap"])
    return state


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_the_packet_reader(registry, device):
    """The span's total over the packets, on the host clock wherever the
    run is; it logs the packets a tick and the count forms; None on a
    registry without the counter (the parent's program) or an empty one."""
    run = stub_run(device)
    assert read("feed_packet_us", run) == pytest.approx(15.0)
    assert run.logged == [
        "# feed.packets 6000 in 30 recorded ticks (200.000 a tick); "
        "ticks.gather 5, ticks.rotating 0, ticks.uniform 25, "
        "marks.missed 0"]
    registry["snap"] = STUB
    assert read("feed_packet_us", stub_run(device)) is None
    registry["snap"] = EMPTY
    assert read("feed_packet_us", stub_run(device)) is None


def test_a_program_without_a_registry_reads_nothing(monkeypatch):
    from waveform_tpu_torch.runtime import profiler
    monkeypatch.delattr(profiler, "snapshot")
    assert read("feed_packet_us", stub_run()) is None


def test_a_traced_run_of_the_cell_reports_the_packet_cost(small):
    """Two sources of the look on the CPU, traced: correct, and every
    packet fed inside the traced ticks counted."""
    r = harness.run_cell(CELL, 2 ** 31 + 5, 0.2, True, "cpu",
                         time.perf_counter(), log=lambda line: None,
                         root=small)
    assert r["correct"], r["checks"]
    assert r["metrics"]["feed_packet_us"]["value"] > 0
    assert r["metrics"]["feed_packet_us"]["unit"] == "us"
