"""Runs on the card (skips without one): each cell for a second through
the command, and both controls at a cell's own size: the program's own
float32 FFT path (cuFFT, ``WAVEFORM_TPU_FFT_BACKEND=xla``) and the
reference with its rebin in TF32."""

import json
import subprocess
import sys
import time

import pytest

from wfbench import harness
from wfbench.control import control_gap
from wfbench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "wfbench.run", "--workload", cell, "--seed",
         "2147483711", "--seconds", "1", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
    if trace:
        assert r["device"]["busy_s"] > 0
        assert {"ingest_ms", "tick_host_ms", "device_us_per_tick",
                "device_idle_pct", "fft_roofline"} <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"frames_per_s", "tick_p99_ms",
                                     "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(card, cell):
    r = control_gap(cell, 5, card)
    assert any(c["value"] > c["limit"] for c in r.values()), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_fft_path_is_not_correct(card, cell, monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
    r = harness.run_cell(cell, 2147483713, 1.0, False, card,
                         time.perf_counter(), log=lambda line: None)
    assert not r["correct"], r["checks"]
