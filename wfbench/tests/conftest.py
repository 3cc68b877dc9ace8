"""Fixtures of the benchmark's own tests: a small copy of the benchmark.

The tests run the harness on the CPU at a few streams (its checks and
arithmetic; no timing means anything there).  Tests marked ``cuda`` run
it on the card and skip without one.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
SMALL = {"curve4096": 4, "curve65536": 1}
# the default look, which no cell of BENCHMARK.json runs yet (see
# PERF.md), is checked in the small copy under both traffic mixes
PACKETS = "curve4096.s4.packets"
SYNCED = "curve4096.s4.synced"
CELLS = [PACKETS, SYNCED, "curve65536.s32.synced"]


def small_copy(dst: Path) -> Path:
    """A checkout at ``dst`` holding ``BENCHMARK.json`` and ``wfbench/``,
    with the ``curve4096`` configuration and its cells :data:`PACKETS`
    and :data:`SYNCED` added, every configuration cut to a few streams and
    three checked ticks."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "wfbench", dst / "wfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    if "curve4096" not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": "curve4096", "source": "https://github.com/phandasm/"
            "waveform/blob/v1.9.1/src/source.cpp#L119-L174",
            "file": "wfbench/configs/curve4096.json", "reduced": [],
            "why": "the plugin's default look"})
    for conf in bench["configs"]:
        path = dst / conf["file"]
        dep = json.loads(path.read_text())
        dep["streams"] = SMALL.get(conf["name"], 2)
        dep["check"]["ticks"] = 3
        path.write_text(json.dumps(dep))
    for name, mix in ((PACKETS, "packets"), (SYNCED, "synced")):
        bench["workloads"].append({"name": name, "config": "curve4096",
                                   "traffic": mix, "chips": 1,
                                   "why": f"the default look, {mix}"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def small(tmp_path) -> Path:
    return small_copy(tmp_path)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
