"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Top-level module names (the part
before the first dot) are compared whole: the port's name begins with the
JAX package's."""

import json
import subprocess
import sys

from wfbench.run import FORBIDDEN
from wfbench.tests.conftest import REPO

LOADED = ("import json, sys; print(json.dumps(sorted("
          "{m.split('.')[0] for m in sys.modules})))")


def top_level(code: str, cwd) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + LOADED],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{cwd}:{REPO}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax(small):
    code = ("import time, wfbench.run, wfbench.control\n"
            "from wfbench.harness import run_cell\n"
            "r = run_cell('curve4096.s4.packets', 3, 0.2, False, 'cpu', "
            "time.perf_counter(), log=lambda l: None)\n"
            "assert r['correct']")
    names = top_level(code, small)
    assert "waveform_tpu_torch" in names and "torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program(small):
    names = top_level("import wfbench.reference.spectrum, wfbench.generator",
                      small)
    assert "numpy" in names
    assert not names & {"torch", "waveform_tpu_torch", *FORBIDDEN}


def test_run_finds_forbidden_names_whole(monkeypatch):
    from wfbench import run
    monkeypatch.setitem(sys.modules, "waveform_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]
