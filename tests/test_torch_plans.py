"""The port's plan lookup and tuner (``utils/plans.py``) against the JAX
package's.

The stage-1 split is resolved in the same order in both packages:
``WAVEFORM_TPU_STAGE1_SPLIT``, then the plan file
(``WAVEFORM_TPU_PLAN_FILE``), then the default.  The port's
``exact_cuda.stage1_split``, ``supports`` and ``kernel_would_run`` must
give the JAX ``_stage1_split``, ``supports`` and ``kernel_would_run``
(``WAVEFORM_TPU_EXACT_KERNEL=always``, the port's ``auto`` on the CPU)
over the same files, exactly.  The tuner's timing runs on the card only;
its bookkeeping runs here on a fake timer.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from waveform_tpu.kernels import exact_pallas
from waveform_tpu.utils import plans as jplans
from waveform_tpu_torch.kernels import cuda_lib, exact_cuda
from waveform_tpu_torch.utils import plans

SIZES = (1024, 2048, 4096, 6144, 8192, 12288, 16384, 24576, 28672, 31744,
         32768, 65536)
SCENARIOS = {
    # name: (plan file contents or None, WAVEFORM_TPU_STAGE1_SPLIT)
    "no_file": (None, None),
    "split3_at_4096": ({"4096": {"split": 3, "ddt": "int8", "bs": 8}}, None),
    "split2_at_65536_cannot_run": ({"65536": {"split": 2}}, None),
    "env_beats_file": ({"4096": {"split": 3}, "16384": {"split": 3}}, "2"),
}


@pytest.fixture
def plan_file(tmp_path, monkeypatch):
    """An empty plan-file path for both packages, no split override, and
    neither package's packaged table (the JAX one is inert on the CPU)."""
    pf = tmp_path / "plans.json"
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", str(pf))
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    monkeypatch.setattr(plans, "_packaged_plans", lambda: {})
    return pf


def _write(pf: Path, plan: dict, stamp: int) -> None:
    pf.write_text(json.dumps(plan))
    os.utime(pf, (stamp, stamp))   # a distinct mtime for the lookup cache


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_stage1_split_matches_jax(scenario, plan_file, monkeypatch):
    """ROADMAP C5: the port reads the plan file as JAX does (the parent
    port read only the variable and the default, so a file naming 3 at
    4096 sent 4096 to another body than JAX's)."""
    plan, env = SCENARIOS[scenario]
    if plan is not None:
        _write(plan_file, plan, 1000 + len(scenario))
    if env is not None:
        monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", env)
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    for n in SIZES:
        assert exact_cuda.stage1_split(n) == exact_pallas._stage1_split(n), n
        assert exact_cuda.supports(n) == exact_pallas.supports(n), n
        assert (exact_cuda.kernel_would_run(n)
                == exact_pallas.kernel_would_run(n)), n
    want = {"no_file": 2, "split3_at_4096": 3,
            "env_beats_file": 2}.get(scenario)
    if want is not None:
        assert exact_cuda.stage1_split(4096) == want
    # the variable wins even where its body cannot run (supports is False)
    assert exact_cuda.stage1_split(65536) == (2 if env == "2" else 3)


def test_plan_steers_the_routed_body(plan_file):
    """Under a file naming 3 at 4096 the router runs K2's body (its twin
    here, bit for bit), with none K1-gen's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.5 * rng.standard_normal((3, 2, 4096)))
                         .astype(np.float32))
    mag2, _ = exact_cuda.rfft_pair_mag(x)
    assert torch.equal(mag2, exact_cuda.rfft_pair_mag_ref(x)[0])
    _write(plan_file, {"4096": {"split": 3}}, 2000)
    mag3, nz3 = exact_cuda.rfft_pair_mag(x)
    ref3, nz_ref3 = exact_cuda.rfft_pair_mag3_ref(x)
    assert torch.equal(mag3, ref3) and torch.equal(nz3, nz_ref3)
    np.testing.assert_allclose(mag3.numpy(), mag2.numpy(), rtol=0,
                               atol=3e-7 * float(mag2.max()))


def test_record_and_plan_for_round_trip(plan_file):
    """record() writes the JAX schema that plan_for() reads back, in both
    packages: a file recorded by one is read by the other."""
    assert plans.plan_for(8192) is None
    entry = {"split": 3, "streams": 256, "us_per_frame": 0.5,
             "xla_us_per_frame": 9.0}
    plans.record(8192, entry)
    assert plans.plan_for(8192) == entry
    assert plans.plan_for(999) is None
    assert jplans.plan_for(8192) == entry
    jplans.record(4096, {"split": 2, "ddt": "bf16", "bs": 16})
    assert plans.plan_for(4096)["split"] == 2
    assert exact_cuda.stage1_split(8192) == 3
    assert json.loads(plan_file.read_text())["8192"] == entry


def test_plan_path_default_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("WAVEFORM_TPU_PLAN_FILE", raising=False)
    assert plans.plan_path().endswith(
        os.path.join(".cache", "waveform_tpu_torch", "plans.json"))
    assert plans.plan_path() != jplans.plan_path()


def test_packaged_table_only_on_an_h100(plan_file, monkeypatch):
    """The packaged table is {} on the CPU, read on a device that names an
    H100 and on no other card; a probe that raises is not latched."""
    monkeypatch.undo()                       # the real _packaged_plans
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", str(plan_file))
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    plans._packaged_plans.cache_clear()
    assert plans._packaged_plans() == {}     # this CPU-only torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, applies in (("NVIDIA A100-SXM4-80GB", False),
                          ("NVIDIA H100 80GB HBM3", True)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, name=name: name)
        plans._packaged_plans.cache_clear()
        assert (plans._packaged_plans() != {}) == applies, name

    def boom(*a):
        raise RuntimeError("CUDA initialising")

    monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    plans._packaged_plans.cache_clear()
    assert plans.plan_for(4096) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert plans.plan_for(4096) is not None  # recovered, not latched empty
    # the user's file wins over the packaged entry
    _write(plan_file, {"4096": {"split": 3}}, 3000)
    assert plans.plan_for(4096) == {"split": 3}
    plans._packaged_plans.cache_clear()


def test_packaged_file_parses_and_every_entry_runs():
    """The shipped H100 table: every size both bodies serve, from 4096 to
    32768 (N/128 % 32 == 0), measured at S = 256; each entry names a split
    its size can run, in the JAX schema, and beats the lowering."""
    with open(plans.PACKAGED) as f:
        shipped = json.load(f)
    assert sorted(map(int, shipped)) == list(range(4096, 32769, 4096))
    for key, e in shipped.items():
        n = int(key)
        assert set(e) == {"split", "streams", "us_per_frame",
                          "xla_us_per_frame"}, key
        assert e["streams"] == 256
        assert e["split"] in {s for s, _ in plans._candidates(n)}
        assert 0 < e["us_per_frame"] < e["xla_us_per_frame"]


@pytest.mark.parametrize("n,want", [
    (1024, [2]), (3072, [2]), (4096, [2, 3]), (6144, [2]),
    (16384, [2, 3]), (31744, [2]), (32768, [2, 3]), (65536, [3]),
    (800, []), (1040, []),
])
def test_candidates_follow_geometry(n, want, monkeypatch):
    """Each body where its geometry admits N (2: N1 % 8 == 0 up to 32768;
    3: N1 % 32 == 0 up to 65536), at the tier serving resolves; the JAX
    tuner's splits at every size where its kernels lower."""
    monkeypatch.delenv("WAVEFORM_TPU_KERNEL_TWIDDLE", raising=False)
    assert plans._candidates(n) == [(s, "f32") for s in want]
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    assert plans._candidates(n) == [(s, "df") for s in want]
    if n <= 32768 or n == 65536:
        assert sorted({s for s, *_ in jplans._candidates(n)}) == want


def test_measure_bookkeeping_with_fake_timer(plan_file, monkeypatch):
    """measure(): candidates interleaved rep by rep, the minimum of each,
    the fastest body recorded with the lowering's time in the JAX schema;
    a size no body serves records the lowering alone."""
    calls = []
    fake = {(2, "f32"): [3.0, 2.5, 2.75], (3, "f32"): [2.8, 2.6, 2.9],
            "xla": [9.0, 8.0, 8.5]}

    def timer(tag, n, streams, ticks):
        it = iter(fake[tag])

        def rep():
            calls.append(tag)
            return next(it)
        return rep

    monkeypatch.setattr(plans, "_graph_timer", timer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_lib, "build", lambda: None)
    entry = plans.measure(16384, streams=4, ticks=2, reps=3, verbose=False)
    assert entry == {"split": 2, "streams": 4, "us_per_frame": 2.5,
                     "xla_us_per_frame": 8.0}
    assert calls == [(2, "f32"), (3, "f32"), "xla"] * 3
    assert plans.plan_for(16384) == entry
    assert exact_cuda.stage1_split(16384) == 2
    fake[(2, "f32")] = [3.0, 2.7, 2.75]
    calls.clear()
    assert plans.measure(16384, 4, 2, 3, verbose=False)["split"] == 3
    fake["xla"] = [1.0, 1.5]
    assert plans.measure(800, 4, 2, 2, verbose=False) == {
        "streams": 4, "xla_us_per_frame": 1.0}
    assert json.loads(plan_file.read_text())["16384"]["split"] == 3


def test_measure_needs_the_card(plan_file):
    with pytest.raises(RuntimeError, match="CUDA device"):
        plans.measure(4096, streams=2, reps=1)
