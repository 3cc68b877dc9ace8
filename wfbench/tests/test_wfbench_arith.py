"""The yardstick's arithmetic on hand-made numbers: the roofline's work
and bound, the trace's busy union, idle gaps and their labels, and the
metric readers."""

import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from wfbench import harness, roofline, trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def test_rfft_work_and_bound():
    nbytes, flops = roofline.rfft_mag_work(256, 2, 4096)
    assert nbytes == 256 * 2 * 4096 * 4 + 256 * 2 * 2048 * 4
    assert flops == 2.5 * 4096 * 12 * 512
    t, by = roofline.bound_s(nbytes, flops)
    assert by == "bytes" and t == pytest.approx(12582912 / 3.35e12)
    t, by = roofline.bound_s(1.0, 67e12)
    assert by == "flops" and t == 1.0


def test_busy_union_gaps_and_labels():
    dev = [("k1", 10, 20), ("k2", 15, 30), ("copy", 50, 55), ("k3", 90, 95)]
    host = [("feed", 0, 12), ("tick", 12, 40), ("wait", 40, 100)]
    assert trace.merge([(a, b) for _, a, b in dev]) == [(10, 30), (50, 55),
                                                         (90, 95)]
    s = trace.summarize(dev, host, ticks=2)
    assert s["window_us"] == 100 and s["busy_us"] == 30
    # gaps (0, 10), (30, 50), (55, 90), (95, 100); a tie goes to the
    # first span that reaches it
    assert s["idle_gaps"] == [("wait", 35), ("tick", 20), ("feed", 10),
                              ("wait", 5)]
    assert s["idle_by_span"] == {"feed": 10, "tick": 20, "wait": 40}
    assert s["ops"][0] == ("k2", (1, 15))
    assert trace.label((200, 210), host) == "generator"
    assert trace.summarize([], host, 2) is None


def test_short_names():
    assert trace.short_name(
        "void at::native::elementwise_kernel<128, 4, at::native::"
        "gpu_kernel_impl<at::native::MulFunctor<float> >>(int, T)"
    ) == "elementwise_kernel<MulFunctor>"
    assert trace.short_name("wf_exact_mag_gen_stage1<false>") == \
        "wf_exact_mag_gen_stage1"


def read(name, run):
    return harness.load_module(METRICS / f"{name}.py").read(run)


def test_metric_readers():
    lat = np.array([1.0, 2.0, 3.0, 4.0]) * 1e-3
    run = SimpleNamespace(
        S=256, ticks=4, window_s=0.02, setup_s=7.5, latency_s=lat,
        feed_s=lat / 4, tick_s=lat / 2, wait_s=lat / 4, C=2, N=4096,
        device=SimpleNamespace(type="cuda"), log=print,
        profile={"busy_us": 600.0, "window_us": 2000.0, "ticks": 3,
                 "ops": [("elementwise_kernel", (9, 300.0)),
                         ("exact_mag_gen_stage1", (3, 75.0)),
                         ("exact_mag_gen_stage2", (3, 75.0))]})
    assert read("frames_per_s", run) == pytest.approx(256 * 4 / 0.02)
    assert read("tick_p99_ms", run) == pytest.approx(3.97)
    assert read("setup_s", run) == 7.5
    assert read("ingest_ms", run) == pytest.approx(0.625)
    assert read("tick_host_ms", run) == pytest.approx(1.25)
    assert read("device_us_per_tick", run) == 200.0
    assert read("device_idle_pct", run) == pytest.approx(70.0)
    # bound 12,582,912 B / 3.35 TB/s over 50 us a tick of exact_* kernels
    assert read("fft_roofline", run) == pytest.approx(
        100 * 12582912 / 3.35e12 / 50e-6)
    other = SimpleNamespace(**{**vars(run), "profile": {
        **run.profile, "ops": [("fft_c2r_kernel", (3, 150.0))]}})
    assert read("fft_roofline", other) is None
    cpu = SimpleNamespace(**{**vars(run), "device": SimpleNamespace(
        type="cpu")})
    assert read("device_idle_pct", cpu) is None
    assert read("device_us_per_tick", cpu) is None
    assert read("fft_roofline", cpu) is None
    assert not math.isnan(read("tick_p99_ms", cpu))


def test_check_numbers_and_failed_curves():
    from wfbench import compare
    want = np.zeros((2, 3, 1, 100))
    got = want.copy()
    got[..., :2] += 1e-3          # 2% of the pixels: the p99 sees them
    got[0, 1, 0, 50] = 0.05       # one pixel of one curve
    limits = {"max_db_gap": 0.01, "p99_db_gap": 1e-4, "ticks": 2}
    c = compare.checks(got, want, limits)
    assert list(c) == ["max_db_gap", "p99_db_gap"]
    assert c["max_db_gap"] == {"value": 0.05, "limit": 0.01}
    assert c["p99_db_gap"]["value"] == pytest.approx(1e-3)
    assert compare.failed_frames(got, want, limits) == 1
    # only the whole set's p99 fails: every checked curve counts
    got[0, 1, 0, 50] = 0.0
    assert compare.failed_frames(got, want, limits) == 6
    assert compare.failed_frames(got, want, {"max_db_gap": 0.01}) == 0
    got[1, 2, 0, 7] = np.nan
    assert compare.checks(got, want, limits)["max_db_gap"]["value"] == \
        math.inf
    assert compare.failed_frames(got, want, limits) == 1
