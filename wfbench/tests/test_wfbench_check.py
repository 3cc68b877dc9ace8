"""The check that decides ``correct``: the port's CPU path agrees with the
float64 reference in both traffic mixes, and runs with the timed path
broken underneath, or the control in the program's place, come out
not correct."""

import time

import numpy as np
import pytest
import torch

from wfbench import harness
from wfbench.control import control_gap, tf32
from wfbench.generator import Traffic
from wfbench.tests.conftest import CELLS, SYNCED


def run(root, cell, seed=2 ** 31 + 7, seconds=0.3, traced=False):
    return harness.run_cell(cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), log=lambda line: None,
                            root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_the_reference(small, cell):
    r = run(small, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert list(r["checks"])[0] == "max_db_gap"
    for c in r["checks"].values():
        assert 0.0 < c["value"] < c["limit"]


def test_packets_leave_some_streams_without_a_packet():
    """In the packets mix a tick feeds some streams and not others, so the
    port takes its per-stream count form, which the check covers."""
    mix = {"feed": "per_stream", "packet_frames": 1024, "phase": "random",
           "tone_amplitude": 0.5, "tone_hz": [40, 16000], "noise_rms": 0.005}
    gen = Traffic(mix, 4, 2, 4096, 48000, 60, 5)
    fed = np.diff(gen.fed(np.arange(0, 80)), axis=0)       # [79, S]
    mixed = [(row.min() == 0) and (row.max() == 1) for row in fed[10:]]
    assert any(mixed) and fed.max() == 1


@pytest.fixture
def broken(monkeypatch):
    """Break the port's timed path in one of the ways a change could."""
    from waveform_tpu_torch.runtime import serving

    def unchanged():
        # the step hands back its state unchanged
        monkeypatch.setattr(serving, "assign", lambda dst, src: None)

    def half_batch():
        # the second half of the streams' windows never advance
        push = serving.push

        def half(ring, new, counts):
            keep = ring.buf[ring.buf.shape[0] // 2:].clone()
            push(ring, new, counts)
            ring.buf[ring.buf.shape[0] // 2:] = keep
            return ring
        monkeypatch.setattr(serving, "push", half)

    def altered():
        # one pixel of one stream altered where the tick produces it
        fresh = serving.PackedTickEngine._fresh

        def alter(self, out):
            out = fresh(self, out).clone()
            out[0, 0, 400] += 0.05
            return out
        monkeypatch.setattr(serving.PackedTickEngine, "_fresh", alter)

    return {"unchanged": unchanged, "half_batch": half_batch,
            "altered": altered}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_tick_is_not_correct(small, broken, fault, cell):
    broken[fault]()
    r = run(small, cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(small, cell):
    r = control_gap(cell, 11, "cpu", small)
    assert any(c["value"] > c["limit"] for c in r.values()), r


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                -3.0 - 2 ** -9]


@pytest.mark.parametrize("settings", [
    {"channel_mode": "stereo", "interp_mode": "lanczos",
     "window": "blackman"},
    {"slope": 0.5, "rolloff_q": 2.0, "rolloff_rate": 0.3,
     "filter_mode": "gauss", "mirror_freq_axis": True, "window": "hamming"},
    {"temporal_smoothing": "tv_exp_moving_avg", "fast_peaks": True,
     "interp_mode": "point", "log_scale": False,
     "window": "blackman_harris"},
    {"window": "power_of_sine", "sine_exponent": 3, "fft_size": 2048,
     "gravity": 0.0},
], ids=["stereo-lanczos", "slope-rolloff-gauss-mirror", "tv-peaks-point",
        "sine-nosmooth"])
def test_other_looks_match_the_reference(small, settings):
    """The reference also covers the looks a later configuration may
    bring: each against the port's CPU path."""
    import json
    path = small / "wfbench" / "configs" / "curve4096.json"
    dep = json.loads(path.read_text())
    dep["streams"] = 2
    dep["settings"].update(settings)
    # the time-varying average keeps 0.876 a tick: 160 ticks leave out
    # 6e-10 of the state, where 40 left out 5e-3
    dep["check"]["history"] = 160
    path.write_text(json.dumps(dep))
    r = run(small, SYNCED)
    assert r["checks"]["max_db_gap"]["value"] < 1e-3, r["checks"]
