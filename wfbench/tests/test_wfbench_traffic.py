"""The traffic generator: reproducible from its seed, on its own clock."""

import json
from pathlib import Path

import numpy as np
import pytest

from wfbench.generator import Traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def packets(gen, ticks):
    return [(s, d.tobytes(), ts) for k in ticks for s, d, ts in gen.packets(k)]


@pytest.mark.parametrize("name", ["packets", "synced"])
def test_a_seed_gives_the_same_packets(name):
    seed = 2 ** 33 + 17
    a = Traffic(mix(name), 3, 2, 4096, 48000, 60, seed)
    b = Traffic(mix(name), 3, 2, 4096, 48000, 60, seed)
    c = Traffic(mix(name), 3, 2, 4096, 48000, 60, seed + 1)
    ticks = range(1, 40)
    assert packets(a, ticks) == packets(b, ticks)
    assert packets(a, ticks) != packets(c, ticks)
    assert np.array_equal(a.frames(1, [5000, 9000]), b.frames(1, [5000, 9000]))


@pytest.mark.parametrize("name", ["packets", "synced"])
def test_no_packet_is_stamped_ahead_of_its_tick(name):
    gen = Traffic(mix(name), 5, 2, 4096, 48000, 60, 3)
    frames_ns = gen.P * 1_000_000_000 // gen.sr
    for k in range(1, 200):
        for s, data, ts in gen.packets(k):
            assert ts + frames_ns <= gen.now_ns(k)
            assert data.shape[-1] == gen.P and data.flags.c_contiguous


def test_packets_follow_obs_cadence():
    gen = Traffic(mix("packets"), 64, 2, 4096, 48000, 60, 9)
    fed = gen.fed(600) - gen.fed(0)       # ten seconds of audio
    assert np.all(np.abs(fed - 468.75) < 2)
    assert len(set(gen.offset.tolist())) > 32


def test_synced_feeds_every_stream_alike_at_obs_cadence():
    """One 1024-frame packet of every stream at a time, fed at the first
    tick after its end: 0 or 1 a tick, about 22% of ticks with none."""
    gen = Traffic(mix("synced"), 8, 2, 4096, 48000, 60, 9)
    sizes = []
    for k in range(1, 601):
        got = gen.packets(k)
        sizes.append(len(got))
        for s, data, ts in got:
            assert s is None and data.shape == (8, 2, 1024)
        assert np.all(gen.ends([k]) == 1024 * (800 * k // 1024))
    assert set(sizes) == {0, 1}
    assert abs(sizes.count(0) / 600 - (1 - 800 / 1024)) < 0.01


def test_frames_are_the_samples_fed():
    gen = Traffic(mix("packets"), 2, 2, 4096, 48000, 60, 1)
    fed = [d for k in range(1, 30) for s, d, _ in gen.packets(k) if s == 1]
    flat = np.concatenate(fed, axis=-1)
    end = flat.shape[-1]
    got = gen.frames(1, [end, 1000])
    assert np.array_equal(got[0], flat[:, end - 4096:])
    assert np.array_equal(got[1, :, -1000:], flat[:, :1000])
    assert not got[1, :, :-1000].any()
