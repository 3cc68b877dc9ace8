"""The port's MultiEngine (``runtime/multi.py``) and the engines' cohort
mode against the JAX MultiEngine.

The cases mirror the ``test_multi_engine_*`` cases of
``tests/test_serving.py``, ``tests/test_waveform_device.py``'s and
``tests/test_meter_serving.py``'s: the same seeded numpy packets and clock
go into a JAX scene and a port scene (``device="cpu"``), each package
resolving the same settings with its own ``resolve``, under
``WAVEFORM_TPU_FFT_BACKEND=xla`` (the scene's mechanics are the point;
``tests/test_torch_backends.py`` holds the two xla steps together; the
exact path's case at N=1024 is ``test_torch_bus.py``'s, where the tail
of a longer ring is the kernel's input).  Spectrum and meter values must
agree within 1e-4 dB on bins above -120 dBFS, waveform displays within
1e-4 dB with DB_MIN exact, and the silence latches exactly; within the
port, a cohort member gives its standalone engine's values bit for bit.
One scene per module is shared by the cases that read it: the JAX scene
compiles a program per group.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_serving import _jax_cfg
from waveform_tpu.render import raster as jax_raster
from waveform_tpu.runtime.multi import MultiEngine as JaxMulti
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    DisplayMode,
    FFTWindow,
    FilterMode,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
from waveform_tpu_torch.runtime.multi import MultiEngine
from waveform_tpu_torch.runtime.serving import ServingEngine
from waveform_tpu_torch.runtime.waveform_device import DeviceWaveformEngine

NS, SR = 1_000_000_000, 48000
HOP = 480


def _cfg(**kw):
    return resolve(Settings(temporal_smoothing=TSmoothingMode.NONE, **kw),
                   AudioInfo(SR, 2))


def _assert_close(got, want):
    """Within 1e-4 dB where the JAX value is above -120 dBFS, DB_MIN
    exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)


SPEC_A = dict(fft_size=1024)
SPEC_B = dict(fft_size=2048, window=FFTWindow.BLACKMAN)
SPEC_N = dict(fft_size=1024, normalize_volume=True)   # its own width: solo
METER = dict(display_mode=DisplayMode.METER, meter_buf=100, rms_mode=True)
WF_A = dict(display_mode=DisplayMode.WAVEFORM, width=128, meter_buf=100)
WF_B = dict(display_mode=DisplayMode.WAVEFORM, width=128, meter_buf=100,
            fast_peaks=True)
# (settings, streams): the scene of the shared fixture
GROUPS = [(SPEC_A, 2), (SPEC_B, 1), (METER, 2), (SPEC_N, 1), (WF_A, 2),
          (WF_B, 1)]
TICKS = 24
HIDE = (3, 12)     # (group, tick): group 3's stream hidden from this tick


def _packet(rng, k, s):
    """Noise (a quiet stretch for stream 1 of each group)."""
    amp = 0.0 if (s == 1 and 8 <= k < 14) else 0.3 + 0.1 * s
    return (amp * rng.standard_normal((2, HOP))).astype(np.float32)


def _make_engine(cfg, n):
    if cfg.spectrum_mode:
        return ServingEngine(cfg, n, device="cpu")
    if cfg.meter_mode:
        return MeterServingEngine(cfg, n, device="cpu")
    return DeviceWaveformEngine(cfg, n, device="cpu")


@pytest.fixture(scope="module")
def scene():
    """The JAX scene, the port scene and the port's standalone engines,
    fed the same packets for TICKS ticks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
        cfgs = [_cfg(**kw) for kw, _ in GROUPS]
        port, ref = MultiEngine(device="cpu"), JaxMulti()
        ids = []                    # (group, row, port handle, JAX handle)
        for g, (cfg, (_, n)) in enumerate(zip(cfgs, GROUPS)):
            for r in range(n):
                ids.append((g, r, port.add_stream(cfg),
                            ref.add_stream(_jax_cfg(cfg))))
        solo = [_make_engine(cfg, n) for cfg, (_, n) in zip(cfgs, GROUPS)]
        rng = np.random.default_rng(40)
        now = NS
        for k in range(TICKS):
            if k == HIDE[1]:
                for g, r, sp, sj in ids:
                    if g == HIDE[0]:
                        port.set_show(sp, False)
                        ref.set_show(sj, False)
                        solo[g].set_show(r, False)
            for g, r, sp, sj in ids:
                x = _packet(rng, k, r)
                port.feed(sp, x, now, now_ns=now)
                ref.feed(sj, x, now, now_ns=now)
                solo[g].feed(r, x, now, now_ns=now)
            now += HOP * NS // SR
            port.tick(now_ns=now)
            ref.tick(now_ns=now)
            for e in solo:
                e.tick(now_ns=now)
        yield dict(port=port, ref=ref, solo=solo, ids=ids, cfgs=cfgs,
                   now=now)


STREAMS = [(g, r) for g, (_, n) in enumerate(GROUPS) for r in range(n)]


@pytest.mark.parametrize("g,r", STREAMS)
def test_scene_matches_jax(scene, g, r):
    """Every stream of the heterogeneous scene (two spectrum sizes, a
    meter, a normalized spectrum group ticking solo, two waveform looks;
    a quiet stretch, a hidden group) against the JAX scene."""
    _, _, sp, sj = next(i for i in scene["ids"] if i[:2] == (g, r))
    _assert_close(scene["port"].read_decibels(sp),
                  scene["ref"].read_decibels(sj))


@pytest.mark.parametrize("g", range(len(GROUPS)))
def test_cohort_matches_solo_engines(scene, g):
    """Cohort fusion is a transfer-layer change only: each group's values
    equal its standalone engine's, fed the same packets, bit for bit; the
    silence latch too."""
    port, cfg = scene["port"], scene["cfgs"][g]
    eng, solo = port._engines[cfg], scene["solo"][g]
    np.testing.assert_array_equal(eng.last_silent, solo.last_silent)
    if isinstance(solo, ServingEngine):
        np.testing.assert_array_equal(eng.read_decibels(),
                                      solo.read_decibels())
    else:
        np.testing.assert_array_equal(eng.render_values(),
                                      solo.render_values())


def test_cohorts_group_by_packed_width(scene):
    """Spectrum and meter groups of one width share a cohort, the two
    waveform groups another, the normalized group (wider rows) ticks
    solo — as the JAX scene groups them; each member's segment holds its
    ``_stride`` floats without overlap."""
    port, ref, cfgs = scene["port"], scene["ref"], scene["cfgs"]
    assert port.num_groups == ref.num_groups == len(GROUPS)
    got = [sorted(cfgs.index(e.cfg) for e in c["engines"])
           for c in port._cohorts]
    jcfgs = [_jax_cfg(c) for c in cfgs]
    want = [sorted(jcfgs.index(e.cfg) for e in c["engines"])
            for c in ref._cohorts]
    assert got == want == [[0, 1, 2], [4, 5]]
    assert [cfgs.index(e.cfg) for e in port._solo] == [3]
    for c in port._cohorts:
        spans = sorted((o, o + e._stride)
                       for e, o in zip(c["engines"], c["offs"]))
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert c["used"] == spans[-1][1] <= c["dev"].numel()
        for e, o in zip(c["engines"], c["offs"]):
            assert e._row0 == o and e._cohort_block is c["dev"]
    assert isinstance(port._engines[cfgs[2]], MeterServingEngine)
    assert isinstance(port._engines[cfgs[4]], DeviceWaveformEngine)
    assert scene["port"].config_of(scene["ids"][0][2]) is cfgs[0]


def test_hidden_group_decays_to_db_min(scene):
    """set_show(False) on a scene stream: its graph decays like a capture
    timeout (the reference's show()/hide(), source.hpp:314-346)."""
    sp = next(i[2] for i in scene["ids"] if i[0] == HIDE[0])
    assert (scene["port"].read_decibels(sp) == np.float32(DB_MIN)).all()


def test_render_frames_match_jax_renderer(scene):
    """Whole-scene rasterization: a frame per stream, shaped by its own
    config, each equal within 1e-6 to the JAX renderer's frame of the
    port's values (the jitted ``jax.vmap`` of the JAX ``make_renderer``,
    as the JAX scene renders a group); every fed look renders content."""
    port, cfgs = scene["port"], scene["cfgs"]
    frames = port.render_frames()
    assert set(frames) == {i[2] for i in scene["ids"]}
    for g, cfg in enumerate(cfgs):
        eng = port._engines[cfg]
        vals = (eng._display_values(eng.state) if isinstance(
            eng, ServingEngine) else eng.display).numpy()
        want = np.asarray(jax.jit(jax.vmap(jax_raster.make_renderer(
            _jax_cfg(cfg))))(vals))
        for r, sp in [(i[1], i[2]) for i in scene["ids"] if i[0] == g]:
            assert frames[sp].shape == (cfg.height, cfg.width, 4)
            np.testing.assert_allclose(frames[sp], want[r], rtol=0,
                                       atol=1e-6)
            if g != HIDE[0]:
                assert frames[sp][..., 3].max() > 0.5


def _drive(scenes, sids, now, ticks, seed):
    """Feed seeded noise to the streams ``sids`` [(port, JAX) handles] of
    both scenes and tick them."""
    rng = np.random.default_rng(seed)
    port, ref = scenes
    for _ in range(ticks):
        for sp, sj in sids:
            x = (0.3 * rng.standard_normal((2, HOP))).astype(np.float32)
            port.feed(sp, x, now, now_ns=now)
            ref.feed(sj, x, now, now_ns=now)
        now += HOP * NS // SR
        port.tick(now_ns=now)
        ref.tick(now_ns=now)
    return now


def _graphs(port):
    """{cfg: (the engine, its cohort GraphTicks by kind key)}."""
    return {cfg: (e, {k: t for k, t in e._ticks.items()
                      if k[0] == "cohort"})
            for cfg, e in port._engines.items()}


def test_live_add_remove_update(monkeypatch):
    """Streams join, leave and change config on a RUNNING scene: the
    edited group's engine resizes with every surviving row's state carried
    over bit for bit, every other group keeps its engine, its cohort
    segment and its captured ticks, and the scene goes on matching the
    JAX scene through the same edits (OBS adds, removes and updates
    sources at any time, src/source.cpp:1077-1322)."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
    a_cfg, b_cfg = _cfg(**SPEC_A), _cfg(**SPEC_B)
    m_cfg, w_cfg = _cfg(**METER), _cfg(**WF_A)
    port, ref = MultiEngine(device="cpu"), JaxMulti()

    def add(cfg):
        return port.add_stream(cfg), ref.add_stream(_jax_cfg(cfg))

    a, b, m, w = add(a_cfg), add(b_cfg), add(m_cfg), add(w_cfg)
    now = _drive((port, ref), [a, b, m, w], NS, 12, 1)
    live = [a, b, m, w]

    def check_edit(edit, edited, moved=None):
        before = {sj: port.read_decibels(sp) for sp, sj in live
                  if (sp, sj) != moved}
        graphs = _graphs(port)
        edit()
        for cfg, (eng, ticks) in graphs.items():
            if cfg in edited or cfg not in port._engines:
                continue
            assert port._engines[cfg] is eng
            now_ticks = _graphs(port)[cfg][1]
            assert all(now_ticks[k] is t for k, t in ticks.items()), cfg
        for sp, sj in live:
            if sp in port._streams and sj in before:
                np.testing.assert_array_equal(port.read_decibels(sp),
                                              before[sj])

    a2 = add(a_cfg)
    check_edit(lambda: None, ())
    live.append(a2)
    now = _drive((port, ref), live, now, 6, 2)
    # the first stream of a group leaves (rows re-index)
    check_edit(lambda: (port.remove_stream(a[0]), ref.remove_stream(a[1])),
               (a_cfg,))
    live.remove(a)
    now = _drive((port, ref), live, now, 6, 3)
    check_edit(lambda: (port.update_stream(b[0], m_cfg),
                        ref.update_stream(b[1], _jax_cfg(m_cfg))),
               (b_cfg, m_cfg), moved=b)
    assert port.config_of(b[0]) is m_cfg and port.num_groups == 3
    now = _drive((port, ref), live, now, 8, 4)
    for sp, sj in live:
        _assert_close(port.read_decibels(sp), ref.read_decibels(sj))
    # the group's last stream leaves: the group goes
    port.remove_stream(w[0])
    ref.remove_stream(w[1])
    assert port.num_groups == ref.num_groups == 2
    live.remove(w)
    now = _drive((port, ref), live, now, 3, 5)
    for sp, sj in live:
        _assert_close(port.read_decibels(sp), ref.read_decibels(sj))
    frames = port.render_frames()
    assert set(frames) == {sp for sp, _ in live}


def test_placement_keeps_members_and_reuses_gaps():
    """The cohort placement: survivors keep their offsets, a resized
    group takes the first gap that holds it, the block is reallocated
    (and packed) only when it runs out of room."""
    from waveform_tpu_torch.runtime.multi import _place

    class E:
        def __init__(self, n):
            self._stride = n

    e1, e2, e3 = E(10), E(20), E(10)
    prev = {"engines": [e1, e2, e3], "offs": [0, 10, 30]}
    e2b = E(25)                           # e2 grows: to the end
    assert _place([e1, e2b, e3], prev) == [0, 40, 30]
    e2c = E(15)                           # shrinks: into its old gap
    assert _place([e1, e2c, e3], prev) == [0, 10, 30]
    assert _place([e3, E(5), E(5)], prev) == [30, 0, 5]


def test_sixteen_groups(monkeypatch):
    """A 16-source scene, every source a distinct config (window, filter,
    cutoff), ticking together: every stream within 1e-4 dB of the JAX
    scene (noise-dominated input, as the other parity cases) and peaking
    on its own bin-exact tone."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
    port, ref = MultiEngine(device="cpu"), JaxMulti()
    sids, freqs = [], []
    for g in range(16):
        n = (256, 512, 1024)[g % 3]
        cfg = _cfg(fft_size=n,
                   window=(FFTWindow.HANN, FFTWindow.BLACKMAN)[g % 2],
                   filter_mode=(FilterMode.NONE, FilterMode.GAUSS)[g // 8],
                   cutoff_high=17000 - 100 * g)
        sids.append((port.add_stream(cfg), ref.add_stream(_jax_cfg(cfg))))
        freqs.append((SR / n * (4 + 2 * g), n))
    rng = np.random.default_rng(16)
    now = NS
    for k in range(8):
        t = (np.arange(HOP) + k * HOP) / SR
        for (sp, sj), (f, n) in zip(sids, freqs):
            x = (0.3 * np.sin(2 * np.pi * f * t)
                 + 0.3 * rng.standard_normal(HOP)).astype(np.float32)
            port.feed(sp, np.stack([x, x]), now, now_ns=now)
            ref.feed(sj, np.stack([x, x]), now, now_ns=now)
        now += HOP * NS // SR
        port.tick(now_ns=now)
        ref.tick(now_ns=now)
    assert port.num_groups == 16 and len(port._cohorts) == 1
    for (sp, sj), (f, n) in zip(sids, freqs):
        db = port.read_decibels(sp)
        _assert_close(db, ref.read_decibels(sj))
        assert abs(int(np.argmax(db[0])) * SR / n - f) < 2 * SR / n


def test_multi_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiEngine()
