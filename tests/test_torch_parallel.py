"""The port's sharded engines against the JAX package's, on 8 mesh entries.

The counterpart of ``tests/test_parallel.py``: the port runs a mesh of
``["cpu"] * 8`` and the JAX package its conftest's 8 forced CPU devices;
both take the same numpy-seeded packets through the same entry points,
with the pure-Python assembly.  Pixels, dB and meter levels agree within
1e-4 dB (JAX's own bound; exactly where the reference reads DB_MIN), the
silence latch exactly.  The engine mechanics run both packages under
``WAVEFORM_TPU_FFT_BACKEND=xla``; the kernel-bearing cases run the port's
twins and the JAX kernel in interpret mode, as ``test_parallel.py`` runs
it.  The sharded port engine is also held to the port's single engine.
"""

import numpy as np
import pytest
import torch

import waveform_tpu as jwt
from waveform_tpu.parallel import mesh as jmesh
from waveform_tpu.parallel import sharded_serving as jss
from waveform_tpu.parallel import sharded_waveform as jsw
from waveform_tpu.runtime.meter_serving import (
    MeterServingEngine as JaxMeterEngine,
)
from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    DisplayMode,
    FFTWindow,
    InterpMode,
    Settings,
    TSmoothingMode,
    resolve,
)
from waveform_tpu_torch.dsp.spectrum import init_state
from waveform_tpu_torch.kernels import exact_cuda, exactfft
from waveform_tpu_torch.parallel import (
    PIXEL_AXIS,
    ShardedMeterServingEngine,
    ShardedServingEngine,
    ShardedWaveformEngine,
    make_mesh,
    pad_stream_dim,
    padded_streams,
    shard_state,
)
from waveform_tpu_torch.parallel.mesh import Mesh, local_stream_rows
from waveform_tpu_torch.rebin.apply import make_rebin_fn
from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
from waveform_tpu_torch.runtime.serving import ServingEngine
from waveform_tpu_torch.runtime.waveform_device import DeviceWaveformEngine

from test_torch_serving import _jax_cfg

NSC = 1_000_000_000
CPU8 = ["cpu"] * 8


@pytest.fixture
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def _cfg(fft_size=256, width=128, **kw):
    return resolve(Settings(fft_size=fft_size, width=width,
                            window=FFTWindow.HANN,
                            interp_mode=InterpMode.LANCZOS, **kw),
                   AudioInfo(48000, 2))


def _mesh(pixel_parallel=1):
    return make_mesh(CPU8, pixel_parallel=pixel_parallel)


def _drive(eng, rng, S, cfg, ticks=4, read=True):
    """feed_batch + tick ``ticks`` times (``tests/test_parallel.py``'s
    schedule); returns each tick's host pixels."""
    hop = int(cfg.audio.samples_per_sec / cfg.fps)
    now, outs = NSC, []
    for _ in range(ticks):
        pkt = (0.4 * rng.standard_normal((S, 2, hop))).astype(np.float32)
        eng.feed_batch(pkt, now, now_ns=now)
        now += hop * NSC // cfg.audio.samples_per_sec
        eng.tick(now_ns=now)
        if read:
            outs.append(np.asarray(eng.read_pixels()))
    return outs


def _same(got, want, atol=1e-4):
    """Within ``atol`` where the JAX value is visible, bit for bit where it
    is DB_MIN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=atol)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])


def _three(cfg, S, pixel_parallel=1, **kw):
    """The port's sharded and single engines and JAX's sharded engine."""
    return (ShardedServingEngine(cfg, S, mesh=_mesh(pixel_parallel),
                                 use_native=False, **kw),
            ServingEngine(cfg, S, use_native=False, device="cpu", **kw),
            jss.ShardedServingEngine(_jax_cfg(cfg), S,
                                     pixel_parallel=pixel_parallel,
                                     use_native=False, **kw))


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("n,pp", [(8, 1), (8, 2), (8, 4), (6, 3)])
def test_mesh_shape_and_padding_match_jax(n, pp):
    import jax
    mesh = make_mesh(["cpu"] * n, pixel_parallel=pp)
    jm = jmesh.make_mesh(jax.devices()[:n], pixel_parallel=pp)
    assert mesh.shape == dict(jm.shape)
    for s in (1, 5, 8, 10, 33):
        assert padded_streams(mesh, s) == jmesh.padded_streams(jm, s)
        assert (local_stream_rows(mesh, padded_streams(mesh, s))
                == jmesh.local_stream_rows(jm, jmesh.padded_streams(jm, s)))
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(pad_stream_dim(x, 8),
                                  jmesh.pad_stream_dim(x, 8))


def test_make_mesh_refusals():
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 6, pixel_parallel=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()                 # the card, never the CPU
        with pytest.raises(RuntimeError):
            ShardedServingEngine(_cfg(), 4)


def test_local_stream_rows_refuses_interleaved_processes():
    """This process (rank 0) owning mesh rows 0 and 2 of 4 would own
    non-contiguous stream rows: refused, as the JAX function refuses."""
    devs = np.empty((4, 1), object)
    devs[:, 0] = [torch.device("cpu")] * 4
    mesh = Mesh(devs, np.array([[0], [1], [0], [1]]))
    with pytest.raises(ValueError, match="non-contiguous"):
        local_stream_rows(mesh, 8)
    mesh = Mesh(devs, np.array([[0], [0], [1], [1]]))
    assert local_stream_rows(mesh, 8) == (0, 4)


def test_shard_state_places_rows(rng):
    cfg = _cfg()
    state = init_state(cfg, 16, "cpu")
    state.decibels.copy_(torch.from_numpy(
        rng.standard_normal(state.decibels.shape).astype(np.float32)))
    placed = shard_state(_mesh(2), state)
    assert len(placed) == 8
    for (i, j), st in placed.items():
        np.testing.assert_array_equal(st.decibels.numpy(),
                                      state.decibels[4 * i:4 * i + 4].numpy())


# -- the pixel block and the routing switches ----------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"filter_mode": "GAUSS"}, {"display_mode": DisplayMode.BAR}],
    ids=["curve", "gauss", "bars"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "gather"])
def test_rebin_pixel_block_is_a_block_of_the_jax_rebin(kw, dense, rng):
    from waveform_tpu.rebin.apply import make_rebin_fn as jax_rebin_fn
    from waveform_tpu_torch import FilterMode
    if kw.get("filter_mode") == "GAUSS":
        kw = {"filter_mode": FilterMode.GAUSS}
    cfg = _cfg(fft_size=1024, width=200, **kw)
    x = (-60 + 20 * rng.standard_normal((3, 2, cfg.num_bins))).astype(
        np.float32)
    want = np.asarray(jax_rebin_fn(_jax_cfg(cfg), apply_pixel_map=False)(x))
    P = want.shape[-1]
    for p0, p1 in ((0, P // 2), (P // 2, P), (P // 3, P // 3 + 1)):
        got = make_rebin_fn(cfg, apply_pixel_map=False, device="cpu",
                            dense=dense, pixels=(p0, p1))(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want[..., p0:p1], rtol=0,
                                   atol=1e-4)
    with pytest.raises(ValueError):
        make_rebin_fn(cfg, device="cpu", pixels=(0, P + 1))


# -- the spectrum family -----------------------------------------------------

@pytest.mark.parametrize("pixel_parallel", [1, 2], ids=["dp8", "dp4xtp2"])
def test_sharded_serving_matches_jax(pixel_parallel, xla_backend):
    """feed_batch -> sync -> ring -> spectrum -> rebin over the mesh equals
    JAX's sharded engine and the port's single engine tick for tick."""
    cfg = _cfg()
    S = 16
    port, single, ref = _three(cfg, S, pixel_parallel)
    got, one, want = (_drive(e, np.random.default_rng(7), S, cfg)
                      for e in (port, single, ref))
    for g, o, w in zip(got, one, want):
        _same(g, w)
        np.testing.assert_array_equal(g, o)
    _same(port.read_decibels(), ref.read_decibels())
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)


def test_sharded_state_threading_matches_jax(xla_backend):
    """The EMA state chained through 4 ticks on a 4 × 2 mesh: the carried
    state (read as global leaves) equals JAX's."""
    from waveform_tpu_torch.utils.checkpoint import to_host
    cfg = _cfg()
    S = 8
    port, _, ref = _three(cfg, S, 2)
    for e in (port, ref):
        _drive(e, np.random.default_rng(9), S, cfg, read=False)
    for name in ("tsmooth", "decibels", "last_silent"):
        got = to_host(getattr(port.state, name))
        want = np.asarray(getattr(ref.state, name))
        if name == "last_silent":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_sharded_serving_pads_and_trims(xla_backend):
    """5 user streams round up to 8; outputs trim back to 5, the pad rows
    latch silent and stay at DB_MIN, and nothing leaks."""
    cfg = _cfg()
    S = 5
    port, single, ref = _three(cfg, S)
    assert port.S == ref.S == 8 and port.user_streams == 5
    got, one, want = (_drive(e, np.random.default_rng(3), S, cfg)
                      for e in (port, single, ref))
    assert got[-1].shape[0] == 5
    for g, o, w in zip(got, one, want):
        _same(g, w)
        np.testing.assert_array_equal(g, o)
    assert port.last_silent.shape == (5,)
    # the pad rows, never fed, latch silent at DB_MIN
    from waveform_tpu_torch.utils.checkpoint import to_host
    assert to_host(port.state.last_silent)[5:].all()
    assert (to_host(port.state.decibels)[5:] == np.float32(DB_MIN)).all()
    np.testing.assert_array_equal(to_host(port.state.last_silent),
                                  np.asarray(ref.state.last_silent))


def test_sharded_pixel_tiles(xla_backend):
    """Each entry of a 4 × 2 mesh holds one (stream block, pixel half)
    tile, as each JAX device holds one addressable shard."""
    cfg = _cfg()
    S = 8
    port, _, ref = _three(cfg, S, 2)
    for e in (port, ref):
        _drive(e, np.random.default_rng(1), S, cfg, ticks=1, read=False)
    tiles = port.pixels_sharded
    want = {s.data.shape for s in ref.pixels_sharded.addressable_shards}
    assert {tuple(t.data.shape) for t in tiles} == want
    assert want == {(S // 4, 1, cfg.width // 2)} and len(tiles) == 8
    jidx = {tuple((sl.start or 0, sl.stop) for sl in s.index)
            for s in ref.pixels_sharded.addressable_shards}
    pidx = {tuple((sl.start or 0, sl.stop) for sl in t.index) for t in tiles}
    assert {(r, p) for r, _, p in pidx} == {(r, p) for r, _, p in jidx}


@pytest.mark.parametrize("S", [16, 5], ids=["even", "padded"])
def test_sharded_tick_many_matches_jax(S, xla_backend):
    cfg = _cfg()
    T = 6
    hop = int(cfg.audio.samples_per_sec / cfg.fps)
    audio = (0.4 * np.random.default_rng(11).standard_normal(
        (T, S, 2, hop))).astype(np.float32)
    port, single, ref = _three(cfg, S, 2)
    want = np.asarray(ref.tick_many(audio))[:, :S]
    one = single.tick_many(audio).numpy()
    got = np.full((T, port.S) + want.shape[2:], np.nan, np.float32)
    for t in port.tick_many(audio):
        got[t.index] = t.data.numpy()
    _same(got[:, :S], want)
    np.testing.assert_array_equal(got[:, :S], one)
    _same(port.read_pixels(), ref.read_pixels())


def test_sharded_serving_normalize_volume(xla_backend):
    cfg = _cfg(normalize_volume=True)
    S = 8
    port, single, ref = _three(cfg, S)
    got, one, want = (_drive(e, np.random.default_rng(5), S, cfg)
                      for e in (port, single, ref))
    _same(got[-1], want[-1])
    np.testing.assert_array_equal(got[-1], one[-1])


def test_sharded_microbatch_flush_matches_jax(xla_backend):
    """microbatch=2: each flush runs two frames on every entry and gives
    what two single ticks give."""
    cfg = _cfg()
    S = 16
    port, _, ref = _three(cfg, S, 2, microbatch=2)
    single = ServingEngine(cfg, S, use_native=False, device="cpu")
    for e in (port, ref):
        _drive(e, np.random.default_rng(17), S, cfg, read=False)
    want = _drive(single, np.random.default_rng(17), S, cfg)
    batch = np.full((2, S, 1, cfg.width), np.nan, np.float32)
    for t in port.last_batch_pixels:
        batch[t.index] = t.data.numpy()
    np.testing.assert_array_equal(batch, np.stack(want[-2:]))
    _same(batch, np.asarray(ref.last_batch_pixels))


@pytest.mark.parametrize("keep", [[3, 1, 7], None])
def test_sharded_resized_matches_jax(keep, xla_backend):
    """Live resize across the mesh carries the kept rows, and the resized
    engines stay in lockstep with JAX's."""
    cfg = _cfg()
    S = 10
    port, _, ref = _three(cfg, S)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    _drive(port, r1, S, cfg, read=False)
    _drive(ref, r2, S, cfg, read=False)
    old = port.read_decibels()
    port2, ref2 = port.resized(6, keep=keep), ref.resized(6, keep=keep)
    rows = keep if keep is not None else list(range(6))
    assert port2.user_streams == 6
    np.testing.assert_array_equal(port2.read_decibels()[:len(rows)],
                                  old[rows])
    _same(port2.read_decibels(), ref2.read_decibels())
    for g, w in zip(_drive(port2, r1, 6, cfg), _drive(ref2, r2, 6, cfg)):
        _same(g, w)


def test_sharded_resized_across_mesh_shapes(xla_backend):
    cfg = _cfg()
    port = ShardedServingEngine(cfg, 8, mesh=_mesh(), use_native=False)
    ref = jss.ShardedServingEngine(_jax_cfg(cfg), 8, use_native=False)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    _drive(port, r1, 8, cfg, read=False)
    _drive(ref, r2, 8, cfg, read=False)
    before = port.read_decibels()
    port2 = port.resized(12, mesh=_mesh(2))
    ref2 = ref.resized(12, mesh=jmesh.make_mesh(pixel_parallel=2))
    assert port2.mesh.shape[PIXEL_AXIS] == 2 and len(port2._shards) == 8
    np.testing.assert_array_equal(port2.read_decibels()[:8], before)
    assert (port2.read_decibels()[8:] == np.float32(DB_MIN)).all()
    for g, w in zip(_drive(port2, r1, 12, cfg), _drive(ref2, r2, 12, cfg)):
        _same(g, w)


@pytest.mark.parametrize("S2,keep", [(4, [0, 1, 2, 3, 4]), (8, [5])],
                         ids=["too_many", "pad_row"])
def test_sharded_resized_rejects_bad_keep(S2, keep):
    cfg = _cfg()
    port = ShardedServingEngine(cfg, 5, mesh=_mesh(), use_native=False)
    ref = jss.ShardedServingEngine(_jax_cfg(cfg), 5, use_native=False)
    for eng in (port, ref):
        with pytest.raises(ValueError):
            eng.resized(S2, keep=keep)


def test_sharded_checkpoint_loads_across_packages(tmp_path, xla_backend):
    """A sharded engine's save is a single engine's checkpoint in either
    package, and loads back into a sharded engine with ``keep``."""
    from waveform_tpu.utils.checkpoint import load_pytree as jax_load
    cfg = _cfg()
    port, single, ref = _three(cfg, 8, 2)
    for e in (port, single):
        _drive(e, np.random.default_rng(23), 8, cfg, read=False)
    path = str(tmp_path / "ck.npz")
    port.save_state(path)
    back = ServingEngine(cfg, 8, use_native=False, device="cpu")
    back.load_state(path)
    np.testing.assert_array_equal(back.read_decibels(),
                                  single.read_decibels())
    jstate, _, _ = jax_load(path, (ref.state, ref.ring, ref.rms_ring))
    np.testing.assert_array_equal(np.asarray(jstate.decibels),
                                  single.state.decibels.numpy())
    six = ShardedServingEngine(cfg, 6, mesh=_mesh(2), use_native=False)
    six.load_state(path, keep=[5, 0, 3])
    np.testing.assert_array_equal(six.read_decibels()[:3],
                                  single.read_decibels()[[5, 0, 3]])
    assert (six.read_decibels()[3:] == np.float32(DB_MIN)).all()


def test_sharded_engine_runs_the_pair_kernel_shard_local(monkeypatch):
    """N=1024 with the kernels on: every shard runs the pair kernel (the
    port's twin here) on its rows, as the JAX engine shard_maps its
    interpret-mode kernel, and both match their single engines."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    calls = []
    real = exact_cuda.rfft_pair_mag
    monkeypatch.setattr(exact_cuda, "rfft_pair_mag",
                        lambda x, w=None, head=None: calls.append(x.shape)
                        or real(x, w, head))
    cfg = _cfg(fft_size=1024)
    S = 16
    port, single, ref = _three(cfg, S, 2)
    got, one, want = (_drive(e, np.random.default_rng(11), S, cfg, ticks=3)
                      for e in (port, single, ref))
    for g, o, w in zip(got, one, want):
        _same(g, w)
        np.testing.assert_array_equal(g, o)
    # 3 ticks: 8 shard calls of [2, 2, N] a tick, 3 single calls of [16, ...]
    assert sorted(calls) == sorted([(S // 4, 2, 1024)] * 24
                                   + [(S, 2, 1024)] * 3)


def _routes(monkeypatch):
    """Count the calls of each exact-FFT route: the pair kernel, K3, the
    digit lowering and the real-split lowering (the port's twins and
    torch ops on the CPU)."""
    calls = {}

    def count(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    count(exact_cuda, "rfft_pair_mag")
    count(exact_cuda, "cfft_exact_kernel")
    count(exactfft, "cfft_lowering")
    count(exactfft, "rfft_mag_real_lowering")
    return calls


def _route_parity(monkeypatch, n, S, ticks, seed):
    """The port's single and sharded (4x2 on 8 entries) engines and JAX's
    sharded engine on the same packets, each shard's routes counted;
    returns (the single engine's calls, the sharded engine's calls)."""
    cfg = _cfg(fft_size=n)
    calls = _routes(monkeypatch)
    single = ServingEngine(cfg, S, use_native=False, device="cpu")
    one = _drive(single, np.random.default_rng(seed), S, cfg, ticks=ticks)
    by_single = dict(calls)
    calls.clear()
    port = ShardedServingEngine(cfg, S, mesh=_mesh(2), use_native=False)
    got = _drive(port, np.random.default_rng(seed), S, cfg, ticks=ticks)
    by_port = dict(calls)
    ref = jss.ShardedServingEngine(_jax_cfg(cfg), S, pixel_parallel=2,
                                   use_native=False)
    want = _drive(ref, np.random.default_rng(seed), S, cfg, ticks=ticks)
    for g, o, w in zip(got, one, want):
        _same(g, w)
        np.testing.assert_array_equal(g, o)
    return by_single, by_port


@pytest.mark.parametrize("n,env,route", [
    (800, {}, "cfft_lowering"),
    (1024, {"WAVEFORM_TPU_EXACT_KERNEL": "never"}, "cfft_lowering"),
    (1024, {"WAVEFORM_TPU_EXACT_FUSED": "never",
            "WAVEFORM_TPU_EXACT_PACKED": "never"}, "rfft_mag_real_lowering"),
], ids=["auto800", "kernel_never", "real_split"])
def test_shards_route_as_the_single_engine(n, env, route, monkeypatch):
    """Off the pair kernel, each shard takes the single engine's route
    (the lowerings here), once an entry a tick, and the sharded engine
    agrees with JAX's (whose shards take its lowering) and bit for bit
    with the port's single engine."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    by_single, by_port = _route_parity(monkeypatch, n, 8, 2, 5)
    assert by_single == {route: 2}
    assert by_port == {route: 2 * 8}


def test_sharded_engine_runs_k3_off_the_pair_kernel(monkeypatch):
    """EXACT_FUSED=never takes the pair kernel off: each shard then runs
    the packed pair through K3 (its twin here), as the single engine
    does, and never the lowering.  The JAX sharded engine sends that
    route to its lowering instead (a ``pallas_call`` has no partitioning
    rule in its sharded program); the port's shards are programs of their
    own, and the two agree within 1e-4 dB."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    by_single, by_port = _route_parity(monkeypatch, 1024, 8, 2, 3)
    assert by_single == {"cfft_exact_kernel": 2}
    assert by_port == {"cfft_exact_kernel": 2 * 8}   # each entry, each tick


# -- the meter and waveform families -------------------------------------------

def _meter_cfg():
    return resolve(Settings(display_mode=DisplayMode.METER, meter_buf=50),
                   AudioInfo(48000, 2))


def test_sharded_meter_matches_jax():
    cfg = _meter_cfg()
    S = 16
    port = ShardedMeterServingEngine(cfg, S, mesh=_mesh(2), use_native=False)
    single = MeterServingEngine(cfg, S, use_native=False, device="cpu")
    ref = jss.ShardedMeterServingEngine(_jax_cfg(cfg), S, use_native=False)
    for e in (port, single, ref):
        _drive(e, np.random.default_rng(13), S, cfg, read=False)
    assert len(port._shards) == 4         # no pixel axis: one a row block
    _same(port.meter_values.numpy(), np.asarray(ref.meter_values))
    np.testing.assert_array_equal(port.meter_values.numpy(),
                                  single.meter_values.numpy())
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)


def test_sharded_meter_pad_trim_and_resize():
    cfg = _meter_cfg()
    port = ShardedMeterServingEngine(cfg, 5, mesh=_mesh(), use_native=False)
    ref = jss.ShardedMeterServingEngine(_jax_cfg(cfg), 5, use_native=False)
    assert port.S == 8 and port.user_streams == 5
    for e in (port, ref):
        _drive(e, np.random.default_rng(21), 5, cfg, read=False)
    vals = port.meter_values.numpy()
    assert vals.shape == (5, 2) and np.isfinite(vals).all()
    _same(vals, np.asarray(ref.meter_values))
    port2 = port.resized(9, keep=[4, 0])
    assert isinstance(port2, ShardedMeterServingEngine)
    np.testing.assert_array_equal(port2.meter_values.numpy()[:2],
                                  vals[[4, 0]])


def _wf_cfg(**kw):
    return resolve(Settings(display_mode=DisplayMode.WAVEFORM,
                            temporal_smoothing=TSmoothingMode.NONE, **kw),
                   AudioInfo(48000, 2))


def _wf_drive(eng, rng, S, ticks=6, hop=480):
    now = NSC
    for _ in range(ticks):
        for s in range(S):
            pkt = (0.4 * rng.standard_normal((2, hop))).astype(np.float32)
            eng.feed(s, pkt, now, now_ns=now)
        now += hop * NSC // 48000
        eng.tick(now_ns=now)
    return np.asarray(eng.render_values())


def test_sharded_waveform_matches_jax():
    cfg = _wf_cfg()
    S = 16
    port = ShardedWaveformEngine(cfg, S, mesh=_mesh(2), use_native=False)
    single = DeviceWaveformEngine(cfg, S, use_native=False, device="cpu")
    ref = jsw.ShardedWaveformEngine(_jax_cfg(cfg), S, use_native=False)
    got, one, want = (_wf_drive(e, np.random.default_rng(31), S)
                      for e in (port, single, ref))
    _same(got, want)
    np.testing.assert_array_equal(got, one)
    assert port.local_streams == ref.local_streams == (0, 16)
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)


def test_sharded_waveform_pad_trim_and_resize():
    cfg = _wf_cfg()
    rng = np.random.default_rng(37)
    port = ShardedWaveformEngine(cfg, 5, mesh=_mesh(), use_native=False)
    assert port.S == 8 and port.user_streams == 5
    vals = _wf_drive(port, rng, 5)
    assert vals.shape[0] == 5 and np.isfinite(vals).all()
    assert port.last_silent.shape == (5,)
    port2 = port.resized(9, keep=[4, 0])
    got = port2.render_values()
    np.testing.assert_array_equal(got[0], vals[4])
    np.testing.assert_array_equal(got[1], vals[0])
    now = NSC * 5
    pkt = (0.3 * rng.standard_normal((2, 480))).astype(np.float32)
    for s in range(2):
        port2.feed(s, pkt, now, now_ns=now)
    port2.tick(now_ns=now + 480 * NSC // 48000)
    assert np.isfinite(port2.render_values()).all()


def test_sharded_waveform_normalize_volume_and_microbatch():
    cfg = _wf_cfg(normalize_volume=True, volume_target=-6.0)
    S = 4
    want = _wf_drive(ShardedWaveformEngine(cfg, S, mesh=_mesh(),
                                           use_native=False),
                     np.random.default_rng(41), S)
    got = _wf_drive(ShardedWaveformEngine(cfg, S, mesh=_mesh(),
                                          use_native=False, microbatch=3),
                    np.random.default_rng(41), S)
    np.testing.assert_array_equal(got, want)
    ref = _wf_drive(jsw.ShardedWaveformEngine(_jax_cfg(cfg), S,
                                              use_native=False),
                    np.random.default_rng(41), S)
    _same(got, ref)


@pytest.mark.parametrize("family", ["waveform", "spectrum"])
def test_sharded_engines_refuse_cohorts(family):
    if family == "waveform":
        eng = ShardedWaveformEngine(_wf_cfg(), 4, mesh=_mesh())
    else:
        eng = ShardedServingEngine(_cfg(), 4, mesh=_mesh())
    with pytest.raises(NotImplementedError):
        eng.bind_cohort(0)
    jsw_eng = jsw.ShardedWaveformEngine(_jax_cfg(_wf_cfg()), 4)
    with pytest.raises(NotImplementedError):
        jsw_eng.bind_cohort(0)


def test_dryrun_on_the_cpu():
    from waveform_tpu_torch.dryrun import dryrun
    line = dryrun(8, device="cpu")
    assert line.startswith("dryrun OK") and "'pixel': 2" in line


def test_single_engine_jax_parity_kept(xla_backend):
    """The seam the sharded engines use leaves the single engine as it was:
    the port's ServingEngine still equals JAX's on the same packets."""
    cfg = _cfg(normalize_volume=True)
    S = 4
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False)
    for g, w in zip(_drive(port, np.random.default_rng(2), S, cfg),
                    _drive(ref, np.random.default_rng(2), S, cfg)):
        _same(g, w)
    mport = MeterServingEngine(_meter_cfg(), S, use_native=False,
                               device="cpu")
    mref = JaxMeterEngine(_jax_cfg(_meter_cfg()), S, use_native=False)
    for e in (mport, mref):
        _drive(e, np.random.default_rng(2), S, _meter_cfg(), read=False)
    _same(mport.meter_values.numpy(), np.asarray(mref.meter_values))
    assert jwt.DB_MIN == DB_MIN
