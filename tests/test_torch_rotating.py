"""The rotating sample ring (``dsp/devring.py``) read at its heads, on the
CPU: the pair kernels' twins with heads against the same twins on the
windows put in order, and a spectrum engine on a rotating ring against
one on the shifting ring, through ticks, checkpoints and resizes.

On the card an engine rotates its ring only where the step's exact pair
kernels read it (``dsp/spectrum.reads_rotating_ring``); the CPU engines
here are put on it by replacing that rule in ``runtime/serving``, so the
CPU twins run the same path.  The card's tests are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from waveform_tpu_torch import (
    AudioInfo,
    DisplayMode,
    FFTWindow,
    Settings,
    resolve,
)
from waveform_tpu_torch.dsp import devring
from waveform_tpu_torch.dsp.spectrum import reads_rotating_ring
from waveform_tpu_torch.kernels import exact_cuda, exactfft
from waveform_tpu_torch.kernels.ring_cuda import unrolled
from waveform_tpu_torch.runtime import profiler, serving
from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
from waveform_tpu_torch.runtime.serving import ServingEngine

NS = 1_000_000_000


def _hann(n):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def _heads(rng, shape, n):
    """Random heads in [0, n), the first 0 and the last n - 1."""
    h = rng.integers(0, n, size=shape).astype(np.int32)
    h.flat[0], h.flat[-1] = 0, n - 1
    return torch.from_numpy(h)


def _rolled(x, head):
    """Each row of ``x`` rolled to start at its head: torch.roll, row by
    row."""
    out = torch.empty_like(x)
    for idx in np.ndindex(*head.shape):
        out[idx] = torch.roll(x[idx], -int(head[idx]))
    return out


@pytest.mark.parametrize("tier", ["f32", "df"])
@pytest.mark.parametrize("body,n", [("rfft_pair_mag3", 4096),
                                    ("rfft_pair_mag_gen", 1024),
                                    ("rfft_pair_mag_gen", 4096)])
def test_twins_read_the_heads(body, n, tier):
    """K2's and K1-gen's twins at both tiers, given the rows' heads,
    equal the same twin on the rows rolled to their heads, bit for bit
    (magnitudes and nonzero counts)."""
    rng = np.random.default_rng(n + len(body) + len(tier))
    x = torch.from_numpy((0.4 * rng.standard_normal((3, 2, n)))
                         .astype(np.float32))
    x[1, 0, : n // 3] = 0.0
    x[-1, -1] = 0.0
    head = _heads(rng, (3, 2), n)
    fn = getattr(exact_cuda, body)
    mag, nz = fn(x, _hann(n), twiddle=tier, head=head)
    want, want_nz = fn(_rolled(x, head), _hann(n), twiddle=tier)
    assert torch.equal(mag, want) and torch.equal(nz, want_nz)
    assert torch.equal(unrolled(x, head), _rolled(x, head))


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_rfft_mag_exact_reads_the_heads(channels):
    """The router with heads: channel pairs and the lone channel (rows of
    different streams paired, an odd stream count padded) give the
    in-order windows' spectrum bit for bit."""
    n, S = 1024, 3
    rng = np.random.default_rng(channels)
    x = torch.from_numpy((0.4 * rng.standard_normal((S, channels, n)))
                         .astype(np.float32))
    x[0, -1] = 0.0
    head = _heads(rng, (S, channels), n)
    mag, nz = exactfft.rfft_mag_exact(x, _hann(n), head)
    want, want_nz = exactfft.rfft_mag_exact(_rolled(x, head), _hann(n))
    assert torch.equal(mag, want) and torch.equal(nz, want_nz)


@pytest.mark.parametrize("variable", ["WAVEFORM_TPU_EXACT_KERNEL",
                                      "WAVEFORM_TPU_EXACT_FUSED"])
def test_paths_without_the_pair_kernel_read_in_order(variable, monkeypatch):
    """Where the pair kernel does not run (the digit lowering, the packed
    pair), only windows in order are read: a rotating ring's heads raise
    ValueError at the router and at the pair router, and the same rows
    in order give the result they gave before."""
    n = 1024
    rng = np.random.default_rng(len(variable))
    x = torch.from_numpy((0.4 * rng.standard_normal((2, 2, n)))
                         .astype(np.float32))
    head = _heads(rng, (2, 2), n)
    want, want_nz = exactfft.rfft_mag_exact(_rolled(x, head), _hann(n))
    monkeypatch.setenv(variable, "never")
    with pytest.raises(ValueError, match="rotating ring"):
        exactfft.rfft_mag_exact(x, _hann(n), head)
    with pytest.raises(ValueError, match="rotating ring"):
        exactfft.rfft_pair_mag_exact(x, _hann(n), head)
    mag, nz = exactfft.rfft_mag_exact(_rolled(x, head), _hann(n))
    assert torch.equal(nz, want_nz)
    np.testing.assert_allclose(mag.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.max()))


# -- the engine ------------------------------------------------------------

def _cfg(channels=2, fft_size=1024, **kw):
    return resolve(Settings(fft_size=fft_size, width=200,
                            window=FFTWindow.HANN, **kw),
                   AudioInfo(48000, channels))


def _engine(monkeypatch, cfg, S, rotating, **kw):
    """A CPU spectrum engine on a rotating (or the shifting) ring."""
    monkeypatch.setattr(serving, "reads_rotating_ring",
                        lambda *args: rotating)
    eng = ServingEngine(cfg, S, use_native=False, device="cpu", **kw)
    assert (eng._ring.head is not None) == rotating == eng._rotating
    return eng


def _drive(engines, rng, S, C, ticks, now, per_stream=False):
    """``ticks`` ticks of 480-frame packets: one feed_batch a tick (the
    batch shift), or per-stream feeds that skip a stream now and then
    (the gather).  Returns each engine's pixels a tick and the clock."""
    pixels = [[] for _ in engines]
    for k in range(ticks):
        x = (0.4 * rng.standard_normal((S, C, 480))).astype(np.float32)
        x[-1] = 0.0
        for eng, px in zip(engines, pixels):
            if per_stream:
                for s in range(S):
                    if (s + k) % 3:
                        eng.feed(s, x[s], now, now_ns=now)
            else:
                eng.feed_batch(x, now, now_ns=now)
            out = eng.tick(now_ns=now)
            # a sharded engine's tiles are left out
            px.append(out.clone() if isinstance(out, torch.Tensor) else None)
        now += 10_000_000
    return pixels, now


def _same_state(a, b):
    """The public rings (the windows in order) and the state, bit for
    bit; ``b``'s public ring is its raw ring put in order."""
    assert torch.equal(a.ring.buf, b.ring.buf)
    assert a.ring.head is None and b.ring.head is None
    assert torch.equal(b.ring.buf, devring.window(b._ring))
    for f in vars(a.state):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("per_stream", [False, True],
                         ids=["batch", "per_stream"])
@pytest.mark.parametrize("channels", [1, 2])
def test_rotating_engine_equals_the_shifting_one(channels, per_stream,
                                                 monkeypatch):
    """Pixels tick by tick, the windows and the state bit for bit, with
    the heads past a wrap of the ring."""
    cfg, S = _cfg(channels), 3
    shift = _engine(monkeypatch, cfg, S, False)
    rot = _engine(monkeypatch, cfg, S, True)
    rng = np.random.default_rng(channels + 10 * per_stream)
    (a, b), _ = _drive([shift, rot], rng, S, channels, 6, NS, per_stream)
    for k, (pa, pb) in enumerate(zip(a, b)):
        assert torch.equal(pa, pb), k
    _same_state(shift, rot)
    assert rot._ring.head.any()


def test_checkpoint_at_a_nonzero_head(monkeypatch, tmp_path):
    """A rotating engine saves the shifting one's file; its file, and the
    shifting one's, load into a rotating engine whose heads are not 0
    (with and without a row migration) and tick on as the shifting engine
    does."""
    cfg, S = _cfg(), 3
    shift = _engine(monkeypatch, cfg, S, False)
    rot = _engine(monkeypatch, cfg, S, True)
    rng = np.random.default_rng(21)
    _, now = _drive([shift, rot], rng, S, 2, 5, NS)
    assert rot._ring.head.any()
    paths = {}
    for name, eng in (("shift", shift), ("rot", rot)):
        paths[name] = str(tmp_path / f"{name}.npz")
        eng.save_state(paths[name])
    a, b = np.load(paths["shift"]), np.load(paths["rot"])
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])
    for keep in (None, [2, 0]):
        dst_shift = _engine(monkeypatch, cfg, S, False)
        dst_rot = _engine(monkeypatch, cfg, S, True)
        _, t = _drive([dst_shift, dst_rot], rng, S, 2, 3, now)
        assert dst_rot._ring.head.any()
        dst_shift.load_state(paths["shift"], keep=keep)
        dst_rot.load_state(paths["rot"], keep=keep)
        _same_state(dst_shift, dst_rot)
        assert not dst_rot._ring.head.any()
        (pa, pb), _ = _drive([dst_shift, dst_rot], rng, S, 2, 3, t)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_resized_at_a_nonzero_head(monkeypatch):
    """``resized`` of a rotating engine carries the windows in order: the
    same rows, state and later pixels as the shifting engine's resize."""
    cfg, S = _cfg(), 3
    shift = _engine(monkeypatch, cfg, S, False)
    rot = _engine(monkeypatch, cfg, S, True)
    rng = np.random.default_rng(31)
    _, now = _drive([shift, rot], rng, S, 2, 4, NS)
    assert rot._ring.head.any()
    monkeypatch.setattr(serving, "reads_rotating_ring", lambda *args: False)
    big_shift = shift.resized(4, keep=[2, 0])
    monkeypatch.setattr(serving, "reads_rotating_ring", lambda *args: True)
    big_rot = rot.resized(4, keep=[2, 0])
    assert big_rot._ring.head is not None and not big_rot._ring.head.any()
    _same_state(big_shift, big_rot)
    (pa, pb), _ = _drive([big_shift, big_rot], rng, 4, 2, 3, now)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_sharded_engine_on_rotating_shards(monkeypatch, tmp_path):
    """A sharded engine whose shards rotate: its global ring, its file and
    its resize are the shifting shards', and so are its pixels."""
    from waveform_tpu_torch.parallel import ShardedServingEngine, make_mesh
    from waveform_tpu_torch.utils.checkpoint import to_host

    cfg, S = _cfg(), 4
    mesh = make_mesh(["cpu"] * 2)
    engines = {}
    for rotating in (False, True):
        monkeypatch.setattr(serving, "reads_rotating_ring",
                            lambda *args, r=rotating: r)
        engines[rotating] = ShardedServingEngine(cfg, S, mesh=mesh,
                                                 use_native=False)
    shift, rot = engines[False], engines[True]
    assert rot._rotating and not shift._rotating
    rng = np.random.default_rng(41)
    _, now = _drive([shift, rot], rng, S, 2, 4, NS)
    np.testing.assert_array_equal(shift.read_decibels(), rot.read_decibels())
    np.testing.assert_array_equal(to_host(shift.ring), to_host(rot.ring))
    shift.save_state(str(tmp_path / "a.npz"))
    rot.save_state(str(tmp_path / "b.npz"))
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])
    big = {r: e.resized(5, keep=[3, 1]) for r, e in engines.items()}
    _drive([big[False], big[True]], rng, 5, 2, 3, now)
    np.testing.assert_array_equal(big[False].read_decibels(),
                                  big[True].read_decibels())


def test_ticks_on_a_rotating_ring_are_counted(monkeypatch):
    """``ticks.rotating`` counts each tick served on a rotating ring, as
    ``ticks.uniform`` and ``ticks.gather`` count every tick; none on the
    shifting ring."""
    cfg, S = _cfg(), 3
    rng = np.random.default_rng(51)
    for rotating, per_stream in ((True, False), (True, True), (False, False)):
        eng = _engine(monkeypatch, cfg, S, rotating)
        profiler.reset()
        profiler.set_tracing(True)
        try:
            _drive([eng], rng, S, 2, 4, NS, per_stream)
            counters = profiler.snapshot()["counters"]
        finally:
            profiler.set_tracing(False)
            profiler.reset()
        ticks = counters.get("ticks.uniform", 0) + counters.get(
            "ticks.gather", 0)
        assert ticks == 4
        assert counters.get("ticks.rotating", 0) == (4 if rotating else 0)


def test_layout_rule(monkeypatch):
    """The ring rotates only where the step's exact pair kernels read it:
    on a CUDA device, the exact backend, no caller's rfft_fn, an N the
    pair kernels take.  A CPU engine, an engine on another backend and a
    meter engine keep the shifting ring."""
    cfg = _cfg(fft_size=4096)
    assert reads_rotating_ring(cfg, None, "cuda")
    assert not reads_rotating_ring(cfg, None, "cpu")
    assert not reads_rotating_ring(cfg, torch.fft.rfft, "cuda")
    small = resolve(Settings(auto_fft_size=True, width=200),
                    AudioInfo(48000, 2))
    assert not reads_rotating_ring(small, None, "cuda")
    for name, value in (("WAVEFORM_TPU_FFT_BACKEND", "xla"),
                        ("WAVEFORM_TPU_FFT_BACKEND", "matmul"),
                        ("WAVEFORM_TPU_EXACT_KERNEL", "never"),
                        ("WAVEFORM_TPU_EXACT_FUSED", "never")):
        with monkeypatch.context() as m:
            m.setenv(name, value)
            assert not reads_rotating_ring(cfg, None, "cuda"), (name, value)
    assert ServingEngine(cfg, 2, use_native=False,
                         device="cpu")._ring.head is None
    with monkeypatch.context() as m:
        m.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
        assert ServingEngine(cfg, 2, use_native=False,
                             device="cpu")._ring.head is None
    monkeypatch.setattr(serving, "reads_rotating_ring", lambda *args: True)
    meter = MeterServingEngine(
        resolve(Settings(display_mode=DisplayMode.METER, meter_buf=100),
                AudioInfo(48000, 2)), 2, use_native=False, device="cpu")
    assert meter._ring.head is None and not meter._rotating


@pytest.mark.parametrize("variable", ["WAVEFORM_TPU_EXACT_KERNEL",
                                      "WAVEFORM_TPU_EXACT_FUSED"])
def test_a_route_changed_after_construction_fails_loudly(variable,
                                                         monkeypatch):
    """An engine chooses its ring's layout once, when it is built: where
    the FFT's route changes afterwards so that the pair kernel would not
    read the rotating ring, its next tick raises ValueError rather than
    read the rows out of order; a shifting engine ticks on."""
    cfg, S = _cfg(), 2
    rot = _engine(monkeypatch, cfg, S, True)
    shift = _engine(monkeypatch, cfg, S, False)
    rng = np.random.default_rng(61)
    _, now = _drive([rot, shift], rng, S, 2, 2, NS)
    monkeypatch.setenv(variable, "never")
    x = (0.4 * rng.standard_normal((S, 2, 480))).astype(np.float32)
    rot.feed_batch(x, now, now_ns=now)
    with pytest.raises(ValueError, match="rotating ring"):
        rot.tick(now_ns=now)
    shift.feed_batch(x, now, now_ns=now)
    assert torch.isfinite(shift.tick(now_ns=now)).all()


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_other_backends_refuse_heads(backend, monkeypatch):
    """A step built on a backend other than the exact one reads only
    windows in order: given a rotating ring's heads it raises
    ValueError."""
    from waveform_tpu_torch.dsp.spectrum import init_state, make_spectrum_step

    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", backend)
    cfg, S = _cfg(), 2
    step = make_spectrum_step(cfg, device="cpu")
    x = torch.zeros((S, 2, cfg.fft_size))
    args = (x, init_state(cfg, S, "cpu"), 1 / 60,
            torch.ones(S, dtype=torch.bool), torch.zeros(S))
    step(*args)
    with pytest.raises(ValueError, match="reads no rotating ring"):
        step(*args, head=torch.zeros((S, 2), dtype=torch.int32))
