"""The port's CUDA kernels and engine on the card.

Marked ``cuda``; every test skips without a CUDA device.  On a machine
with one, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    ChannelMode,
    FFTWindow,
    InterpMode,
    Settings,
    resolve,
)
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.runtime.graphs import COUNTERS
from waveform_tpu_torch.runtime.serving import ServingEngine

pytestmark = pytest.mark.cuda

TOL = 2.5e-7
K1_SIZES = (1024, 2048, 4096)   # N1 = 8, 16, 32: K1's sizes, K1-gen's now


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _counts():
    """(K2, K3, K1-gen) launch counts."""
    return (exact_cuda.launches3, exact_cuda.launches_cfft,
            exact_cuda.launches_gen)


def _hann(n, dev):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return w64, (torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev))


@pytest.mark.parametrize("S", [1, 5, 256])
@pytest.mark.parametrize("n", K1_SIZES)
def test_kernel_matches_twin_and_f64(n, S, dev):
    """K1's sizes through the router: one K1-gen launch and no other
    kernel, bit for bit against the twin, within 2.5e-7 of float64."""
    rng = np.random.default_rng(n + S)
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[-1, -1] = 0.0
    w64, win = _hann(n, dev)
    xd = torch.from_numpy(x).to(dev)
    before = _counts()
    mag, nz = exact_cuda.rfft_pair_mag(xd, win)
    torch.cuda.synchronize()
    assert _counts() == (*before[:2], before[2] + 1)
    ref, nz_ref = exact_cuda.rfft_pair_mag_ref(xd, win)
    assert _counts() == (*before[:2], before[2] + 1)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
    want = np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]
    got = mag.cpu().numpy().astype(np.float64)
    assert np.abs(got - want).max() / want.max() <= TOL
    np.testing.assert_array_equal(nz.cpu().numpy(),
                                  np.count_nonzero(x, axis=-1))


def _bad_streams(x, rng):
    """Streams 1, 3 and 4 of ``x`` [S, 2, N] (S >= 7) silent, 1e20 and
    with one NaN sample; returns the streams a float64 bound applies to."""
    if x.shape[0] < 7:
        return list(range(x.shape[0]))
    x[1] = 0.0
    x[3] = 1e20 * rng.standard_normal(x.shape[1:])
    x[4, 0, 11] = np.nan
    return [s for s in range(x.shape[0]) if s not in (3, 4)]


def _same_bits(a, b):
    """Bit for bit, NaN lanes by position."""
    return torch.equal(torch.nan_to_num(a, nan=-1.0),
                       torch.nan_to_num(b, nan=-1.0))


@pytest.mark.parametrize("S", [1, 7, 32])
@pytest.mark.parametrize("n", (4096,) + exact_cuda.SIZES3)
def test_k2_matches_twin_and_f64(n, S, dev):
    """K2 at every size it serves, bit for bit against its twin with a
    silent, a 1e20 and a NaN stream (NaN lanes by position): through the
    router at 32768 and 65536, through its direct entry point below (the
    router sends 4096, 8192 and 16384 to K1-gen)."""
    rng = np.random.default_rng(n + S + 7)
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[-1, -1] = 0.0
    good = _bad_streams(x, rng)
    w64, win = _hann(n, dev)
    xd = torch.from_numpy(x).to(dev)
    call = (exact_cuda.rfft_pair_mag if exact_cuda.stage1_split(n) == 3
            else exact_cuda.rfft_pair_mag3)
    before = _counts()
    mag, nz = call(xd, win)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2])
    ref, nz_ref = exact_cuda.rfft_pair_mag3_ref(xd, win)
    assert _same_bits(mag, ref) and torch.equal(nz, nz_ref)
    want = np.abs(np.fft.rfft(x[good].astype(np.float64) * w64))[..., :n // 2]
    got = mag.cpu().numpy()[good].astype(np.float64)
    assert np.abs(got - want).max() / want.max() <= TOL
    np.testing.assert_array_equal(nz.cpu().numpy(),
                                  np.count_nonzero(x, axis=-1))


def test_k2_runs_on_the_int8_tensor_cores(dev):
    """The SASS of the built library: every kernel (stage 1 and stage 2 of
    K2, K2-df, K1-gen, K1-df and K3) holds int8 tensor-core products (IMMA
    from mma.sync, or IGMMA from wgmma) and no __dp4a (IDP.4A)."""
    counts = exact_cuda.sass_counts()
    assert len(counts) == 10, counts
    for fn, c in counts.items():
        assert c["IMMA"] + c["IGMMA"] > 0 and c["IDP.4A"] == 0, (fn, c)
    cfft = [fn for fn in counts if "exact_cfft_stage" in fn]
    assert len(cfft) == 2, cfft


def test_corrupt_streams_isolated_on_card(dev):
    n = 4096
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((6, 2, n))).astype(np.float32)
    x[2] = 1e20 * rng.standard_normal((2, n))
    x[4, 1, 100] = np.nan
    mag, _ = exact_cuda.rfft_pair_mag(torch.from_numpy(x).to(dev))
    got = mag.cpu().numpy().astype(np.float64)
    want = np.abs(np.fft.rfft(x.astype(np.float64)))[..., :n // 2]
    for s in (0, 1, 3, 5):
        assert np.abs(got[s] - want[s]).max() / want[s].max() <= TOL, s
    assert np.isfinite(got[2]).all()


def test_wrapper_raises_instead_of_falling_back(dev):
    x = torch.zeros((2, 2, 1040), device=dev)      # N % 128 != 0
    with pytest.raises(NotImplementedError):
        exact_cuda.rfft_pair_mag(x)
    y = torch.zeros((2, 2, 2048), device=dev).transpose(0, 1)
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag(y)


@pytest.mark.parametrize("per_stream", [False, True])
def test_engine_on_card_matches_cpu_port(per_stream, dev):
    """The card engine against the CPU port: the headline configuration
    fed in lockstep (scalar ring push), and stereo with volume
    normalization and roll-off fed per stream (ring gather, RMS ring)."""
    if per_stream:
        settings = Settings(fft_size=2048, width=400,
                            channel_mode=ChannelMode.STEREO,
                            normalize_volume=True, rolloff_q=1.0,
                            rolloff_rate=6.0)
    else:
        settings = Settings(fft_size=4096, width=800, window=FFTWindow.HANN,
                            interp_mode=InterpMode.LANCZOS)
    cfg = resolve(settings, AudioInfo(48000, 2))
    S = 4
    card = ServingEngine(cfg, S, device=dev)
    cpu = ServingEngine(cfg, S, device="cpu")
    rng = np.random.default_rng(2)
    before = _counts()
    for k in range(8):
        x = (0.3 * rng.standard_normal((S, 2, 800))).astype(np.float32)
        x[-1] = 0.0
        now = 10_000_000_000 + k * 16_666_667
        for eng in (card, cpu):
            if per_stream:
                for s in range(S):
                    eng.feed(s, x[s, :, :800 - 50 * s], now, now_ns=now)
            else:
                eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    assert _counts() == (*before[:2], before[2] + 8)
    db, want = card.read_decibels(), cpu.read_decibels()
    vis = want > -120.0
    np.testing.assert_allclose(db[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(db[floor], want[floor])
    np.testing.assert_array_equal(card.last_silent, cpu.last_silent)
    assert np.isfinite(card.read_pixels()).all()


def test_large_fft_engine_on_card_matches_cpu_port(dev):
    """N=16384 behind enable_large_fft: one K1-gen launch per tick, as the
    JAX package's split rule sends 16384 to its 2-factor body (no K2 or
    K3 launch), 21 ticks to fill the window, against the CPU port."""
    cfg = resolve(Settings(fft_size=16384, enable_large_fft=True, width=800,
                           window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, 2))
    S, ticks = 3, 21
    card = ServingEngine(cfg, S, device=dev)
    cpu = ServingEngine(cfg, S, device="cpu")
    rng = np.random.default_rng(3)
    before = _counts()
    for k in range(ticks):
        x = (0.3 * rng.standard_normal((S, 2, 800))).astype(np.float32)
        x[-1] = 0.0
        now = 10_000_000_000 + k * 16_666_667
        for eng in (card, cpu):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    assert _counts() == (*before[:2], before[2] + ticks)
    db, want = card.read_decibels(), cpu.read_decibels()
    vis = want > -120.0
    np.testing.assert_allclose(db[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(db[floor], want[floor])
    np.testing.assert_array_equal(card.last_silent, cpu.last_silent)
    assert card.last_silent[-1]
    assert np.isfinite(card.read_pixels()).all()


@pytest.mark.parametrize("n", [1024, 3072, 32768])
def test_k3_matches_twin_and_f64(n, dev):
    """K3 on df32 windowed pairs, bit for bit against its twin, one launch
    per call, within 2.5e-7 of float64."""
    from waveform_tpu_torch.kernels.exactfft import _windowed_df

    S = 5
    rng = np.random.default_rng(n + 11)
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[-1] = 0.0
    w64, win = _hann(n, dev)
    xd = torch.from_numpy(x).to(dev)
    re, im = (_windowed_df(xd[:, c], *win) for c in range(2))
    before = exact_cuda.launches_cfft
    z = exact_cuda.cfft_exact_kernel(re, im)
    torch.cuda.synchronize()
    assert exact_cuda.launches_cfft == before + 1
    ref = exact_cuda.cfft_exact_ref(re, im)
    assert exact_cuda.launches_cfft == before + 1
    for got, want in zip((*z[0], *z[1]), (*ref[0], *ref[1])):
        assert torch.equal(got, want)
    got = ((z[0][0].double() + z[0][1].double()).cpu().numpy()
           + 1j * (z[1][0].double() + z[1][1].double()).cpu().numpy())
    want = np.fft.fft((x[:, 0].astype(np.float64)
                       + 1j * x[:, 1].astype(np.float64)) * w64)
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("n", [1024, 4096, 6144, 9216, 32768])
def test_k3_bad_streams_bitwise(n, dev):
    """K3 bit for bit against its twin in all four df32 outputs with a
    silent, a 1e20 and a NaN stream (NaN lanes by position), f32 inputs.
    Stage 1's 64-row groups: one at N = 1024 (a quarter of it M tiles) and
    4096, two at 6144 (the second partial), three at 9216 (the second
    warpgroup takes one), eight at 32768."""
    rng = np.random.default_rng(n + 23)
    x = (0.5 * rng.standard_normal((7, 2, n))).astype(np.float32)
    good = _bad_streams(x, rng)
    xd = torch.from_numpy(x).to(dev)
    re, im = xd[:, 0].contiguous(), xd[:, 1].contiguous()
    z = exact_cuda.cfft_exact_kernel(re, im)
    ref = exact_cuda.cfft_exact_ref(re, im)
    for got, want in zip((*z[0], *z[1]), (*ref[0], *ref[1])):
        assert _same_bits(got, want)
    assert (z[0][0][1] == 0).all() and (z[1][0][1] == 0).all()
    got = ((z[0][0].double() + z[0][1].double()).cpu().numpy()
           + 1j * (z[1][0].double() + z[1][1].double()).cpu().numpy())[good]
    want = np.fft.fft(x[good, 0].astype(np.float64)
                      + 1j * x[good, 1].astype(np.float64))
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL


@pytest.mark.parametrize("channels", [2, 1])
def test_fused_never_engine_on_card_matches_cpu_port(channels, dev,
                                                     monkeypatch):
    """``WAVEFORM_TPU_EXACT_FUSED=never`` at N=1024: one K3 launch per tick
    and no pair-kernel launch, stereo and mono capture, against the CPU
    port."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")
    cfg = resolve(Settings(fft_size=1024, width=400, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, channels))
    S = 4
    card = ServingEngine(cfg, S, device=dev)
    cpu = ServingEngine(cfg, S, device="cpu")
    rng = np.random.default_rng(4)
    before = _counts()
    for k in range(6):
        x = (0.3 * rng.standard_normal((S, channels, 800))).astype(np.float32)
        x[-1] = 0.0
        now = 10_000_000_000 + k * 16_666_667
        for eng in (card, cpu):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    assert _counts() == (before[0], before[1] + 6, before[2])
    db, want = card.read_decibels(), cpu.read_decibels()
    vis = want > -120.0
    np.testing.assert_allclose(db[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(db[floor], want[floor])
    np.testing.assert_array_equal(card.last_silent, cpu.last_silent)
    assert card.last_silent[-1]
    assert np.isfinite(card.read_pixels()).all()


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("n", [3072, 6144, 16384, 31744])
def test_k1_gen_matches_twin_and_f64(n, S, dev):
    """K1-gen through the router, bit for bit against its twin, one launch
    per call and no other kernel, within 2.5e-7 of float64."""
    rng = np.random.default_rng(n + S + 13)
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[-1, -1] = 0.0
    w64, win = _hann(n, dev)
    xd = torch.from_numpy(x).to(dev)
    before = _counts()
    mag, nz = exact_cuda.rfft_pair_mag(xd, win)
    torch.cuda.synchronize()
    assert _counts() == (*before[:2], before[2] + 1)
    ref, nz_ref = exact_cuda.rfft_pair_mag_ref(xd, win)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
    want = np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]
    got = mag.cpu().numpy().astype(np.float64)
    assert np.abs(got - want).max() / want.max() <= TOL
    np.testing.assert_array_equal(nz.cpu().numpy(),
                                  np.count_nonzero(x, axis=-1))


@pytest.mark.parametrize("n", K1_SIZES)
def test_k1_gen_matches_k1_bitwise(n, dev):
    """K1's sizes through the router (K1-gen) give the bits of K1-gen's
    direct entry point and of the twin that K1 was held to, with a 1e20
    and a NaN stream (NaN lanes by position)."""
    rng = np.random.default_rng(n + 17)
    x = (0.5 * rng.standard_normal((7, 2, n))).astype(np.float32)
    x[3] = 1e20 * rng.standard_normal((2, n))
    x[4, 0, 11] = np.nan
    _, win = _hann(n, dev)
    xd = torch.from_numpy(x).to(dev)
    gen, nz_gen = exact_cuda.rfft_pair_mag_gen(xd, win)
    routed, nz_routed = exact_cuda.rfft_pair_mag(xd, win)
    ref, nz_ref = exact_cuda.rfft_pair_mag_ref(xd, win)
    assert _same_bits(gen, routed) and _same_bits(routed, ref)
    assert torch.equal(nz_gen, nz_routed) and torch.equal(nz_routed, nz_ref)


def test_k1_gen_engine_on_card_matches_cpu_port(dev):
    """N=6144 (an FFT-size slider position): one K1-gen launch per tick and
    no other kernel, against the CPU port."""
    cfg = resolve(Settings(fft_size=6144, width=800, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, 2))
    S, ticks = 4, 9
    card = ServingEngine(cfg, S, device=dev)
    cpu = ServingEngine(cfg, S, device="cpu")
    rng = np.random.default_rng(5)
    before = _counts()
    for k in range(ticks):
        x = (0.3 * rng.standard_normal((S, 2, 800))).astype(np.float32)
        x[-1] = 0.0
        now = 10_000_000_000 + k * 16_666_667
        for eng in (card, cpu):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    assert _counts() == (*before[:2], before[2] + ticks)
    db, want = card.read_decibels(), cpu.read_decibels()
    vis = want > -120.0
    np.testing.assert_allclose(db[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(db[floor], want[floor])
    np.testing.assert_array_equal(card.last_silent, cpu.last_silent)
    assert card.last_silent[-1]
    assert np.isfinite(card.read_pixels()).all()


def _df_counts():
    """(K1-df, K2-df) launch counts."""
    return exact_cuda.launches_gen_df, exact_cuda.launches3_df


@pytest.mark.parametrize("S", [1, 7, 32])
@pytest.mark.parametrize("n,split", [(1024, 2), (4096, 2), (6144, 2),
                                     (31744, 2), (4096, 3), (8192, 3),
                                     (16384, 3), (32768, 3), (65536, 3)])
def test_df_kernels_match_twins_bitwise(n, split, S, dev, monkeypatch):
    """Under ``WAVEFORM_TPU_KERNEL_TWIDDLE=df``: K1-df through the router,
    K2-df through the router at 32768 and 65536 and its direct entry
    point below (which the router sends to split 2); one launch of the df
    kernel and of no other, bit for bit against the df twin with a
    silent, a 1e20 and a NaN stream (NaN lanes by position), within
    2.5e-7 of float64 on the other streams."""
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    rng = np.random.default_rng(n + S + 19)
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[-1, -1] = 0.0
    good = _bad_streams(x, rng)
    w64, win = _hann(n, dev)
    xd = torch.from_numpy(x).to(dev)
    direct = split == 3 and exact_cuda.stage1_split(n) == 2
    before, before_df = _counts(), _df_counts()
    mag, nz = (exact_cuda.rfft_pair_mag3(xd, win) if direct
               else exact_cuda.rfft_pair_mag(xd, win))
    torch.cuda.synchronize()
    assert _counts() == before
    assert _df_counts() == (before_df[0] + (split == 2),
                            before_df[1] + (split == 3))
    twin = (exact_cuda.rfft_pair_mag3_df_ref if split == 3
            else exact_cuda.rfft_pair_mag_df_ref)
    ref, nz_ref = twin(xd, win)
    assert _same_bits(mag, ref)
    assert torch.equal(nz, nz_ref)
    want = np.abs(np.fft.rfft(x[good].astype(np.float64) * w64))[..., :n // 2]
    got = mag.cpu().numpy()[good].astype(np.float64)
    assert np.abs(got - want).max() / want.max() <= TOL
    np.testing.assert_array_equal(nz.cpu().numpy(),
                                  np.count_nonzero(x, axis=-1))


def test_df_engine_on_card_matches_cpu_port(dev, monkeypatch):
    """The headline configuration under ``KERNEL_TWIDDLE=df``: one K1-df
    launch per tick and no other kernel, against the CPU port (the df
    twin)."""
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    cfg = resolve(Settings(fft_size=4096, width=800, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, 2))
    S, ticks = 4, 8
    card = ServingEngine(cfg, S, device=dev)
    cpu = ServingEngine(cfg, S, device="cpu")
    rng = np.random.default_rng(6)
    before, before_df = _counts(), _df_counts()
    for k in range(ticks):
        x = (0.3 * rng.standard_normal((S, 2, 800))).astype(np.float32)
        x[-1] = 0.0
        now = 10_000_000_000 + k * 16_666_667
        for eng in (card, cpu):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    assert _counts() == before
    assert _df_counts() == (before_df[0] + ticks, before_df[1])
    db, want = card.read_decibels(), cpu.read_decibels()
    vis = want > -120.0
    np.testing.assert_allclose(db[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(db[floor], want[floor])
    np.testing.assert_array_equal(card.last_silent, cpu.last_silent)
    assert card.last_silent[-1]
    assert np.isfinite(card.read_pixels()).all()


# --- the captured graph tick ----------------------------------------------

def _eager_tick(eng, now):
    """One tick of ``eng`` with its device function run eagerly, as the
    first tick's warm-up runs it: the reference for the graph tick."""
    eng._flip ^= 1
    eng._bind_buf(eng._flip)
    uniform = eng._stage(now, 1.0 / eng.cfg.fps)
    eng._upload(eng._host[eng._flip], eng._dev_in, eng._events, eng._flip)
    return eng._graph_fn(("tick", uniform))()


def _packets(rng, S, channels, per_stream, k):
    """A tick's packets: [S, channels, 800] noise with a tone (per stream
    when ``per_stream``, with uneven sizes: the per-stream count form),
    the last stream silent."""
    t = (np.arange(800) + 800 * k) / 48000
    x = (0.3 * rng.standard_normal((S, channels, 800))
         + 0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    x[-1] = 0.0
    if not per_stream:
        return x
    return [x[s, :, :800 - 40 * s] for s in range(S)]


def _feed(eng, x, now):
    if isinstance(x, list):
        for s, xs in enumerate(x):
            eng.feed(s, xs, now, now_ns=now)
    else:
        eng.feed_batch(x, now, now_ns=now)


GRAPH_PATHS = {
    # path: (settings, channels, environment, kernels a replay)
    "k1_gen": (dict(fft_size=4096), 2, {}, {"launches_gen": 1}),
    "k1_gen_per_stream": (dict(fft_size=4096, normalize_volume=True), 2, {},
                          {"launches_gen": 1}),
    "k1_df": (dict(fft_size=4096), 2, {"WAVEFORM_TPU_KERNEL_TWIDDLE": "df"},
              {"launches_gen_df": 1}),
    "k2": (dict(fft_size=32768, enable_large_fft=True), 2, {},
           {"launches3": 1}),
    "k2_df": (dict(fft_size=32768, enable_large_fft=True), 2,
              {"WAVEFORM_TPU_KERNEL_TWIDDLE": "df"}, {"launches3_df": 1}),
    "k3": (dict(fft_size=1024), 2, {"WAVEFORM_TPU_EXACT_FUSED": "never"},
           {"launches_cfft": 1}),
    "k3_mono": (dict(fft_size=1024), 1, {"WAVEFORM_TPU_EXACT_FUSED": "never"},
                {"launches_cfft": 1}),
    "lowering": (dict(auto_fft_size=True), 2, {}, {}),
}


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_tick_matches_eager_bitwise(path, dev, monkeypatch):
    """The graph tick against the eager packed tick on the same packets,
    bit for bit in every tick's pixels and in the final state, on every
    kernel path and the lowering (path c, N=800); each replay launches
    its path's kernel once, counted from the capture."""
    settings, channels, envs, want = GRAPH_PATHS[path]
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    cfg = resolve(Settings(width=400, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS, **settings),
                  AudioInfo(48000, channels))
    S = 4
    graph = ServingEngine(cfg, S, device=dev)
    eager = ServingEngine(cfg, S, device=dev)
    rng = np.random.default_rng(8)
    per_stream = path.endswith("per_stream")
    for k in range(5):
        x = _packets(rng, S, channels, per_stream, k)
        now = 10_000_000_000 + k * 16_666_667
        _feed(graph, x, now)
        _feed(eager, x, now)
        before = {c: getattr(exact_cuda, c) for c in COUNTERS}
        px = graph.tick(now_ns=now)
        moved = {c: getattr(exact_cuda, c) - n for c, n in before.items()
                 if getattr(exact_cuda, c) != n}
        assert moved == want, (k, moved)
        assert torch.equal(px, _eager_tick(eager, now)), k
    for a, b in ((graph.state.tsmooth, eager.state.tsmooth),
                 (graph.state.decibels, eager.state.decibels),
                 (graph.state.last_silent, eager.state.last_silent),
                 (graph.ring.buf, eager.ring.buf)):
        assert torch.equal(a, b)
    replays = graph.kernels_per_replay
    assert ("tick", not per_stream) in replays
    assert set(replays) <= {("tick", True), ("tick", False)}
    assert all(launches == want for launches in replays.values())


def test_graph_pixels_survive_the_next_tick(dev):
    """The pixels a tick returned are their own tensor: unchanged by the
    replays after it (the graph's output buffer is rewritten)."""
    cfg = resolve(Settings(fft_size=4096, width=800), AudioInfo(48000, 2))
    eng = ServingEngine(cfg, 3, device=dev)
    rng = np.random.default_rng(9)
    kept = []
    for k in range(5):
        now = 10_000_000_000 + k * 16_666_667
        eng.feed_batch(_packets(rng, 3, 2, False, k), now, now_ns=now)
        px = eng.tick(now_ns=now)
        kept.append((px, px.clone()))
    assert not torch.equal(kept[2][0], kept[3][0])
    for px, copy in kept:
        assert torch.equal(px, copy)


def test_graph_routing_pinned_at_capture(dev, monkeypatch):
    """The routing variables are read when the graph is captured (the
    first tick), as ``jit`` reads them at trace: ``EXACT_FUSED=never`` set
    for the later ticks changes nothing for this engine (still K1-gen, the
    bits of an engine that never saw it); a new engine built under it runs
    K3."""
    cfg = resolve(Settings(fft_size=4096, width=400), AudioInfo(48000, 2))
    eng = ServingEngine(cfg, 3, device=dev)
    ref = ServingEngine(cfg, 3, device=dev)
    rng = np.random.default_rng(10)
    for k in range(4):
        x = _packets(rng, 3, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        for e in (eng, ref):
            e.feed_batch(x, now, now_ns=now)
        if k >= 2:
            monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")
        before = _counts()
        px = eng.tick(now_ns=now)
        assert _counts() == (before[0], before[1], before[2] + 1)
        monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
        assert torch.equal(px, ref.tick(now_ns=now))
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")
    fresh = ServingEngine(cfg, 3, device=dev)
    fresh.feed_batch(x, now, now_ns=now)
    before = _counts()
    fresh.tick(now_ns=now)
    assert _counts() == (before[0], before[1] + 1, before[2])


def test_microbatch_flush_matches_single_ticks(dev):
    """microbatch=4 on the card: each flush (one graph of four packed
    ticks) gives the four single ticks' pixels bit for bit, in four
    distinct frames."""
    cfg = resolve(Settings(fft_size=4096, width=800, window=FFTWindow.HANN),
                  AudioInfo(48000, 2))
    S = 4
    one = ServingEngine(cfg, S, device=dev)
    mb = ServingEngine(cfg, S, microbatch=4, device=dev)
    rng = np.random.default_rng(11)
    singles = []
    for k in range(8):
        x = _packets(rng, S, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        for e in (one, mb):
            e.feed_batch(x, now, now_ns=now)
        singles.append(one.tick(now_ns=now))
        mb.tick(now_ns=now, dt=None)
        if k % 4 == 3:
            batch = mb.last_batch_pixels
            for i in range(4):
                assert torch.equal(batch[i], singles[k - 3 + i]), (k, i)
    assert mb.kernels_per_replay[("mb", 4, True)] == {"launches_gen": 4}


def test_meter_graph_matches_eager(dev):
    """The meter engine's graph tick against its eager tick, bit for bit,
    through a hidden stream and a capture gap (ring zeroed once)."""
    from waveform_tpu_torch import DisplayMode
    from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine

    cfg = resolve(Settings(display_mode=DisplayMode.METER, meter_buf=100),
                  AudioInfo(48000, 2))
    S = 4
    graph = MeterServingEngine(cfg, S, device=dev)
    eager = MeterServingEngine(cfg, S, device=dev)
    rng = np.random.default_rng(12)
    for k in range(8):
        now = 10_000_000_000 + k * 16_666_667 + (600_000_000 if k > 5 else 0)
        if k <= 5:
            x = _packets(rng, S, 2, False, k)
            for e in (graph, eager):
                e.feed_batch(x, now, now_ns=now)
                e.set_show(1, k < 3)
        px = graph.tick(now_ns=now)
        assert torch.equal(px, _eager_tick(eager, now)), k
        assert torch.equal(graph.ring.buf, eager.ring.buf)
    assert (graph.meter_values == DB_MIN).all()
    # the live streams' rings zeroed at the timeout; the hidden stream had
    # latched already, so it froze with its ring (the early return)
    assert not graph.ring.buf[[0, 2]].any() and graph.ring.buf[1].any()
