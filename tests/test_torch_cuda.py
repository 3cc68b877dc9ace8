"""The port's CUDA kernels and engine on the card.

Marked ``cuda``; every test skips without a CUDA device.  On a machine
with one, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import gc
import os
import time

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
from waveform_tpu_torch.dsp.spectrum import gravity_pair
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES, sass_counts
from waveform_tpu_torch.runtime.serving import ServingEngine, upload
from waveform_tpu_torch.utils import plans

pytestmark = pytest.mark.cuda

TOL = 2.5e-7
K1_SIZES = (1024, 2048, 4096)   # N1 = 8, 16, 32: K1's sizes, K1-gen's now


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def default_split_rule(tmp_path, monkeypatch):
    """The tests below hold the router's default split rule: no plan file
    of the user's and not the packaged H100 table (which sends 8192 and
    16384-28672 to K2); the plan's own tests set a file."""
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", str(tmp_path / "none.json"))
    monkeypatch.setattr(plans, "_packaged_plans", lambda: {})


def _counts():
    """(K2, K3, K1-gen) launch counts."""
    return LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K1-gen"]


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
    """The SASS of the built library: every FFT kernel (stage 1 and stage
    2 of K2, K2-df, K1-gen, K1-df and K3; the pair kernels' stage 1 in two
    instances, reading the rows in order or at a rotating ring's heads)
    holds int8 tensor-core products
    (IMMA from mma.sync, or IGMMA from wgmma) and no __dp4a (IDP.4A); the
    library's other kernels are the spectrum tail's four (its gate and
    fused tail, each for 16-byte vectors and single floats), the
    rotating ring's push and the rebin's four (the interp at 1, 4 and 8
    taps, the Gaussian filter)."""
    counts = sass_counts()
    fft = {fn: c for fn, c in counts.items() if "exact_" in fn}
    tail = [fn for fn in counts if "spectrum_tail_" in fn]
    ring = [fn for fn in counts if "ring_push" in fn]
    rebin = [fn for fn in counts if "rebin_" in fn]
    assert (len(fft) == 14 and len(tail) == 4 and len(ring) == 1
            and len(rebin) == 4), counts
    assert len(counts) == (len(fft) + len(tail) + len(ring)
                           + len(rebin)), counts
    for fn, c in fft.items():
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
    before = LAUNCHES["K3"]
    z = exact_cuda.cfft_exact_kernel(re, im)
    torch.cuda.synchronize()
    assert LAUNCHES["K3"] == before + 1
    ref = exact_cuda.cfft_exact_ref(re, im)
    assert LAUNCHES["K3"] == before + 1
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
    return LAUNCHES["K1-df"], LAUNCHES["K2-df"]


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
    upload(eng._host[eng._flip], eng._dev_in, eng._events, eng._flip)
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


TAIL = {"tail": 2}     # the spectrum tail's kernel pair a step
RING = {"ring": 1}     # the rotating ring's push, where a pair kernel reads it
REBIN = {"rebin": 1}   # the rebin's interp kernel (an unfiltered look)

GRAPH_PATHS = {
    # path: (settings, channels, environment, kernels a replay); every
    # path's spectrum tail is one kernel pair (TAIL) and its rebin the
    # interp kernel (REBIN); the pair kernels' paths push into a rotating
    # ring (RING)
    "k1_gen": (dict(fft_size=4096), 2, {},
               {"K1-gen": 1, **RING, **TAIL, **REBIN}),
    "k1_gen_per_stream": (dict(fft_size=4096, normalize_volume=True), 2, {},
                          {"K1-gen": 1, **RING, **TAIL, **REBIN}),
    "k1_df": (dict(fft_size=4096), 2, {"WAVEFORM_TPU_KERNEL_TWIDDLE": "df"},
              {"K1-df": 1, **RING, **TAIL, **REBIN}),
    "k2": (dict(fft_size=32768, enable_large_fft=True), 2, {},
           {"K2": 1, **RING, **TAIL, **REBIN}),
    "k2_df": (dict(fft_size=32768, enable_large_fft=True), 2,
              {"WAVEFORM_TPU_KERNEL_TWIDDLE": "df"},
              {"K2-df": 1, **RING, **TAIL, **REBIN}),
    "k3": (dict(fft_size=1024), 2, {"WAVEFORM_TPU_EXACT_FUSED": "never"},
           {"K3": 1, **TAIL, **REBIN}),
    "k3_mono": (dict(fft_size=1024), 1, {"WAVEFORM_TPU_EXACT_FUSED": "never"},
                {"K3": 1, **TAIL, **REBIN}),
    "lowering": (dict(auto_fft_size=True), 2, {}, {**TAIL, **REBIN}),
    "matmul": (dict(fft_size=4096), 2, {"WAVEFORM_TPU_FFT_BACKEND": "matmul"},
               {**TAIL, **REBIN}),
}


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_tick_matches_eager_bitwise(path, dev, monkeypatch):
    """The graph tick against the eager packed tick on the same packets,
    bit for bit in every tick's pixels and in the final state, on every
    kernel path and the lowering (path c, N=800); each replay launches
    its path's kernel once, the tail's pair and the rebin's interp,
    counted from the capture."""
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
        before = LAUNCHES.copy()
        px = graph.tick(now_ns=now)
        moved = dict(LAUNCHES - before)
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


def _stage_in_pieces(eng, now, dt):
    """``eng``'s stage as separate steps on the bound upload: the native
    assembler's rows, then the count form and the scalars in Python."""
    eng._assemble(now)
    uniform, c0 = eng._uniform_count()
    eng._tail[:2] = gravity_pair(eng.cfg, dt)
    eng._tail[2] = c0
    return uniform


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("path", ["k2", "k1_gen", "k1_gen_per_stream"])
def test_native_stage_tick_matches_the_stage_in_pieces(path, traced, dev,
                                                       monkeypatch, tracing):
    """Ticks whose stage is one native call against an engine twin that
    stages in pieces, on the same packets: bit for bit in every tick's
    pixels and in the final state, with the launch counters moving as a
    replay moves them and every tick counted as ``ticks.native``.  The
    ticks queue behind a 40 ms sleep on the stream with no synchronize,
    so the third tick's stage must wait on the event that the first
    tick's upload recorded (reused from tick to tick) before it rewrites
    that buffer."""
    settings, channels, envs, want = GRAPH_PATHS[path]
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    cfg = resolve(Settings(width=400, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS, **settings),
                  AudioInfo(48000, channels))
    S = 4
    fast = ServingEngine(cfg, S, device=dev)
    slow = ServingEngine(cfg, S, device=dev)
    assert fast._native is not None
    slow._stage = lambda now, dt: _stage_in_pieces(slow, now, dt)
    tracing.set_tracing(traced)
    rng = np.random.default_rng(21)
    per_stream = path.endswith("per_stream")
    outs = []
    for k in range(8):
        x = _packets(rng, S, channels, per_stream, k)
        now = 10_000_000_000 + k * 16_666_667
        _feed(fast, x, now)
        _feed(slow, x, now)
        if k == 1:
            torch.cuda._sleep(40_000_000)
        before = LAUNCHES.copy()
        a = fast.tick(now_ns=now)
        moved = dict(LAUNCHES - before)
        assert moved == want, (k, moved)
        outs.append((a, slow.tick(now_ns=now)))
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(outs):
        assert torch.equal(a, b), k
    for a, b in ((fast.state.tsmooth, slow.state.tsmooth),
                 (fast.state.decibels, slow.state.decibels),
                 (fast.state.last_silent, slow.state.last_silent),
                 (fast.ring.buf, slow.ring.buf)):
        assert torch.equal(a, b)
    assert list(fast._ticks) == [("tick", not per_stream)]
    counters = tracing.snapshot()["counters"]
    if traced:
        assert counters["ticks.native"] == 8
        assert counters["ticks.uniform" if not per_stream
                        else "ticks.gather"] == 16
    else:
        assert "ticks.native" not in counters


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
    assert mb.kernels_per_replay[("mb", 4, True)] == {"K1-gen": 4, "ring": 4,
                                                      "tail": 8, "rebin": 4}


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


# --- the waveform family ----------------------------------------------------

def _wf_cfg(**kw):
    from waveform_tpu_torch import DisplayMode, TSmoothingMode
    return resolve(Settings(display_mode=DisplayMode.WAVEFORM,
                            temporal_smoothing=TSmoothingMode.NONE, **kw),
                   AudioInfo(48000, 2))


def _wf_feed(engines, rng, S, now):
    """One tick's per-stream packets: noise, stream 1 stamped 50 ms behind
    the clock, the last stream silent."""
    for s in range(S):
        x = (0.3 * rng.standard_normal((2, 480))).astype(np.float32)
        if s == S - 1:
            x[:] = 0.0
        for e in engines:
            e.feed(s, x, now - (50_000_000 if s == 1 else 0), now_ns=now)


@pytest.mark.parametrize("normalize", [False, True])
def test_waveform_graph_matches_eager_bitwise(normalize, dev):
    """The waveform graph tick against its eager tick on the same packets:
    the display, latch, ring (and RMS ring) bit for bit every tick; a
    replay launches no exact kernel."""
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
    )
    cfg = _wf_cfg(width=320, meter_buf=100, normalize_volume=normalize,
                  audio_sync_offset=40 if normalize else 0)
    S = 4
    graph = DeviceWaveformEngine(cfg, S, device=dev)
    eager = DeviceWaveformEngine(cfg, S, device=dev)
    rng = np.random.default_rng(13)
    now = 10_000_000_000
    for k in range(12):
        _wf_feed((graph, eager), rng, S, now)
        now += 10_000_000
        assert torch.equal(graph.tick(now_ns=now), _eager_tick(eager, now)), k
        assert torch.equal(graph.latch, eager.latch)
        assert torch.equal(graph.ring.buf, eager.ring.buf)
        if normalize:
            assert torch.equal(graph.rms_ring.buf, eager.rms_ring.buf)
    assert graph.kernels_per_replay == {("tick", False): {}}


def test_waveform_microbatch_matches_single_ticks(dev):
    """microbatch=4 on the card: each flush (one graph of four packed
    ticks) gives the four single ticks' displays bit for bit."""
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
    )
    cfg = _wf_cfg(width=320, meter_buf=100)
    S = 4
    one = DeviceWaveformEngine(cfg, S, device=dev)
    mb = DeviceWaveformEngine(cfg, S, microbatch=4, device=dev)
    rng = np.random.default_rng(14)
    now = 10_000_000_000
    singles = []
    for k in range(8):
        _wf_feed((one, mb), rng, S, now)
        now += 10_000_000
        singles.append(one.tick(now_ns=now))
        mb.tick(now_ns=now)
        if k % 4 == 3:
            for i in range(4):
                assert torch.equal(mb.last_batch_pixels[i],
                                   singles[k - 3 + i]), (k, i)
    assert torch.equal(mb.buf, one.buf) and torch.equal(mb.latch, one.latch)


def test_waveform_resized_on_card(dev):
    """resized(keep) on the card: the carried rows and the new engine's
    graph ticks stay within 1e-4 dB of the CPU port resized the same way,
    DB_MIN and the latch exact."""
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
    )
    cfg = _wf_cfg(width=256, meter_buf=100, normalize_volume=True)
    card = DeviceWaveformEngine(cfg, 3, device=dev)
    cpu = DeviceWaveformEngine(cfg, 3, device="cpu")
    rng = np.random.default_rng(15)
    now = 10_000_000_000
    for S, ticks in ((3, 10), (4, 10)):
        if S == 4:
            card = card.resized(4, keep=[2, 0])
            cpu = cpu.resized(4, keep=[2, 0])
        for _ in range(ticks):
            _wf_feed((card, cpu), rng, S, now)
            now += 10_000_000
            got = card.tick(now_ns=now).cpu().numpy()
            want = cpu.tick(now_ns=now).numpy()
            floor = want == np.float32(DB_MIN)
            np.testing.assert_array_equal(got[floor], want[floor])
            np.testing.assert_allclose(got[~floor], want[~floor], rtol=0,
                                       atol=1e-4)
            np.testing.assert_array_equal(card.last_silent, cpu.last_silent)


def test_engine_spectrum_launches_k1_gen_once_a_tick(dev):
    """WaveformEngine's spectrum mode at N=4096 on the card: one K1-gen
    launch and one tail pair a tick (warm-up, capture, replays) and no
    other kernel, within
    1e-4 dB of the CPU port."""
    from waveform_tpu_torch.runtime.engine import WaveformEngine
    cfg = resolve(Settings(fft_size=4096, width=400, window=FFTWindow.HANN),
                  AudioInfo(48000, 2))
    S = 3
    card = WaveformEngine(cfg, S, device=dev)
    cpu = WaveformEngine(cfg, S, device="cpu")
    rng = np.random.default_rng(16)
    for k in range(5):
        x = _packets(rng, S, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        for s in range(S):
            for e in (card, cpu):
                e.feed(s, x[s], now, now_ns=now)
        before = LAUNCHES.copy()
        got = card.tick(now_ns=now).cpu().numpy()
        moved = dict(LAUNCHES - before)
        assert moved == {"K1-gen": 1, **TAIL}, (k, moved)
        want = cpu.tick(now_ns=now).numpy()
        vis = want > -120.0
        np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(card.last_silent, cpu.last_silent)
    assert (got[-1] == np.float32(DB_MIN)).all() and card.last_silent[-1]


# --- the scene (MultiEngine), the bus and the renderer ----------------------

def _scene_cfgs():
    """Two spectrum looks and a meter (one cohort), two waveform looks (a
    second cohort)."""
    from waveform_tpu_torch import DisplayMode, TSmoothingMode
    return [resolve(Settings(fft_size=4096, width=400), AudioInfo(48000, 2)),
            resolve(Settings(fft_size=2048, width=400,
                             window=FFTWindow.BLACKMAN), AudioInfo(48000, 2)),
            resolve(Settings(display_mode=DisplayMode.METER),
                    AudioInfo(48000, 2)),
            _wf_cfg(width=320, meter_buf=150),
            resolve(Settings(display_mode=DisplayMode.WAVEFORM, width=320,
                             meter_buf=300,
                             temporal_smoothing=TSmoothingMode.NONE),
                    AudioInfo(48000, 2))]


def _scene_make(cfg, n, device):
    from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
    )
    if cfg.spectrum_mode:
        return ServingEngine(cfg, n, device=device)
    if cfg.meter_mode:
        return MeterServingEngine(cfg, n, device=device)
    return DeviceWaveformEngine(cfg, n, device=device)


def _scene_drive(scene, sids, rng, ticks, now, solo=None):
    """Per-stream noise packets to ``sids`` [(group, row, handle)] of the
    scene (and the standalone engines ``solo``), then a tick."""
    for _ in range(ticks):
        for g, r, sid in sids:
            x = (0.3 * rng.standard_normal((2, 800))).astype(np.float32)
            scene.feed(sid, x, now, now_ns=now)
            if solo is not None:
                solo[g].feed(r, x, now, now_ns=now)
        now += 16_666_667
        scene.tick(now_ns=now)
        for e in solo or ():
            e.tick(now_ns=now)
    return now


def _scene(dev, rows=(3, 2, 2, 2, 1)):
    from waveform_tpu_torch.runtime.multi import MultiEngine
    cfgs = _scene_cfgs()
    scene = MultiEngine(device=dev)
    sids = [(g, r, scene.add_stream(c)) for g, (c, n) in
            enumerate(zip(cfgs, rows)) for r in range(n)]
    return cfgs, scene, sids


def test_scene_cohort_matches_solo_engines(dev):
    """A scene on the card (two cohorts of captured member ticks) against
    standalone card engines fed the same packets: every group's values and
    latches bit for bit; one K1-gen launch a spectrum group a tick."""
    cfgs, scene, sids = _scene(dev)
    solo = [_scene_make(c, n, dev) for c, n in zip(cfgs, (3, 2, 2, 2, 1))]
    rng = np.random.default_rng(17)
    now = _scene_drive(scene, sids, rng, 3, 10_000_000_000, solo)
    assert len(scene._cohorts) == 2 and not scene._solo
    before = LAUNCHES["K1-gen"]
    _scene_drive(scene, sids, rng, 4, now, solo)
    torch.cuda.synchronize()
    assert LAUNCHES["K1-gen"] - before == 2 * 4 * 2   # scene + solo
    for cfg, e in zip(cfgs, solo):
        got = scene._engines[cfg]
        np.testing.assert_array_equal(got.last_silent, e.last_silent)
        mine = (list(vars(got.state).values()) if hasattr(got, "state")
                else [got.buf, got.latch])
        theirs = (list(vars(e.state).values()) if hasattr(e, "state")
                  else [e.buf, e.latch])
        assert torch.equal(got.ring.buf, e.ring.buf)
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))


def test_scene_one_upload_a_cohort_tick(dev):
    """A scene tick copies host to device once a cohort: the profiler
    counts two host-to-device copies a tick for the two cohorts (it traces
    one tick first and drops it: a trace's first activity records can be
    lost)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cfgs, scene, sids = _scene(dev)
    rng = np.random.default_rng(18)
    now = _scene_drive(scene, sids, rng, 3, 10_000_000_000)
    torch.cuda.synchronize()
    h2d = []

    def ready(prof):          # the active window's trace, as it completes
        h2d.append([ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and "HtoD" in ev.name])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=4),
                 on_trace_ready=ready) as prof:
        for _ in range(5):
            now = _scene_drive(scene, sids, rng, 1, now)
            torch.cuda.synchronize()
            prof.step()
    assert len(h2d) == 1 and len(h2d[0]) == 2 * 4, h2d


def test_scene_edit_recaptures_only_the_edited_groups(dev):
    """Live add, remove and update on a card scene: the edited groups'
    engines are new and capture anew; every other member keeps its
    segment and its captured graph objects; the survivors' values carry
    across bit for bit."""
    cfgs, scene, sids = _scene(dev)
    rng = np.random.default_rng(19)
    now = _scene_drive(scene, sids, rng, 3, 10_000_000_000)

    def graphs():
        return {cfg: (e, e._row0, dict(e._ticks))
                for cfg, e in scene._engines.items()}

    for edit, edited in (
            (lambda: scene.add_stream(cfgs[1]), {cfgs[1]}),
            (lambda: scene.remove_stream(sids[0][2]), {cfgs[0]}),
            (lambda: scene.update_stream(sids[-1][2], cfgs[3]),
             {cfgs[3], cfgs[4]})):
        before = graphs()
        vals = {sid: scene.read_decibels(sid) for _, _, sid in sids
                if sid in scene._streams}
        edit()
        for cfg, (eng, row0, ticks) in before.items():
            if cfg in edited or cfg not in scene._engines:
                continue
            now_eng = scene._engines[cfg]
            assert now_eng is eng and eng._row0 == row0
            assert all(eng._ticks[k] is t for k, t in ticks.items()), cfg
        for sid, v in vals.items():
            if sid in scene._streams and sid != sids[-1][2]:
                np.testing.assert_array_equal(scene.read_decibels(sid), v)
        sids = [(g, r, s) for g, r, s in sids if s in scene._streams]
        now = _scene_drive(scene, sids, rng, 2, now)


def _bus_cfgs():
    from waveform_tpu_torch import DisplayMode
    return [resolve(Settings(fft_size=4096, width=400), AudioInfo(48000, 2)),
            resolve(Settings(fft_size=8192, width=400,
                             window=FFTWindow.BLACKMAN), AudioInfo(48000, 2)),
            resolve(Settings(display_mode=DisplayMode.METER,
                             rms_mode=False), AudioInfo(48000, 2)),
            _wf_cfg(width=320, meter_buf=150)]


def _bus_tick(buses, x, now, eager=None):
    """Feed ``x`` to every bus and tick it; the ``eager`` bus runs its
    device half eagerly (the reference for the graph)."""
    for b in buses:
        b.feed(x, now, now_ns=now)
        if b is eager:
            b._graph = b._device_tick
        b.tick(now_ns=now)


def _bus_state(bus):
    out = [bus.ring.buf]
    for g in bus._groups.values():
        if g["mode"] == "waveform":
            out += [g["buf"], g["latch"]]
        else:
            out += [getattr(g["state"], f) for f in g["state"].__dict__]
    return out


def test_bus_graph_matches_eager_bus(dev):
    """The bus's graph tick (push + every group's step in one replay)
    against the same bus ticked eagerly, through a live subscribe that
    grows the ring: ring, every group's state, scroll buffer and latch bit
    for bit each tick; a replay launches one K1-gen a spectrum group."""
    from waveform_tpu_torch.runtime.bus import OutputBus
    graph, eager = (OutputBus(AudioInfo(48000, 2), device=dev)
                    for _ in range(2))
    cfgs = _bus_cfgs()
    for b in (graph, eager):
        for c in cfgs[:3]:
            b.subscribe(c)
    rng = np.random.default_rng(20)
    now = 10_000_000_000
    for k in range(8):
        if k == 4:
            for b in (graph, eager):
                b.subscribe(cfgs[3])      # the waveform window grows the ring
        x = (0.3 * rng.standard_normal((2, 800))).astype(np.float32)
        now += 16_666_667
        _bus_tick((graph, eager), x, now, eager=eager)
        for a, b in zip(_bus_state(graph), _bus_state(eager)):
            assert torch.equal(a, b), k
    assert graph._graph.launches == {"K1-gen": 2, "tail": 4, "rebin": 2}


def test_bus_ring_growth_keeps_history(dev):
    """A live subscribe with a larger window grows the card ring: the old
    ring is the grown ring's tail, zeros ahead of it, and the existing
    groups' states carry across bit for bit; the new graph runs."""
    from waveform_tpu_torch.runtime.bus import OutputBus
    cfgs = _bus_cfgs()
    bus = OutputBus(AudioInfo(48000, 2), device=dev)
    hs = [bus.subscribe(c) for c in cfgs[:3]]
    rng = np.random.default_rng(22)
    now = 10_000_000_000
    for _ in range(12):
        now += 16_666_667
        _bus_tick((bus,), (0.3 * rng.standard_normal((2, 800))).astype(
            np.float32), now)
    old_L, old_ring = bus.L, bus.ring.buf.clone()
    before = [t.clone() for t in _bus_state(bus)[1:]]
    big = resolve(Settings(fft_size=65536, enable_large_fft=True, width=400),
                  AudioInfo(48000, 2))
    hb = bus.subscribe(big)
    assert bus.L == 65536 + bus.H > old_L
    assert torch.equal(bus.ring.buf[..., -old_L:], old_ring)
    assert not bus.ring.buf[..., :-old_L].any()
    after = _bus_state(bus)[1:len(before) + 1]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    now += 16_666_667
    _bus_tick((bus,), (0.3 * rng.standard_normal((2, 800))).astype(
        np.float32), now)
    torch.cuda.synchronize()
    assert np.isfinite(bus.read_decibels(hb)).all()
    assert all(np.isfinite(bus.read_pixels(h)).all() for h in hs)


def test_render_frames_on_card_match_cpu(dev):
    """``MultiEngine.render_frames`` on the card against the CPU port's
    scene fed the same packets: every frame within 1e-5 (the card's
    values within 1e-4 dB of the CPU's; the interp kernel and the CPU's
    gather add the taps in different orders)."""
    from waveform_tpu_torch.runtime.multi import MultiEngine
    cfgs = _scene_cfgs()
    card, cpu = MultiEngine(device=dev), MultiEngine(device="cpu")
    sids = [(card.add_stream(c), cpu.add_stream(c)) for c in cfgs
            for _ in range(2)]
    rng = np.random.default_rng(23)
    now = 10_000_000_000
    for _ in range(6):
        for sa, sb in sids:
            x = (0.3 * rng.standard_normal((2, 800))).astype(np.float32)
            card.feed(sa, x, now, now_ns=now)
            cpu.feed(sb, x, now, now_ns=now)
        now += 16_666_667
        card.tick(now_ns=now)
        cpu.tick(now_ns=now)
    got, want = card.render_frames(), cpu.render_frames()
    for sa, sb in sids:
        assert got[sa].shape == want[sb].shape
        np.testing.assert_allclose(got[sa], want[sb], rtol=0, atol=1e-5)


def test_graph_captures_do_not_grow_device_memory(dev):
    """Every capture runs on one side stream a device: the libraries keep
    a workspace for each stream they run on (cuBLAS's as long as the
    process), so 40 captures of a GEMM, each dropped after its replays,
    leave device memory where the first left it."""
    import gc

    from waveform_tpu_torch.runtime.graphs import GraphTick
    a = torch.randn(256, 256, device=dev)
    mem = []
    for _ in range(40):
        t = GraphTick(lambda: a @ a, dev)
        for _ in range(3):
            t()
        del t
        torch.cuda.synchronize()
        gc.collect()
        mem.append(torch.cuda.memory_allocated(dev))
    assert mem[-1] - mem[0] <= 1 << 20, mem


# --- the plan, the matmul backend and rfft_fn -------------------------------

def test_plan_steers_the_launched_body(dev, tmp_path, monkeypatch):
    """N=16384: a plan file naming 2 sends each tick to K1-gen, one naming
    3 to K2 (read at the graph's capture); with no file the packaged H100
    table decides, on this card only if it names an H100."""
    cfg = resolve(Settings(fft_size=16384, enable_large_fft=True, width=400),
                  AudioInfo(48000, 2))
    pf = tmp_path / "plans.json"
    monkeypatch.undo()                       # the real packaged table
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", str(pf))
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    rng = np.random.default_rng(11)
    table = plans._packaged_plans().get("16384", {}).get("split", 2)
    for stamp, split in ((None, table), (1, 2), (2, 3)):
        if stamp is not None:
            pf.write_text('{"16384": {"split": %d}}' % split)
            os.utime(pf, (stamp, stamp))
        eng = ServingEngine(cfg, 2, device=dev)
        before = _counts()
        for k in range(3):
            now = 10_000_000_000 + k * 16_666_667
            eng.feed_batch(_packets(rng, 2, 2, False, k), now, now_ns=now)
            eng.tick(now_ns=now)
        torch.cuda.synchronize()
        assert _counts() == (before[0] + 3 * (split == 3), before[1],
                             before[2] + 3 * (split == 2)), (stamp, split)


def test_rfft_fn_graph_tick_matches_eager(dev):
    """``ServingEngine(rfft_fn=torch.fft.rfft)``: the function is captured
    in the graph, whose ticks equal the eager ticks bit for bit, and no
    exact kernel launches; a function that synchronizes with the host
    cannot be captured, and the engine says so."""
    cfg = resolve(Settings(fft_size=4096, width=400, window=FFTWindow.HANN),
                  AudioInfo(48000, 2))
    graph = ServingEngine(cfg, 4, rfft_fn=torch.fft.rfft, device=dev)
    eager = ServingEngine(cfg, 4, rfft_fn=torch.fft.rfft, device=dev)
    rng = np.random.default_rng(12)
    before = _counts()
    for k in range(5):
        x = _packets(rng, 4, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        graph.feed_batch(x, now, now_ns=now)
        eager.feed_batch(x, now, now_ns=now)
        assert torch.equal(graph.tick(now_ns=now), _eager_tick(eager, now))
    assert _counts() == before
    assert graph.kernels_per_replay == {("tick", True): {**TAIL, **REBIN}}

    def syncs(x):
        z = torch.fft.rfft(x)
        z.abs().sum().item()
        return z

    # the captures (the plain graph, then its stamped twin) run with the
    # collector off (a collection there could free a dropped engine's
    # graph, which invalidates the capture)
    seen = []

    def watched(x):
        seen.append(gc.isenabled())
        return torch.fft.rfft(x)

    eng = ServingEngine(cfg, 2, rfft_fn=watched, device=dev)
    eng.feed_batch(x[:2], now, now_ns=now)
    eng.tick(now_ns=now)
    assert seen == [True, False, False] and gc.isenabled()

    bad = ServingEngine(cfg, 2, rfft_fn=syncs, device=dev)
    bad.feed_batch(x[:2], now, now_ns=now)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        bad.tick(now_ns=now)


def test_sharded_mesh_on_one_card_matches_single_engine(dev):
    """A 2-entry mesh on one card (the entry repeated): each entry ticks
    its rows as its own captured graph, one K1-gen launch an entry a
    replay; the graph tick equals the eager tick bit for bit, and the
    output the single engine's within 1e-4 dB."""
    from waveform_tpu_torch.parallel import ShardedServingEngine, make_mesh
    cfg = resolve(Settings(fft_size=4096, width=400, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, 2))
    S = 8
    mesh = make_mesh([dev, dev], pixel_parallel=1)
    graph = ShardedServingEngine(cfg, S, mesh=mesh)
    eager = ShardedServingEngine(cfg, S, mesh=mesh)
    single = ServingEngine(cfg, S, device=dev)
    rng = np.random.default_rng(13)
    for k in range(5):
        x = _packets(rng, S, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        for eng in (graph, eager, single):
            eng.feed_batch(x, now, now_ns=now)
        before = LAUNCHES["K1-gen"]
        tiles = graph.tick(now_ns=now)
        assert LAUNCHES["K1-gen"] - before == 2, k
        eager._flip ^= 1
        eager._bind_buf(eager._flip)
        uniform = eager._stage(now, 1.0 / cfg.fps)
        host, W = eager._host[eager._flip], eager.packed_width
        for t, sh in zip(tiles, eager._shards):
            e, n = sh.eng, (sh.hi - sh.lo) * W
            e._dev_in[:n].copy_(host[sh.lo * W:sh.hi * W])
            e._dev_in[n:].copy_(host[eager.S * W:])
            assert torch.equal(t.data, e._graph_fn(("tick", uniform))())
        single.tick(now_ns=now)
    want = single.read_pixels()
    got = graph.read_pixels()
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
    assert graph.kernels_per_replay[("tick", True)] == {"K1-gen": 2,
                                                        "ring": 2,
                                                        "tail": 4,
                                                        "rebin": 2}


def test_graph_tick_generator_draws_anew_each_replay(dev):
    """A ``GraphTick`` given its ``torch.Generator`` registers it with the
    graph: each replay draws new numbers (the bench's on-device audio);
    the warm-up draws what an eager call of a generator seeded alike
    draws."""
    from waveform_tpu_torch.runtime.graphs import GraphTick
    out = torch.empty(4096, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    tick = GraphTick(lambda: torch.rand(out.shape, generator=gen,
                                        device=dev, out=out), dev,
                     generators=(gen,))
    draws = []
    for _ in range(4):          # warm-up, capture, two replays
        tick()
        draws.append(out.clone())
    assert tick.graph is not None
    for a in range(4):
        for b in range(a + 1, 4):
            assert not torch.equal(draws[a], draws[b]), (a, b)
    ref = torch.Generator(device=dev)
    ref.manual_seed(11)
    assert torch.equal(draws[0], torch.rand(out.shape, generator=ref,
                                            device=dev))


def test_bench_dispatch_on_card(dev):
    """The bench's captured tick at (1024, 8): one K1-gen launch a
    replay, new audio each replay, the gate under 1e-4 dB."""
    from waveform_tpu_torch import bench
    cfg = bench.build_cfg(1024, 800)
    m = bench.measure(cfg, 8, 4, 1, 1, dev, seed=0, rounds=1)
    assert m["launches"]["K1-gen"] == m["timed_ticks"] == 4
    d = m["dispatch"]
    window = d.ring.buf[0].cpu().numpy().astype(np.float64)
    assert bench.accuracy_gate(cfg, window, dev)[0] < 1e-4


# --- the tick's own tracing: the stamped twin (runtime/profiler.py) --------

TRACE_STAGES = ("tick.push", "tick.fft", "tick.tail", "tick.rebin")


@pytest.fixture
def tracing():
    """The profiler with its switch off and its registry empty, and so
    left after the test."""
    from waveform_tpu_torch.runtime import profiler
    profiler.set_tracing(False)
    profiler.reset()
    yield profiler
    profiler.set_tracing(False)
    profiler.reset()


def _trace_cfg(n):
    return resolve(Settings(fft_size=n, enable_large_fft=n > 8192, width=800,
                            window=FFTWindow.HANN,
                            interp_mode=InterpMode.LANCZOS),
                   AudioInfo(48000, 2))


class _Replays:
    """A graph that counts its replays."""

    def __init__(self, graph):
        self.graph, self.n = graph, 0

    def replay(self):
        self.n += 1
        self.graph.replay()


@pytest.mark.parametrize("n,S", [(65536, 32), (4096, 256)])
def test_stamped_twin_matches_plain_graph_bitwise(n, S, dev, tracing):
    """Two engines on the same packets, one ticked with tracing on: the
    pixels agree bit for bit over 20 ticks; the traced engine replays its
    stamped twin, the other its plain graph; each stage reads positive
    on the device clock, once a replay, and a closed loop misses none."""
    cfg = _trace_cfg(n)
    plain = ServingEngine(cfg, S, device=dev)
    traced = ServingEngine(cfg, S, device=dev)
    rng = np.random.default_rng(17)
    for k in range(20):
        x = _packets(rng, S, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        plain.feed_batch(x, now, now_ns=now)
        traced.feed_batch(x, now, now_ns=now)
        tracing.set_tracing(False)
        a = plain.tick(now_ns=now)
        tracing.set_tracing(True)
        b = traced.tick(now_ns=now)
        assert torch.equal(a, b), k
        if k == 0:      # the warm-up and both captures; then count replays
            p, t = plain._ticks[("tick", True)], traced._ticks[("tick", True)]
            assert p.twin is not None and t.twin is not None
            p.graph, p.twin = _Replays(p.graph), _Replays(p.twin)
            t.graph, t.twin = _Replays(t.graph), _Replays(t.twin)
    assert (p.graph.n, p.twin.n, t.graph.n, t.twin.n) == (19, 0, 0, 19)
    torch.cuda.synchronize()
    snap = tracing.snapshot()
    assert list(snap["marks"]) == list(TRACE_STAGES)
    for name in TRACE_STAGES:
        m = snap["marks"][name]
        assert m["count"] == 19 and m["total_us"] > 0, (name, m)
    assert snap["counters"].get("marks.missed", 0) == 0
    assert snap["counters"]["graph.captures"] == {"tick,True": 2}
    assert snap["setup"]["graph.capture"]["count"] == 2


def test_marks_lie_within_the_replay_and_never_wait(dev, tracing):
    """At (65536, 32): one traced tick's four stages add up to no more
    than the device interval around the tick; the host returns from
    ``tick()`` before the device has finished it (no mark read waits)."""
    S = 32
    eng = ServingEngine(_trace_cfg(65536), S, device=dev)
    rng = np.random.default_rng(18)
    tracing.set_tracing(True)

    def tick(k):
        now = 10_000_000_000 + k * 16_666_667
        eng.feed_batch(_packets(rng, S, 2, False, k), now, now_ns=now)
        return eng.tick(now_ns=now)

    for k in range(3):
        tick(k)
    torch.cuda.synchronize()
    tracing.reset()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    tick(3)
    e1.record()
    torch.cuda.synchronize()
    marks = tracing.snapshot()["marks"]
    got = [marks[name]["total_us"] for name in TRACE_STAGES]
    assert all(us > 0 for us in got) and [marks[name]["count"] for name in
                                          TRACE_STAGES] == [1] * 4
    assert sum(got) <= e0.elapsed_time(e1) * 1e3, (got, e0.elapsed_time(e1))
    pending = []
    for k in range(4, 12):
        tick(k)
        ev = torch.cuda.Event()
        ev.record()
        pending.append(ev.query())
    assert not all(pending)
    torch.cuda.synchronize()


def test_program_ranges_label_idle_gaps_and_leave_no_device_op(dev,
                                                               tracing):
    """Under ``profiler.trace`` the tick's host spans land as
    ``waveform.*`` ranges on the host only (no device-side annotation
    counted as a device operation), and ``device_summary`` puts the
    device's idle time down to them."""
    S = 256
    eng = ServingEngine(_trace_cfg(4096), S, device=dev)
    rng = np.random.default_rng(19)

    def tick(k):
        now = 10_000_000_000 + k * 16_666_667
        eng.feed_batch(_packets(rng, S, 2, False, k), now, now_ns=now)
        eng.tick(now_ns=now)
        torch.cuda.synchronize()

    for k in range(3):
        tick(k)
    t0 = time.perf_counter()
    with tracing.trace() as prof:
        for k in range(3, 13):
            tick(k)
    summ = tracing.device_summary(prof, time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    ours = [ev for ev in prof.events() if ev.name.startswith("waveform.")]
    assert {ev.name for ev in ours} >= {
        "waveform.serving.feed", "waveform.serving.stage",
        "waveform.serving.upload", "waveform.serving.replay"}
    assert not [ev for ev in ours if ev.device_type == cuda]
    assert not [k for k in summ["kernels"] if k.startswith("waveform.")]
    idle = summ["idle_by_span"]
    assert "serving.stage" in idle and set(idle) <= {
        "serving.feed", "serving.stage", "serving.upload", "serving.replay",
        tracing.CALLER}
    assert tracing.snapshot()["marks"]["tick.fft"]["count"] == 10


# --- the rotating sample ring ----------------------------------------------

@pytest.mark.parametrize("form", ["host", "device", "per_stream"])
def test_ring_push_kernel_matches_its_twin(form, dev):
    """The ring's push kernel at (S, C, L, H) = (32, 2, 65536, 1616)
    against its CPU twin over 40 pushes (counts 0, 1, H and H + 5 among
    them, heads past a wrap of the ring), buffer and heads bit for bit,
    one ``ring`` launch a push; its window equals the shifting ring's."""
    from waveform_tpu_torch.dsp import devring
    from waveform_tpu_torch.kernels.ring_cuda import ring_push_ref

    S, C, L, H = 32, 2, 65536, 1616
    rng = np.random.default_rng(len(form))
    ring = devring.init_ring(S, C, L, device=dev, rotating=True)
    shifted = devring.init_ring(S, C, L, device=dev)
    buf, head = ring.buf.cpu(), ring.head.cpu()
    for k in range(40):
        count = [0, 1, H, H + 5, 1024, 800][k % 6]
        new = torch.from_numpy(rng.standard_normal((S, C, H))
                               .astype(np.float32))
        if form == "host":
            counts, host = count, count
        elif form == "device":
            counts = torch.tensor(count, dtype=torch.int64, device=dev)
            host = counts.cpu()
        else:
            host = torch.from_numpy(rng.integers(-3, H + 8, S))
            counts = host.to(dev)
        before = LAUNCHES["ring"]
        devring.push_rotating(ring, new.to(dev), counts)
        assert LAUNCHES["ring"] == before + 1
        ring_push_ref(buf, head, new, host)
        devring.push(shifted, new.to(dev), counts)
    torch.cuda.synchronize()
    assert torch.equal(ring.buf.cpu(), buf) and torch.equal(ring.head.cpu(),
                                                            head)
    assert head.any() and torch.equal(devring.window(ring), shifted.buf)


@pytest.mark.parametrize("kernel,n,S", [("K2", 65536, 32),
                                        ("K2-df", 65536, 32),
                                        ("K1-gen", 4096, 256),
                                        ("K1-df", 4096, 256)])
def test_pair_kernels_read_the_heads(kernel, n, S, dev):
    """Each pair kernel given random heads equals the same kernel on the
    windows put in order, bit for bit in magnitudes and nonzero counts;
    zero heads equal no heads."""
    from waveform_tpu_torch.kernels.ring_cuda import unrolled

    fn = (exact_cuda.rfft_pair_mag3 if kernel.startswith("K2")
          else exact_cuda.rfft_pair_mag_gen)
    tier = "df" if kernel.endswith("df") else "f32"
    rng = np.random.default_rng(n + S + len(kernel))
    x = torch.from_numpy((0.4 * rng.standard_normal((S, 2, n)))
                         .astype(np.float32)).to(dev)
    x[1, 0, : n // 3] = 0.0
    x[-1, -1] = 0.0
    head = torch.from_numpy(rng.integers(0, n, (S, 2)).astype(np.int32))
    head[0, 0], head[-1, 0] = 0, n - 1
    head = head.to(dev)
    _, win = _hann(n, dev)
    before = LAUNCHES[kernel]
    mag, nz = fn(x, win, twiddle=tier, head=head)
    want, want_nz = fn(unrolled(x, head), win, twiddle=tier)
    zero, zero_nz = fn(x, win, twiddle=tier, head=torch.zeros_like(head))
    plain, plain_nz = fn(x, win, twiddle=tier)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == before + 4
    assert torch.equal(mag, want) and torch.equal(nz, want_nz)
    assert torch.equal(zero, plain) and torch.equal(zero_nz, plain_nz)


@pytest.mark.parametrize("per_stream", [False, True],
                         ids=["synced", "per_stream"])
def test_rotating_engine_equals_the_shifting_engine(per_stream, dev,
                                                    monkeypatch):
    """A ``ServingEngine`` at (65536, 32) on the rotating ring and one put
    on the shifting ring: the same pixels bit for bit over 50 ticks of
    1024-frame packets, fed in one batch (about one tick in five without
    a packet) or stream by stream at each stream's own phase; the
    rotating engine's replay launches the ring's push in place of the
    shifting ring's torch ops."""
    from waveform_tpu_torch.dsp import devring
    from waveform_tpu_torch.runtime import serving

    cfg = resolve(Settings(fft_size=65536, enable_large_fft=True, width=800,
                           window=FFTWindow.HANN,
                           interp_mode=InterpMode.CATROM),
                  AudioInfo(48000, 2))
    S = 32
    rot = ServingEngine(cfg, S, device=dev)
    monkeypatch.setattr(serving, "reads_rotating_ring", lambda *args: False)
    shift = ServingEngine(cfg, S, device=dev)
    assert rot._ring.head is not None and shift._ring.head is None
    rng = np.random.default_rng(24 + per_stream)
    for k in range(50):
        now = 10_000_000_000 + k * 16_666_667
        x = (0.3 * rng.standard_normal((S, 2, 1024))).astype(np.float32)
        x[-1] = 0.0
        for eng in (rot, shift):
            if per_stream:
                for s in range(S):
                    if (k + s) % 4:
                        eng.feed(s, x[s, :, :1024 - 16 * (s % 8)], now,
                                 now_ns=now)
            elif k % 9 not in (4, 8):
                eng.feed_batch(x, now, now_ns=now)
        a, b = rot.tick(now_ns=now), shift.tick(now_ns=now)
        assert torch.equal(a, b), k
    torch.cuda.synchronize()
    # the public ring is the windows in order on both layouts
    assert rot._ring.head.any() and rot.ring.head is None
    assert torch.equal(rot.ring.buf, shift.ring.buf)
    assert torch.equal(rot.ring.buf, devring.window(rot._ring))
    assert not torch.equal(rot.ring.buf, rot._ring.buf)
    replays = rot.kernels_per_replay
    assert all(r == {"K2": 1, "ring": 1, "tail": 2, "rebin": 1}
               for r in replays.values()), replays
    assert all(r == {"K2": 1, "tail": 2, "rebin": 1}
               for r in shift.kernels_per_replay.values())


STUDIO_STAGES = ("tick.push", "tick.fft", "tick.tail", "tick.interp",
                 "tick.filter", "tick.rebin")


def test_studio_look_stamped_twin_matches_plain_graph(dev, tracing,
                                                      monkeypatch):
    """The benchmark's studio look at (16384, 256): stereo,
    Blackman-Harris, fast peaks, slope, roll-off, the Lanczos interp and
    the Gaussian filter.  Two engines on the same packets,
    one ticked with tracing on: the pixels agree bit for bit over 20
    ticks; the rebin's two extra stages read positive once a replay, a
    traced tick's six stages fit inside the device interval around it,
    every traced tick counts as filtered, and a replay launches K2, the
    ring's push, the tail's pair and the rebin's two kernels alone."""
    from waveform_tpu_torch import FilterMode

    # the split the packaged H100 plan picks at 16384 (this file's tests
    # otherwise hold the default rule, which picks K1-gen there)
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", "3")
    cfg = resolve(Settings(fft_size=16384, enable_large_fft=True, width=800,
                           channel_mode=ChannelMode.STEREO,
                           window=FFTWindow.BLACKMAN_HARRIS,
                           interp_mode=InterpMode.LANCZOS,
                           filter_mode=FilterMode.GAUSS, filter_radius=1.5,
                           fast_peaks=True, slope=1.0, rolloff_q=1.0,
                           rolloff_rate=12.0),
                  AudioInfo(48000, 2))
    S = 256
    plain = ServingEngine(cfg, S, device=dev)
    traced = ServingEngine(cfg, S, device=dev)
    rng = np.random.default_rng(25)

    for k in range(20):
        x = _packets(rng, S, 2, False, k)
        now = 10_000_000_000 + k * 16_666_667
        plain.feed_batch(x, now, now_ns=now)
        traced.feed_batch(x, now, now_ns=now)
        tracing.set_tracing(False)
        a = plain.tick(now_ns=now)
        tracing.set_tracing(True)
        b = traced.tick(now_ns=now)
        assert torch.equal(a, b), k
    torch.cuda.synchronize()
    snap = tracing.snapshot()
    assert list(snap["marks"]) == list(STUDIO_STAGES)
    for name in STUDIO_STAGES:
        m = snap["marks"][name]
        assert m["count"] == 19 and m["total_us"] > 0, (name, m)
    c = snap["counters"]
    assert c.get("marks.missed", 0) == 0
    assert c["ticks.filtered"] == c["ticks.uniform"] == 20
    now = 10_000_000_000 + 20 * 16_666_667
    traced.feed_batch(_packets(rng, S, 2, False, 20), now, now_ns=now)
    tracing.reset()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    traced.tick(now_ns=now)
    e1.record()
    torch.cuda.synchronize()
    marks = tracing.snapshot()["marks"]
    assert [marks[name]["count"] for name in STUDIO_STAGES] == [1] * 6
    got = [marks[name]["total_us"] for name in STUDIO_STAGES]
    assert all(us > 0 for us in got)
    assert sum(got) <= e0.elapsed_time(e1) * 1e3, (got, e0.elapsed_time(e1))
    assert traced.kernels_per_replay == {
        ("tick", True): {"K2": 1, "ring": 1, "tail": 2, "rebin": 2}}


def test_default_look_under_per_stream_packets(dev, tracing):
    """The benchmark's default look (``wfbench/configs/default4096.json``:
    mono, Hann, Catmull-Rom, 4096 points) at 256 sources fed as its
    ``packets`` traffic feeds them: one ``feed`` a 1024-frame packet at
    each source's own phase.  Two engines on the same packets, one ticked
    with tracing on: the pixels agree bit for bit; the per-row tick's
    replay launches K1-gen, the ring's push, the tail's pair and the
    interp kernel alone; the ring's heads differ from row to row; the
    counters count every packet and tick; and four late ticks hold to the
    float64 PyTorch reference within the configuration's limits."""
    import importlib.util
    import json
    from pathlib import Path

    from waveform_tpu_torch import VideoInfo
    from waveform_tpu_torch.core.settings_io import settings_from_obs
    from wfbench import compare
    from wfbench.generator import Traffic

    root = Path(__file__).resolve().parents[1] / "wfbench"
    dep = json.loads((root / "configs" / "default4096.json").read_text())
    mix = json.loads((root / "traffic" / "packets.json").read_text())
    spec = importlib.util.spec_from_file_location(
        "default_reference", root / "reference" / "spectrum_torch.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    cfg = resolve(settings_from_obs(dep["settings"]), AudioInfo(48000, 2),
                  VideoInfo(60))
    S, ticks = 256, 60
    gen = Traffic(mix, S, 2, cfg.fft_size, 48000, 60, 2 ** 31 + 2027)
    checked = [48, 53, 57, 60]
    plain = ServingEngine(cfg, S, device=dev)
    traced = ServingEngine(cfg, S, device=dev)
    kept, fed = [], 0
    for k in range(1, ticks + 1):
        now = gen.now_ns(k)
        packets = gen.packets(k)
        tracing.set_tracing(False)
        for s, data, ts in packets:
            plain.feed(s, data, ts, now_ns=now)
        a = plain.tick(now_ns=now)
        tracing.set_tracing(True)
        for s, data, ts in packets:
            traced.feed(s, data, ts, now_ns=now)
        b = traced.tick(now_ns=now)
        fed += len(packets)
        assert torch.equal(a, b), k
        if k in checked:
            kept.append(a.double().cpu().numpy())
    torch.cuda.synchronize()
    tracing.set_tracing(False)
    assert plain.kernels_per_replay[("tick", False)] == {
        "K1-gen": 1, "ring": 1, "tail": 2, "rebin": 1}
    assert traced.kernels_per_replay == plain.kernels_per_replay
    # each row's head sits past the samples it was fed: 45 or 46 packets
    # by now, by its phase
    head = plain._ring.head.cpu()
    L = plain._ring.buf.shape[-1]
    fed_head = torch.from_numpy((gen.ends(ticks) % L).astype(np.int32))
    assert torch.equal(head, fed_head[:, None].expand_as(head))
    assert len(torch.unique(head)) > 1
    assert torch.equal(head, traced._ring.head.cpu())
    c = tracing.snapshot()["counters"]
    assert c["feed.packets"] == fed == int(gen.fed(ticks).sum())
    assert c["ticks.rotating"] == ticks
    assert c["ticks.gather"] + c.get("ticks.uniform", 0) == ticks
    look = reference.Look(dep["settings"], dep["audio"], dep["fps"])
    want = reference.expected_pixels(look, gen.ends, gen.frames,
                                     gen.first_tick, checked, ticks,
                                     device=dev)
    checks = compare.checks(np.stack(kept), want, dep["check"])
    assert set(checks) == {"max_db_gap", "p99_db_gap"}
    assert all(v["value"] <= v["limit"] for v in checks.values()), checks
