"""The spectrum tail's kernel pair on the card, bit for bit against its
plain version.

Marked ``cuda``; every test skips without a CUDA device.  On a machine
with one, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_tail_cuda.py

``kernels/tail_cuda.spectrum_tail`` and ``dsp/spectrum.spectrum_tail_ref``
take the same CUDA inputs, tick after tick, for every config branch of
the step; the state carries on from the plain version's output.  A
script of per-stream roles walks the gating states: a latch set and
released, one channel silent, every channel silent below the gate
(frozen), a near-silent frame one bin above the gate, timeouts fresh and
latched, streams that do not run, channels that are not valid; the
magnitudes hold zeros (DB_MIN) and subnormals.
"""

import numpy as np
import pytest
import torch

import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp import spectrum as tspec
from waveform_tpu_torch.kernels import tail_cuda
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES
from waveform_tpu_torch.runtime.serving import ServingEngine
from waveform_tpu_torch.utils import plans

pytestmark = pytest.mark.cuda

TICKS = 8
ROLES = 8          # stream s plays role s % ROLES

# name: (settings, audio channels)
CONFIGS = {
    "stereo": (dict(channel_mode=wt.ChannelMode.STEREO), 2),
    "mono2": (dict(), 2),
    "mono1": (dict(), 1),
    "stereo_one": (dict(channel_mode=wt.ChannelMode.STEREO), 1),   # O > C
    "slope": (dict(slope=3.0), 2),
    "rolloff": (dict(rolloff_q=1.0, rolloff_rate=6.0,
                     channel_mode=wt.ChannelMode.STEREO), 2),
    "normalize": (dict(normalize_volume=True, volume_target=-9.5,
                       max_gain=12.3), 2),
    "no_smoothing": (dict(temporal_smoothing=wt.TSmoothingMode.NONE), 2),
    "tv_ema": (dict(temporal_smoothing=wt.TSmoothingMode.TVEXPONENTIAL), 2),
    "fast_peaks": (dict(fast_peaks=True), 2),
}
# (fft_size, streams, nbins handed to the wrapper): the benchmark's cell,
# the headline, and an nbins the 16-byte vector does not divide
SHAPES = [(65536, 32, 32768), (4096, 256, 2048), (4096, 8, 405)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _script(S, C, t):
    """Tick ``t``'s masks for S streams: (nz_k, valid, active, run, plant,
    spike) as host arrays; ``plant`` streams get their old m_decibels set
    below the gate before the tick, ``spike`` streams too but for one bin
    above it in the last bin."""
    role = np.arange(S) % ROLES
    nz = np.ones((S, C), bool)
    valid = np.ones((S, C), bool)
    active = np.ones(S, bool)
    run = np.ones(S, bool)
    plant = np.zeros(S, bool)
    spike = np.zeros(S, bool)
    if t >= 1:
        nz[role == 1, C - 1] = False              # one channel silent
    if 2 <= t <= 5:                               # latch set, then frozen
        nz[role == 2] = False
        plant |= (role == 2) & (t == 2)
    if 3 <= t <= 4:                               # fresh timeout
        active[role == 3] = False
    if t >= 1:                                    # latched, then timed out
        nz[role == 4] = False
        plant |= (role == 4) & (t == 1)
        active[role == 4] = not 3 <= t <= 4
    if t in (2, 5):
        run[role == 5] = False                    # not run
    if 1 <= t <= 3:
        valid[role == 6, 0] = False               # not valid
    if 2 <= t <= 4:                               # silent, one bin above
        nz[role == 7] = False
        spike |= role == 7
    return nz, valid, active, run, plant, spike


def _inputs(k, S, n, t, gen, dev):
    """The FFT's output for tick ``t``: noise magnitudes with zeros and
    subnormals, zero where a channel has no nonzero sample."""
    C = k.channels
    mag = torch.rand((S, C, n), generator=gen, device=dev) * 40.0
    u = torch.rand((S, C, n), generator=gen, device=dev)
    mag = torch.where(u < 0.05, torch.zeros_like(mag), mag)
    mag = torch.where((u >= 0.05) & (u < 0.1), mag * 1e-40, mag)
    rms = torch.rand(S, generator=gen, device=dev) * 0.3
    rms[0] = 0.0
    return mag, rms


def _run_matrix(cfg, S, n, dev, tables=None):
    """TICKS ticks of the kernel pair and the plain version on the same
    inputs: (tsmooth, decibels, last_silent) equal bit for bit each tick.
    Returns the latch's history [TICKS, S]."""
    k = tail_cuda.tail_constants(cfg)
    C = k.channels
    slope, rolloff = tables if tables is not None else tspec.tail_tables(
        cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n * 1000 + S)
    state = tspec.init_state(cfg, S, dev)
    if n != state.tsmooth.shape[-1]:
        state = tspec.SpectrumState(state.tsmooth[..., :n].contiguous(),
                                    state.decibels[..., :n].contiguous(),
                                    state.last_silent)
    gate = k.floor_gate
    history = []
    for t in range(TICKS):
        nz, valid, active, run, plant, spike = (
            torch.from_numpy(a).to(dev) for a in _script(S, C, t))
        low = plant | spike
        state.decibels[low] = gate - 5.0
        state.decibels[spike, :, -1] = 0.0
        mag, rms = _inputs(k, S, n, t, gen, dev)
        mag = torch.where(nz[:, :, None], mag, torch.zeros_like(mag))
        # dt alternates between a float and the [2] tensor a graph reads
        dt = 1 / 60 + 0.003 * t
        pair = tspec.gravity_pair(cfg, dt)
        gravity = (torch.from_numpy(pair).to(dev) if t % 2 else
                   (float(pair[0]), float(pair[1])))
        v, r = (None, None) if t == 0 else (valid, run)
        before = LAUNCHES["tail"]
        got = tail_cuda.spectrum_tail(
            k, mag, nz, v, state.tsmooth, state.decibels, state.last_silent,
            gravity, active, rms if k.normalize else None, r, slope, rolloff)
        assert LAUNCHES["tail"] == before + 2
        want = tspec.spectrum_tail_ref(
            cfg, mag, nz, v, state, gravity if t % 2 else dt, active, rms,
            r, slope, rolloff)
        torch.cuda.synchronize()
        for name, a, b in zip(("tsmooth", "decibels", "last_silent"), got,
                              (want.tsmooth, want.decibels,
                               want.last_silent)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b), (t, name)
        state = want
        history.append(want.last_silent.cpu().numpy())
    return np.array(history)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}_{s[2]}")
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tail_pair_matches_plain_version_bitwise(config, shape, dev):
    """Every config branch at the benchmark's (65536, 32), the headline's
    (4096, 256) and nbins = 405 (single floats): the kernel pair's
    tsmooth, decibels and latch equal the plain version's bit for bit in
    every tick of the gating script; two launches a call."""
    settings, channels = CONFIGS[config]
    n_fft, S, n = shape
    cfg = wt.resolve(wt.Settings(fft_size=n_fft, enable_large_fft=True,
                                 window=wt.FFTWindow.HANN, **settings),
                     wt.AudioInfo(48000, channels))
    tables = None
    if n != n_fft // 2:
        slope, rolloff = tspec.tail_tables(cfg, dev)
        tables = (None if slope is None else slope[:n].contiguous(),
                  None if rolloff is None else rolloff[:n].contiguous())
    history = _run_matrix(cfg, S, n, dev, tables)
    role = np.arange(S) % ROLES
    # the script reached its states: the latch set and released, the
    # latched timeout kept, the near-silent frame never latched
    assert history[2:6, role == 2].all() and not history[6, role == 2].any()
    assert history[1:, role == 4].all()
    assert not history[:, role == 7].any()


def test_serving_tick_replays_one_tail_pair(dev, tmp_path, monkeypatch):
    """A captured ``ServingEngine`` tick at (65536, 32), mono (the
    benchmark's configuration): two tail launches a replay beside the one
    K2 launch, the ring's push and the rebin's interp."""
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", str(tmp_path / "none.json"))
    monkeypatch.setattr(plans, "_packaged_plans", lambda: {})
    cfg = wt.resolve(wt.Settings(fft_size=65536, enable_large_fft=True,
                                 window=wt.FFTWindow.HANN),
                     wt.AudioInfo(48000, 2))
    eng = ServingEngine(cfg, 32, device=dev)
    rng = np.random.default_rng(3)
    for k in range(3):
        now = 10_000_000_000 + k * 16_666_667
        x = (0.3 * rng.standard_normal((32, 2, 800))).astype(np.float32)
        eng.feed_batch(x, now, now_ns=now)
        before = LAUNCHES["tail"]
        eng.tick(now_ns=now)
        assert LAUNCHES["tail"] == before + 2, k
    assert eng.kernels_per_replay == {("tick", True): {"K2": 1, "ring": 1,
                                                       "tail": 2, "rebin": 1}}
    assert torch.isfinite(eng.state.decibels).all()
