"""The spectrum tail's kernel wrapper (``kernels/tail_cuda.py``) on the CPU.

The kernel pair runs only on the card (``tests/test_torch_tail_cuda.py``
holds it to the plain version bit for bit).  Here: the config's kernel
constants for each branch the step takes, the block count, the wrapper's
argument checks, the kernel source's float constants against the plain
version's, and a CPU step that runs the plain version and never builds
the library.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import waveform_tpu_torch as wt
from waveform_tpu_torch.core.config import DB_MIN
from waveform_tpu_torch.dsp import spectrum as tspec
from waveform_tpu_torch.kernels import cuda_lib, tail_cuda

SRC = (Path(tspec.__file__).resolve().parent.parent / "csrc"
       / "spectrum_tail.cu")

# name: (settings, audio channels, (C, O, D, stereo), smooth, slope,
# rolloff) -- the step's branches
BRANCHES = {
    "mono2": (dict(), 2, (2, 2, 1, False), True, False, False),
    "stereo": (dict(channel_mode=wt.ChannelMode.STEREO), 2, (2, 2, 2, True),
               True, False, False),
    "mono1": (dict(), 1, (1, 1, 1, False), True, False, False),
    "single": (dict(channel_mode=wt.ChannelMode.SINGLE, channel=1), 2,
               (1, 1, 1, False), True, False, False),
    "stereo_one": (dict(channel_mode=wt.ChannelMode.STEREO), 1,
                   (1, 2, 2, True), True, False, False),
    "no_smoothing": (dict(temporal_smoothing=wt.TSmoothingMode.NONE), 2,
                     (2, 2, 1, False), False, False, False),
    "tv_ema": (dict(temporal_smoothing=wt.TSmoothingMode.TVEXPONENTIAL), 2,
               (2, 2, 1, False), True, False, False),
    "fast_peaks": (dict(fast_peaks=True), 2, (2, 2, 1, False), True, False,
                   False),
    "slope": (dict(slope=3.0), 2, (2, 2, 1, False), True, True, False),
    "rolloff": (dict(rolloff_q=1.0, rolloff_rate=6.0), 2, (2, 2, 1, False),
                True, False, True),
    "normalize": (dict(normalize_volume=True, volume_target=-9.5,
                       max_gain=12.3), 2, (2, 2, 1, False), True, False,
                  False),
}


def _cfg(settings, channels, n=1024):
    return wt.resolve(wt.Settings(fft_size=n, window=wt.FFTWindow.HANN,
                                  **settings), wt.AudioInfo(48000, channels))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_tail_constants_follow_the_step_branches(branch):
    """Each config branch of the step gives the kernel the constants of
    the branch the plain version takes: the channel counts of
    ``_channels`` and ``display_channels``, the fold, the EMA test, fast
    peaks and normalize as flag bits, the step's f32 scalars; the tables
    exist where the config has them."""
    settings, channels, shape, smooth, slope, rolloff = BRANCHES[branch]
    cfg = _cfg(settings, channels)
    k = tail_cuda.tail_constants(cfg)
    assert (k.channels, k.outputs, k.display, k.stereo) == shape
    assert (k.channels, k.outputs) == tspec._channels(cfg)
    assert k.display == cfg.display_channels and k.stereo == cfg.stereo
    assert k.smooth == smooth == (cfg.tsmoothing != wt.TSmoothingMode.NONE)
    assert k.fast_peaks == cfg.fast_peaks
    assert k.normalize == cfg.normalize_volume
    want = ((tail_cuda.STEREO if k.stereo else 0)
            | (tail_cuda.SMOOTH if smooth else 0)
            | (tail_cuda.FAST_PEAKS if cfg.fast_peaks else 0)
            | (tail_cuda.NORMALIZE if cfg.normalize_volume else 0))
    assert k.flags == want
    # the scalars as the plain version rounds them: 2/Σw as _mag_tail's
    # f32, the gate and normalization constants in f32
    ones = torch.ones(1, 1, 4)
    assert k.coeff == float(tspec._mag_tail(cfg, ones, None)[0, 0, 0])
    assert k.floor_gate == float(np.float32(cfg.floor - 10))
    assert k.volume_target == float(np.float32(cfg.volume_target))
    assert k.max_gain == float(np.float32(cfg.max_gain))
    s_tab, r_tab = tspec.tail_tables(cfg, "cpu")
    assert (s_tab is not None) == slope and (r_tab is not None) == rolloff
    for t in (s_tab, r_tab):
        if t is not None:
            assert t.shape == (cfg.fft_size // 2,) and t.dtype == torch.float32


@pytest.mark.parametrize("streams, nbins, vec, want", [
    (32, 32768, 4, 9),        # the benchmark's cell: 288 gate blocks
    (256, 2048, 4, 2),        # (4096, 256): 512
    (1, 32768, 4, 32),        # a lone stream fills no more than its bins
    (8, 405, 1, 2),           # 405 single floats: two blocks of 256
    (4096, 64, 4, 1),         # never fewer than one block a stream
])
def test_tail_grid(streams, nbins, vec, want):
    """The gate's blocks a stream: GATE_BLOCKS over all streams, capped by
    the stream's vectors, at least one."""
    assert tail_cuda.tail_grid(streams, nbins, vec) == want


def _args(k, S=3, n=16):
    C, O = k.channels, k.outputs
    f32, b8 = torch.float32, torch.bool
    return dict(mag=torch.rand(S, C, n), nz_k=torch.ones(S, C, dtype=b8),
                valid=None, tsmooth=torch.zeros(S, C, n),
                decibels=torch.full((S, O, n), DB_MIN),
                last_silent=torch.zeros(S, dtype=b8),
                gravity=torch.tensor([0.65, 0.35], dtype=f32),
                active=torch.ones(S, dtype=b8), input_rms=torch.ones(S),
                run=None, slope=None, rolloff=None)


FAULTS = {
    "mag_dtype": ("mag", lambda a: a.double()),
    "mag_channels": ("mag", lambda a: a[:, :1]),
    "mag_layout": ("mag", lambda a: a.transpose(0, 1).contiguous()
                   .transpose(0, 1)),
    "nz_k_dtype": ("nz_k", lambda a: a.to(torch.uint8)),
    "valid_shape": ("valid", lambda a: torch.ones(3, 1, dtype=torch.bool)),
    "tsmooth_layout": ("tsmooth", lambda a: a.transpose(1, 2).contiguous()
                       .transpose(1, 2)),
    "decibels_shape": ("decibels", lambda a: a[:, :1]),
    "last_silent_dtype": ("last_silent", lambda a: a.float()),
    "active_shape": ("active", lambda a: a[:2]),
    "input_rms_dtype": ("input_rms", lambda a: a.double()),
    "run_layout": ("run", lambda a: torch.ones(6, dtype=torch.bool)[::2]),
    "slope_length": ("slope", lambda a: torch.ones(15)),
    "rolloff_dtype": ("rolloff", lambda a: torch.ones(16, dtype=torch.half)),
    "gravity_shape": ("gravity", lambda a: torch.ones(3)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_wrapper_checks_raise(fault, monkeypatch):
    """The wrapper raises ValueError on a wrong dtype, shape or layout,
    before it asks for the library; right arguments on the CPU raise too
    (the step sends CPU tensors to the plain version)."""
    def no_build():
        raise AssertionError("the library was built")
    monkeypatch.setattr(cuda_lib, "build", no_build)
    k = tail_cuda.tail_constants(_cfg(dict(normalize_volume=True), 2))
    args = _args(k)
    name, bad = FAULTS[fault]
    args[name] = bad(args[name] if args[name] is not None
                     else torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match=name):
        tail_cuda.spectrum_tail(k, **args)
    with pytest.raises(ValueError, match="CUDA"):
        tail_cuda.spectrum_tail(k, **_args(k))


def test_kernel_float_constants_are_the_plain_versions():
    """The kernel source's f32 literals are ``dsp/spectrum.py``'s df32
    constants, series coefficients, sqrt(1/2) and DB_MIN, bit for bit."""
    src = SRC.read_text()
    lit = dict(re.findall(r"constexpr float (k\w+) = (-?0x[0-9a-fp.+-]+)f;",
                          src))
    want = {"kCeHi": tspec._C_E_HI, "kCeLo": tspec._C_E_LO,
            "kCmHi": tspec._C_M_HI, "kCmLo": tspec._C_M_LO,
            "kInv3": tspec._INV[0], "kInv5": tspec._INV[1],
            "kInv7": tspec._INV[2], "kInv9": tspec._INV[3],
            "kSqrtHalf": tspec._SQRT_HALF, "kDbMin": float(np.float32(DB_MIN))}
    assert set(lit) == set(want)
    for name, v in want.items():
        assert float.fromhex(lit[name]) == v == float(np.float32(v)), name
    flags = re.search(r"constexpr int kStereo = (\d+), kSmooth = (\d+), "
                      r"kFastPeaks = (\d+), kNormalize = (\d+);", src)
    assert tuple(map(int, flags.groups())) == (
        tail_cuda.STEREO, tail_cuda.SMOOTH, tail_cuda.FAST_PEAKS,
        tail_cuda.NORMALIZE)
    assert f"constexpr int kThreads = {tail_cuda.THREADS};" in src


@pytest.mark.parametrize("branch", ["mono2", "stereo", "normalize"])
def test_cpu_step_runs_the_plain_tail(branch, monkeypatch):
    """A CPU step runs ``spectrum_tail_ref`` on the FFT's output and
    never builds or loads the library; no tail launch is counted."""
    def no_build():
        raise AssertionError("the library was built")
    monkeypatch.setattr(cuda_lib, "build", no_build)
    calls = []
    ref = tspec.spectrum_tail_ref

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return ref(*a, **kw)
    monkeypatch.setattr(tspec, "spectrum_tail_ref", spy)
    settings, channels = BRANCHES[branch][:2]
    cfg = _cfg(settings, channels, n=256)
    S, C = 3, max(cfg.capture_channels, 1)
    step = tspec.make_spectrum_step(cfg, device="cpu")
    state = tspec.init_state(cfg, S, "cpu")
    rng = np.random.default_rng(5)
    before = cuda_lib.LAUNCHES["tail"]
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((S, C, 256))
                             .astype(np.float32))
        state = step(x, state, 1 / 60, torch.ones(S, dtype=torch.bool),
                     torch.full((S,), 0.1))
    assert calls == [(S, C, 128)] * 3
    assert cuda_lib.LAUNCHES["tail"] == before
    assert state.decibels.shape == (S, max(cfg.output_channels, C), 128)
