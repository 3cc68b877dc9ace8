"""The port's own host modules against the JAX package's.

The port keeps copies of the JAX package's host modules (config, enums,
property sheet, sample ring, windows, float64 oracle, rebin tables, native
assembler) so that it imports nothing of that package.  Each copy must
behave as its original: the same settings resolve to the same fields
(enum members compared by class and member name), the tables and the
oracle give the same bits, the two native assemblers pack the same rows.
A config resolved by the JAX package is refused by the port's entry
points with TypeError.
"""

import dataclasses
import enum
import itertools

import numpy as np
import pytest
import torch

import waveform_tpu as jwt
from waveform_tpu.core import properties as jprops
from waveform_tpu.core import ring as jring
from waveform_tpu.dsp import oracle as joracle
from waveform_tpu.dsp import windows as jwin
from waveform_tpu.native import NativeAssembler as JaxAssembler
from waveform_tpu.rebin import filter as jfilter
from waveform_tpu.rebin import interp as jinterp
import waveform_tpu_torch as wt
from waveform_tpu_torch.core import properties as tprops
from waveform_tpu_torch.core import ring as tring
from waveform_tpu_torch.dsp import oracle as toracle
from waveform_tpu_torch.dsp import spectrum as tspec
from waveform_tpu_torch.dsp import windows as twin
from waveform_tpu_torch.native import NativeAssembler as PortAssembler
from waveform_tpu_torch.rebin import apply as tapply
from waveform_tpu_torch.rebin import filter as tfilter
from waveform_tpu_torch.rebin import interp as tinterp
from waveform_tpu_torch.runtime.serving import ServingEngine

ENUMS = ("ChannelMode", "DisplayMode", "FFTWindow", "FilterMode",
         "InterpMode", "PulseMode", "RenderMode", "TSmoothingMode")


def _plain(v):
    """A config value with enum members as (class, name) and dataclasses as
    dicts, comparable across the two packages."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_plain(a) for a in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _both(channels=2, **kw):
    """``kw`` (port enum members) resolved by each package:
    ``(port_cfg, jax_cfg)``."""
    jkw = {k: (getattr(jwt, type(v).__name__)[v.name]
               if isinstance(v, enum.Enum) else v) for k, v in kw.items()}
    return (wt.resolve(wt.Settings(**kw), wt.AudioInfo(48000, channels)),
            jwt.resolve(jwt.Settings(**jkw), jwt.AudioInfo(48000, channels)))


# FFT sizes with the resolve rules they exercise: the 128 floor, the
# 8192 cap and the large-FFT unlock, a slider position, the auto size
_SIZES = [(100, False, False), (4096, False, False), (6144, False, False),
          (9000, False, False), (9000, False, True), (65536, False, True),
          (4096, True, False)]


def _grid(i):
    """Settings number ``i`` of a grid that takes every enum member at
    least once over its 14 entries."""
    def pick(e):
        members = list(e)
        return members[i % len(members)]
    n, auto, large = _SIZES[i % len(_SIZES)]
    return dict(fft_size=n, auto_fft_size=auto, enable_large_fft=large,
                window=pick(wt.FFTWindow), channel_mode=pick(wt.ChannelMode),
                display_mode=pick(wt.DisplayMode),
                interp_mode=pick(wt.InterpMode),
                filter_mode=pick(wt.FilterMode),
                temporal_smoothing=pick(wt.TSmoothingMode),
                render_mode=pick(wt.RenderMode),
                pulse_mode=pick(wt.PulseMode))


_GRID = [_grid(i) for i in range(14)]


def test_enums_match_jax():
    for name in ENUMS:
        port, ref = getattr(wt, name), getattr(jwt, name)
        assert [(m.name, m.value) for m in port] == [(m.name, m.value)
                                                      for m in ref]
        assert port is not ref


@pytest.mark.parametrize("channels", [1, 2, 6])
@pytest.mark.parametrize("i", range(len(_GRID)))
def test_resolve_matches_jax(i, channels):
    port, ref = _both(channels, **_GRID[i])
    assert type(port) is wt.ResolvedConfig
    assert _plain(port) == _plain(ref)


def test_property_sheet_matches_jax():
    assert _plain(tprops.PROPERTIES) == _plain(jprops.PROPERTIES)
    for kw in _GRID:
        port, ref = _both(**kw)
        assert (tprops.visible_properties(port.settings)
                == jprops.visible_properties(ref.settings))


def test_ring_matches_jax():
    for sr, v in itertools.product((44100, 48000, 96000),
                                   (0, 1, 799, 16_666_667, 10**12)):
        assert tring.ns_to_audio_frames(sr, v) == jring.ns_to_audio_frames(
            sr, v)
        assert tring.audio_frames_to_ns(sr, v) == jring.audio_frames_to_ns(
            sr, v)
    rng = np.random.default_rng(1)
    port, ref = tring.SampleRing(), jring.SampleRing()
    for k in range(20):
        x = rng.standard_normal(int(rng.integers(1, 700))).astype(np.float32)
        for r in (port, ref):
            r.push_back(x)
            r.push_back_zero(k)
        assert port.size == ref.size
        if k % 3 == 2:
            n = min(port.size, 300)
            np.testing.assert_array_equal(port.peek_front(n),
                                          ref.peek_front(n))
            assert port.pop_front(n // 2) == ref.pop_front(n // 2)


@pytest.mark.parametrize("n", [128, 800, 6144])
def test_window_tables_match_jax(n):
    for w, e in itertools.product(wt.FFTWindow, (1, 2, 5)):
        jw = jwt.FFTWindow[w.name]
        np.testing.assert_array_equal(twin.window_coefficients(w, n, e),
                                      jwin.window_coefficients(jw, n, e))
        assert twin.window_sum(w, n, e) == jwin.window_sum(jw, n, e)


@pytest.mark.parametrize("i", [0, 1, 2, 3, 4, 8, 12])
def test_rebin_tables_match_jax(i):
    port, ref = _both(width=300, bar_width=8, bar_gap=2, **_GRID[i])
    got, want = tinterp.build_interp_tables(port), jinterp.build_interp_tables(
        ref)
    assert _plain(got) == _plain(want)
    np.testing.assert_array_equal(tinterp.mirror_indices(301),
                                  jinterp.mirror_indices(301))
    for sigma, n in ((0.5, 7), (1.5, 300), (4.0, 800)):
        assert _plain(tfilter.build_gauss_tables(sigma, n)) == _plain(
            jfilter.build_gauss_tables(sigma, n))


@pytest.mark.parametrize("kw", [
    dict(fft_size=4096),
    dict(fft_size=6144, channel_mode=wt.ChannelMode.STEREO,
         window=wt.FFTWindow.BLACKMAN, slope=1.5, rolloff_q=1.0,
         rolloff_rate=12.0),
    dict(fft_size=2048, temporal_smoothing=wt.TSmoothingMode.TVEXPONENTIAL,
         fast_peaks=True, window=wt.FFTWindow.NONE)])
def test_oracle_frame_matches_jax_bitwise(kw):
    port, ref = _both(**kw)
    rng = np.random.default_rng(kw["fft_size"])
    x = rng.standard_normal((2, port.fft_size))
    x[1] *= 1e-3
    ts_p = ts_j = None
    for _ in range(3):
        db_p, ts_p = toracle.spectrum_frame(x, ts_p, port, dt=1 / 60)
        db_j, ts_j = joracle.spectrum_frame(x, ts_j, ref, dt=1 / 60)
        np.testing.assert_array_equal(db_p, db_j)
        np.testing.assert_array_equal(ts_p, ts_j)


def test_native_assemblers_pack_the_same_rows():
    try:
        port = PortAssembler(3, 2, 1024, 48000, prefill=False, rms=True)
        ref = JaxAssembler(3, 2, 1024, 48000, prefill=False, rms=True)
    except RuntimeError:
        pytest.skip("no C++ toolchain for the native assembler")
    rng = np.random.default_rng(2)
    H = 1616
    now = 10_000_000_000
    for k in range(6):
        now += 16_666_667
        for s in range(3):
            x = rng.standard_normal((2, 800 + 37 * s)).astype(np.float32)
            for a in (port, ref):
                a.feed(s, x, now, now, muted=(s == 1 and k == 2))
        if k == 3:
            for a in (port, ref):
                a.set_show(2, False)
        rows = [np.zeros((3, 2 * H + H + 3), np.float32) for _ in range(2)]
        port.assemble_hop_packed(now, H, rows[0], True)
        ref.assemble_hop_packed(now, H, rows[1], True)
        np.testing.assert_array_equal(rows[0], rows[1])
    assert port.ring_size(0) == ref.ring_size(0)


def test_port_entry_points_refuse_a_jax_config():
    port, ref = _both(fft_size=1024, width=200)
    with pytest.raises(TypeError, match="waveform_tpu_torch.resolve"):
        ServingEngine(ref, 2, device="cpu")
    with pytest.raises(TypeError):
        tspec.make_spectrum_step(ref, device="cpu")
    with pytest.raises(TypeError):
        tspec.init_state(ref, 2, device="cpu")
    with pytest.raises(TypeError):
        tapply.make_rebin_fn(ref, device="cpu")
    ServingEngine(port, 2, device="cpu")
    tapply.make_rebin_fn(port, device="cpu")
    step = tspec.make_spectrum_step(port, device="cpu")
    state = tspec.init_state(port, 2, device="cpu")
    x = torch.zeros((2, 2, 1024))
    step(x, state, 1 / 60, torch.ones(2, dtype=torch.bool), torch.zeros(2))
