"""The switches outside the exact FFT, port against the JAX package:
``WAVEFORM_TPU_FFT_BACKEND`` (the spectrum step's FFT backend), a caller's
``rfft_fn`` and ``WAVEFORM_TPU_REBIN`` (the rebin's interp form).

Under ``xla`` both steps take a plain f32 FFT of the f32-windowed frame;
the two FFT libraries round differently, so decibels are held within the
step tests' 1e-4 dB on bins above -120 dB (noise-dominated windows, as in
``test_torch_spectrum.py``), and the port's own decibels bit for bit to
``torch.fft.rfft`` of the windowed frame.
"""

import enum

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu import AudioInfo, ChannelMode, Settings, TSmoothingMode, resolve
from waveform_tpu.dsp import spectrum as jspec
from waveform_tpu.rebin import apply as japply
import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp import spectrum as tspec
from waveform_tpu_torch.dsp.windows import window_coefficients
from waveform_tpu_torch.kernels import matfft
from waveform_tpu_torch.rebin import apply as tapply

N, S, TICKS = 1024, 4, 3


def _cfgs(fft_size=N, **kw):
    """The same settings resolved by the JAX package and by the port (enum
    members passed by name): ``(jax_cfg, port_cfg)``."""
    port_kw = {k: (getattr(wt, type(v).__name__)[v.name]
                   if isinstance(v, enum.Enum) else v) for k, v in kw.items()}
    return (resolve(Settings(fft_size=fft_size, **kw), AudioInfo(48000, 2)),
            wt.resolve(wt.Settings(fft_size=fft_size, **port_kw),
                       wt.AudioInfo(48000, 2)))


@pytest.mark.parametrize("smoothing", [TSmoothingMode.NONE,
                                       TSmoothingMode.EXPONENTIAL])
def test_xla_backend_matches_jax(smoothing, monkeypatch):
    """ROADMAP C1: under WAVEFORM_TPU_FFT_BACKEND=xla the port runs the f32
    FFT, as the JAX step does (the port used to run its exact path)."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
    jcfg, tcfg = _cfgs(channel_mode=ChannelMode.STEREO,
                       temporal_smoothing=smoothing)
    assert tspec.resolve_fft_backend() == "xla"
    jstep = jspec.make_spectrum_step(jcfg)
    tstep = tspec.make_spectrum_step(tcfg, device="cpu")
    jst, tst = (jspec.init_state(jcfg, S),
                tspec.init_state(tcfg, S, device="cpu"))
    rng = np.random.default_rng(0)
    w32 = window_coefficients(tcfg.window, N, tcfg.sine_exponent,
                              dtype=np.float32)
    ones, rms = np.ones(S, bool), np.zeros(S, np.float32)
    for k in range(TICKS):
        x = (0.3 * rng.standard_normal((S, 2, N))).astype(np.float32)
        x[3] = 0.0                                  # a silent stream
        jst = jstep(jnp.asarray(x), jst, jnp.float32(1 / 60),
                    jnp.asarray(ones), jnp.asarray(rms))
        tst = tstep(torch.from_numpy(x), tst, 1 / 60, torch.from_numpy(ones),
                    torch.from_numpy(rms))
        want = np.asarray(jst.decibels)
        got = tst.decibels.numpy()
        vis = want > -120.0
        np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tst.last_silent.numpy(),
                                      np.asarray(jst.last_silent))
    if smoothing == TSmoothingMode.NONE:
        # the last frame's dB is the plain f32 FFT of the windowed frame
        assert tcfg.slope == 0.0
        mag = torch.fft.rfft(torch.from_numpy(x[:3]) * torch.from_numpy(w32))
        want = tspec.dbfs(tspec._mag_tail(tcfg, mag.abs()[..., :N // 2], None))
        assert torch.equal(tst.decibels[:3], want)


def test_matmul_backend_raises_and_unknown_backend_refused(monkeypatch):
    """``matmul`` is ported: it resolves, and its step's decibels are the
    GEMM FFT's (``kernels/matfft.rfft_mag``) of the f32-windowed frame, bit
    for bit (``tests/test_torch_matfft.py`` holds it against JAX); an
    unknown backend is still refused."""
    _, tcfg = _cfgs(channel_mode=ChannelMode.STEREO,
                    temporal_smoothing=TSmoothingMode.NONE)
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "matmul")
    assert tspec.resolve_fft_backend() == "matmul"
    step = tspec.make_spectrum_step(tcfg, device="cpu")
    x = (0.3 * np.random.default_rng(2).standard_normal((S, 2, N))
         ).astype(np.float32)
    st = step(torch.from_numpy(x), tspec.init_state(tcfg, S, device="cpu"),
              1 / 60, torch.ones(S, dtype=torch.bool), torch.zeros(S))
    w32 = torch.from_numpy(window_coefficients(tcfg.window, N,
                                               tcfg.sine_exponent,
                                               dtype=np.float32))
    mag = matfft.rfft_mag(torch.from_numpy(x) * w32, N // 2)
    assert torch.equal(st.decibels, tspec.dbfs(tspec._mag_tail(tcfg, mag,
                                                                None)))
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "fftw")
    with pytest.raises(ValueError, match="fftw"):
        tspec.make_spectrum_step(tcfg, device="cpu")
    for value in ("auto", "exact"):
        monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", value)
        assert tspec.resolve_fft_backend() == "exact"
    monkeypatch.delenv("WAVEFORM_TPU_FFT_BACKEND")
    assert tspec.resolve_fft_backend() == "exact"


@pytest.mark.parametrize("backend", ["exact", "matmul", "xla"])
def test_rfft_fn_overrides_every_backend(backend, monkeypatch):
    """A caller's ``rfft_fn`` takes the f32-windowed frame under every
    backend (no exact kernel runs under it), bins past N/2 dropped, as
    the JAX step with ``jnp.fft.rfft``: against the float64 spectrum, the
    port's magnitude error (relative to its row's peak) at most twice the
    JAX step's, and the two steps within that bound of each other; bit
    for bit the port's own xla step."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", backend)
    jcfg, tcfg = _cfgs(channel_mode=ChannelMode.STEREO,
                       temporal_smoothing=TSmoothingMode.NONE)
    seen = []

    def rfft_fn(x):
        seen.append(tuple(x.shape))
        return torch.fft.rfft(x)

    step = tspec.make_spectrum_step(tcfg, rfft_fn, device="cpu")
    jstep = jspec.make_spectrum_step(jcfg, rfft_fn=jnp.fft.rfft)
    x = (0.3 * np.random.default_rng(3).standard_normal((S, 2, N))
         ).astype(np.float32)
    ones, rms = np.ones(S, bool), np.zeros(S, np.float32)
    st = step(torch.from_numpy(x), tspec.init_state(tcfg, S, device="cpu"),
              1 / 60, torch.from_numpy(ones), torch.from_numpy(rms))
    jst = jstep(jnp.asarray(x), jspec.init_state(jcfg, S),
                jnp.float32(1 / 60), jnp.asarray(ones), jnp.asarray(rms))
    assert seen == [(S, 2, N)]
    # two f32 FFT libraries, each off the float64 spectrum by ~1e-7 of its
    # row's peak (in dB that error grows without bound toward a null):
    # the port within twice the JAX step's error of it and of the JAX step
    w64 = window_coefficients(tcfg.window, N, tcfg.sine_exponent,
                              dtype=np.float64)
    want = (np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :N // 2]
            * 2.0 / w64.sum())
    peak = want.max(axis=-1, keepdims=True)
    got, jgot = (10.0 ** (np.asarray(d, np.float64) / 20.0)
                 for d in (st.decibels.numpy(), jst.decibels))
    e_jax = (np.abs(jgot - want) / peak).max()
    assert e_jax < 1e-6
    assert (np.abs(got - want) / peak).max() <= 2 * e_jax
    assert (np.abs(got - jgot) / peak).max() <= 2 * e_jax
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
    xla = tspec.make_spectrum_step(tcfg, device="cpu")(
        torch.from_numpy(x), tspec.init_state(tcfg, S, device="cpu"),
        1 / 60, torch.from_numpy(ones), torch.from_numpy(rms))
    assert torch.equal(st.decibels, xla.decibels)


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_rebin_reads_the_variable(mode, monkeypatch):
    """ROADMAP C2: with ``dense=None`` WAVEFORM_TPU_REBIN picks the interp
    form, as in the JAX package: the result is the forced form's, bit for
    bit, and within the rebin tests' bound of the JAX rebin under the same
    variable; the dense form refuses a reduced-precision matmul even on the
    CPU, where the port's own default is the gather."""
    monkeypatch.setenv("WAVEFORM_TPU_REBIN", mode)
    jcfg, tcfg = _cfgs(fft_size=2048, width=300)
    db = np.random.default_rng(1).uniform(
        -65.0, 0.0, (3, 2, tcfg.num_bins)).astype(np.float32)
    got = tapply.make_rebin_fn(tcfg, device="cpu")(torch.from_numpy(db))
    forced = tapply.make_rebin_fn(tcfg, device="cpu", dense=mode == "dense")
    assert torch.equal(got, forced(torch.from_numpy(db)))
    want = np.asarray(japply.make_rebin_fn(jcfg)(jnp.asarray(db)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=1e-5)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        if mode == "dense":
            with pytest.raises(RuntimeError, match="full-f32"):
                tapply.make_rebin_fn(tcfg, device="cpu")
        else:
            tapply.make_rebin_fn(tcfg, device="cpu")
    finally:
        torch.set_float32_matmul_precision(before)
