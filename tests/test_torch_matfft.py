"""The port's GEMM FFT (``kernels/matfft.py``, the ``matmul`` backend)
against the JAX package's.

The same numpy-seeded inputs go through both packages' functions (JAX's
jitted, as ``tests/test_matfft.py`` runs them).  Each port function holds
the JAX test's bound against float64 numpy (``test_matfft.py:26``, ``:43``,
``:63``), and the port against JAX holds within twice that bound (both are
plain f32 products, accumulated in different orders).  The spectrum step
under ``WAVEFORM_TPU_FFT_BACKEND=matmul`` is held against the JAX step
under the same variable, and its dB error against the float64 spectrum
may be at most twice the JAX step's on the same frames.
"""

import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_tpu import AudioInfo, ChannelMode, Settings, TSmoothingMode, resolve
from waveform_tpu.dsp import spectrum as jspec
from waveform_tpu.kernels import matfft as jmat
import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp import spectrum as tspec
from waveform_tpu_torch.dsp.windows import window_coefficients, window_sum
from waveform_tpu_torch.kernels import matfft


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n", [64, 128, 720, 992, 1024, 4096])
def test_cfft_matches_jax_and_numpy(n, precise):
    rng = np.random.default_rng(n + precise)
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = rng.standard_normal((3, n)).astype(np.float32)
    tol = 3e-4 * np.sqrt(n / 64)                 # test_matfft.py:26
    zr, zi = matfft.cfft(_t(xr), _t(xi), precise=precise)
    got = zr.numpy() + 1j * zi.numpy()
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    assert np.abs(got - want).max() < tol
    jr, ji = jax.jit(jmat.cfft, static_argnums=2)(jnp.asarray(xr),
                                                  jnp.asarray(xi), precise)
    assert np.abs(got - (np.asarray(jr) + 1j * np.asarray(ji))).max() < 2 * tol


@pytest.mark.parametrize("n", [4096, 960, 65536, 720])
def test_split_factors_and_plan_match_jax(n):
    assert matfft._split_factors(n) == jmat._split_factors(n)
    if n <= 4096:
        for a, b in zip(jax.tree_util.tree_leaves(matfft._plan(n)),
                        jax.tree_util.tree_leaves(jmat._plan(n))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", [1024, 4096])
def test_pair_packing_matches_jax(n):
    """Two real channels through one complex FFT (the reverse-roll
    unpack) against per-channel float64 rffts and the JAX packing."""
    x = np.random.default_rng(n).standard_normal((5, 2, n)).astype(np.float32)
    mag = matfft.rfft_pair_mag(_t(x)).numpy()
    assert mag.shape == (5, 2, n // 2)
    want = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1))[..., :n // 2]
    np.testing.assert_allclose(mag, want, rtol=0, atol=2e-3)   # :43
    jm = np.asarray(jax.jit(jmat.rfft_pair_mag)(jnp.asarray(x)))
    np.testing.assert_allclose(mag, jm, rtol=0, atol=4e-3)
    part = matfft.rfft_pair_mag(_t(x), nbins=7).numpy()
    np.testing.assert_array_equal(part, mag[..., :7])


def test_rfft_real_matches_jax():
    n = 512
    x = np.random.default_rng(7).standard_normal((4, n)).astype(np.float32)
    re, im = matfft.rfft_real(_t(x))
    assert re.shape == (4, n // 2 + 1)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(re.numpy(), want.real, rtol=0, atol=2e-3)
    np.testing.assert_allclose(im.numpy(), want.imag, rtol=0, atol=2e-3)
    jre, jim = jax.jit(jmat.rfft_real)(jnp.asarray(x))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=0, atol=4e-3)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=0, atol=4e-3)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_rfft_mag_channel_counts(c):
    """Pairs through the packing, an odd last channel through the
    zero-imaginary transform."""
    n = 256
    x = np.random.default_rng(c).standard_normal((2, c, n)).astype(np.float32)
    mag = matfft.rfft_mag(_t(x)).numpy()
    want = np.abs(np.fft.rfft(x.astype(np.float64), axis=-1))[..., :n // 2]
    np.testing.assert_allclose(mag, want, rtol=0, atol=1e-3)   # :63
    jm = np.asarray(jax.jit(jmat.rfft_mag)(jnp.asarray(x)))
    np.testing.assert_allclose(mag, jm, rtol=0, atol=2e-3)


def test_refuses_reduced_matmul_precision():
    """TF32 or bf16 products would drop mantissa bits: refused, not
    switched off behind the caller's back."""
    x = torch.ones(2, 64)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="matmul FFT needs full-f32"):
            matfft.cfft(x, x)
    finally:
        torch.set_float32_matmul_precision(before)


def _cfgs(n, **kw):
    port_kw = {k: (getattr(wt, type(v).__name__)[v.name]
                   if isinstance(v, enum.Enum) else v) for k, v in kw.items()}
    return (resolve(Settings(fft_size=n, **kw), AudioInfo(48000, 2)),
            wt.resolve(wt.Settings(fft_size=n, **port_kw),
                       wt.AudioInfo(48000, 2)))


@pytest.mark.parametrize("n", [1024, 4096])
def test_matmul_step_matches_jax_and_oracle(n, monkeypatch):
    """The spectrum step under WAVEFORM_TPU_FFT_BACKEND=matmul, stereo, no
    smoothing: the port's decibels within twice the JAX step's error of
    the JAX step's, and the port's dB error against the float64 spectrum
    at most twice the JAX step's (visible bins above -120 dB); the
    silence latch equal; a silent stream at DB_MIN."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "matmul")
    jcfg, tcfg = _cfgs(n, channel_mode=ChannelMode.STEREO,
                       temporal_smoothing=TSmoothingMode.NONE)
    assert tspec.resolve_fft_backend() == "matmul"
    S = 4
    jstep = jspec.make_spectrum_step(jcfg)
    tstep = tspec.make_spectrum_step(tcfg, device="cpu")
    jst, tst = jspec.init_state(jcfg, S), tspec.init_state(tcfg, S,
                                                           device="cpu")
    rng = np.random.default_rng(n)
    w64 = window_coefficients(tcfg.window, n, tcfg.sine_exponent,
                              dtype=np.float64)
    coeff = 2.0 / window_sum(tcfg.window, n, tcfg.sine_exponent)
    ones, rms = np.ones(S, bool), np.zeros(S, np.float32)
    for k in range(3):
        t = (np.arange(n) + 800 * k) / 48000
        x = (0.3 * rng.standard_normal((S, 2, n))
             + 0.1 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
        x[3] = 0.0
        jst = jstep(jnp.asarray(x), jst, jnp.float32(1 / 60),
                    jnp.asarray(ones), jnp.asarray(rms))
        tst = tstep(_t(x), tst, 1 / 60, _t(ones), _t(rms))
        got, jgot = tst.decibels.numpy(), np.asarray(jst.decibels)
        mag = np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]
        with np.errstate(divide="ignore"):
            want = 20 * np.log10(mag * coeff)
        vis = want > -120.0
        e_port = np.abs(got[vis] - want[vis]).max()
        e_jax = np.abs(jgot[vis] - want[vis]).max()
        assert e_port <= 2 * e_jax, (e_port, e_jax)
        assert np.abs(got[vis] - jgot[vis]).max() <= 2 * e_jax
        assert (got[3] == np.float32(wt.DB_MIN)).all()
        np.testing.assert_array_equal(tst.last_silent.numpy(),
                                      np.asarray(jst.last_silent))
