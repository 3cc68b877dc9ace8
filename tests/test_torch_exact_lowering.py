"""The port's exact digit lowering and the |rFFT| routing around K3.

The lowering (``exactfft.cfft_lowering``, the JAX package's XLA path in
plain torch ops) is held against ``waveform_tpu.kernels.exactfft`` with
``WAVEFORM_TPU_EXACT_KERNEL=never`` by tolerance, atol = 2e-7·max|ref|
(tests/test_exact_pallas.py:35-53): the JAX bf16 path chunks its class
stacks where the port sums each class at once, so the two round in
different places.  Against float64 numpy the bound is max|Δ|/max|ref| <=
2.5e-7 (tests/test_exactfft.py:237-251).  ``rfft_mag_exact`` is held to
the JAX one with its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu.kernels import exactfft as jex
from waveform_tpu.kernels import matfft as jmf
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels import exactfft as tex

TOL = 2.5e-7
ATOL = 2e-7


def _c128(z):
    def val(p):
        return np.asarray(p[0], np.float64) + np.asarray(p[1], np.float64)
    return val(z[0]) + 1j * val(z[1])


def _hann(n):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return w64, hi, lo


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _f64_mag(x, w64):
    n = x.shape[-1]
    return np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]


@pytest.fixture
def fused_never(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")


@pytest.fixture
def fused_unset(monkeypatch):
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)


@pytest.mark.parametrize("block", ["random", "zero", "nan", "huge"])
def test_pow2_scale_matches_jax(block):
    """Per batch element over the last two axes, from frexp: the JAX rule
    on random, zero, NaN and 1e30 blocks.  The JAX rule turns
    the exponent into a scale with ``jnp.exp2``, which on the CPU is exact
    for only 33 of the 251 exponents (off by up to 4.1e-6 relative); the
    port builds the power of two from its bits, so it is held to the power
    the JAX rule names, and to the JAX value within that error."""
    rng = np.random.default_rng(3)
    hi = (rng.standard_normal((3, 2, 8, 16))
          * 10.0 ** rng.uniform(-6, 6, (3, 2, 1, 1))).astype(np.float32)
    if block == "zero":
        hi[1] = 0.0
    elif block == "nan":
        hi[2, 1, 3, 5] = np.nan
    elif block == "huge":
        hi[1, 0] = 1e30
    got = tex._pow2_scale_block(torch.from_numpy(hi)).numpy()
    want = np.asarray(jex._pow2_scale(jnp.asarray(hi)))
    assert got.shape == want.shape == (3, 2, 1, 1)
    np.testing.assert_array_equal(got, 2.0 ** np.rint(np.log2(want)))
    np.testing.assert_allclose(got, want, rtol=5e-6)
    assert (np.frexp(got)[0] == 0.5).all()


def test_plan_builders_match_jax():
    for n in (128, 336, 800, 1040, 4112, 16496, 65536):
        assert tex._split_factors(n) == jmf._split_factors(n), n
    a = np.random.default_rng(4).uniform(-1, 1, (12, 20))
    np.testing.assert_array_equal(tex._digit_planes(a),
                                  jex._slice_const(a).astype(np.float32))
    f64 = np.random.default_rng(5).standard_normal(50)
    for got, want in zip(tex.split_f64_df32(f64), jex.split_f64_df32(f64)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [800, 4096])
def test_exact_plan_matches_jax(n):
    """The folded stage 2 (and its digit planes) equal the JAX plan's."""
    port, ref = tex._exact_plan(n), jex._exact_plan(n)
    assert port[:2] == ref[:2] and port[3][0] == ref[3][0] == "folded"
    np.testing.assert_array_equal(port[2], ref[2])
    np.testing.assert_array_equal(port[3][1], ref[3][1])


@pytest.mark.parametrize("n", [256, 800, 4096])
def test_lowering_matches_jax_lowering(n, monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "never")
    rng = np.random.default_rng(200 + n)
    xr = (0.4 * rng.standard_normal((2, n))).astype(np.float32)
    xi = (0.4 * rng.standard_normal((2, n))).astype(np.float32)
    got = _c128(tex.cfft_lowering(torch.from_numpy(xr), torch.from_numpy(xi)))
    want = _c128(jex.cfft_exact(jnp.asarray(xr), jnp.asarray(xi)))
    scale = np.abs(want).max()
    for a, b in ((got.real, want.real), (got.imag, want.imag)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("n", [800, 4112, 16496, 65536])
def test_lowering_matches_f64(n):
    """Folded stage 2 (800, 4112 = 16 x 257) and the df32-twiddle form
    (16496 = 16 x 1031, 65536 = 256 x 256), with a df32 windowed input."""
    rng = np.random.default_rng(300 + n)
    x = (0.5 * rng.standard_normal((2, n))).astype(np.float32)
    w64, w_hi, w_lo = _hann(n)
    w = (torch.from_numpy(w_hi), torch.from_numpy(w_lo))
    re = tex._windowed_df(torch.from_numpy(x[0]), *w)
    z = _c128(tex.cfft_lowering(re, torch.from_numpy(x[1])))
    want = np.fft.fft(x[0].astype(np.float64) * w64
                      + 1j * x[1].astype(np.float64))
    assert _rel(z.real, want.real) <= TOL and _rel(z.imag, want.imag) <= TOL


def test_lowering_isolates_corrupt_streams():
    """One scale per batch element: a 1e20 stream and a NaN stream leave
    their batchmates at full accuracy."""
    n = 800
    rng = np.random.default_rng(6)
    xr = (0.5 * rng.standard_normal((4, n))).astype(np.float32)
    xi = (0.5 * rng.standard_normal((4, n))).astype(np.float32)
    xr[1] = 1e20 * rng.standard_normal(n)
    xi[2, 3] = np.nan
    got = _c128(tex.cfft_lowering(torch.from_numpy(xr), torch.from_numpy(xi)))
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    for s in (0, 3):
        assert _rel(got[s], want[s]) <= TOL
    assert np.isfinite(got[1]).all()


def test_cfft_exact_routes_by_size(fused_unset):
    """K3 (here its twin) wherever ``supports_cfft``, the lowering at every
    other size, whatever the FUSED gate says."""
    rng = np.random.default_rng(8)
    for n, k3 in ((1024, True), (32768, True), (800, False), (65536, False)):
        x = [torch.from_numpy((0.5 * rng.standard_normal((1, n)))
                              .astype(np.float32)) for _ in range(2)]
        got = tex.cfft_exact(*x)
        want = (exact_cuda.cfft_exact_ref(*x) if k3
                else tex.cfft_lowering(*x))
        for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
            assert torch.equal(a, b), n


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_rfft_mag_exact_fused_never_matches_jax(channels, fused_never,
                                                monkeypatch):
    """Under ``WAVEFORM_TPU_EXACT_FUSED=never`` pairs take the packed pair
    through K3 and a lone channel the real part of one K3 transform, as
    the JAX package routes them (its K3 in interpret mode)."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    n = 1024
    rng = np.random.default_rng(400 + channels)
    x = (0.5 * rng.standard_normal((3, channels, n))).astype(np.float32)
    x[0] = 0.0                   # a silent stream
    x[1, -1, :50] = 0.0
    w64, w_hi, w_lo = _hann(n)
    before = (exact_cuda.launches3, exact_cuda.launches_cfft)
    mag, nz = tex.rfft_mag_exact(
        torch.from_numpy(x), (torch.from_numpy(w_hi), torch.from_numpy(w_lo)))
    mag_j, nz_j = jex.rfft_mag_exact(
        jnp.asarray(x), window=(jnp.asarray(w_hi), jnp.asarray(w_lo)),
        with_nz=True)
    assert mag.shape == (3, channels, n // 2)
    assert _rel(mag.numpy(), np.asarray(mag_j, np.float64)) <= TOL
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    assert (mag.numpy()[0] == 0).all()
    np.testing.assert_array_equal(nz.numpy(), np.asarray(nz_j))
    np.testing.assert_array_equal(nz.numpy(), np.any(x != 0, axis=-1))
    assert (exact_cuda.launches3, exact_cuda.launches_cfft) == before


@pytest.mark.parametrize("n", [128, 512, 800, 1040, 4112, 16496])
def test_rfft_mag_exact_outside_kernel_geometry(n, fused_unset):
    """Sizes outside the pair kernels' geometry (the slider's 128-8192 in
    steps of 64, the 16-aligned sizes resolve keeps, the auto FFT size
    800) take the packed pair through the lowering."""
    assert not exact_cuda.supports(n)
    rng = np.random.default_rng(500 + n)
    x = (0.5 * rng.standard_normal((2, 2, n))).astype(np.float32)
    x[1, 1] = 0.0
    w64, w_hi, w_lo = _hann(n)
    mag, nz = tex.rfft_mag_exact(
        torch.from_numpy(x), (torch.from_numpy(w_hi), torch.from_numpy(w_lo)))
    assert mag.shape == (2, 2, n // 2)
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    np.testing.assert_array_equal(nz.numpy(), np.any(x != 0, axis=-1))


@pytest.mark.parametrize("n", [1024, 3072, 65536])
def test_rfft_mag_exact_fused_never_sizes(n, fused_never):
    """Under the ablation K3 serves 1024 and 3072 (3072 raises with the
    gate off: the port's K1 lacks it), the lowering 65536; stereo and a
    mono stream, no window."""
    rng = np.random.default_rng(600 + n)
    for channels in (2, 1):
        x = (0.5 * rng.standard_normal((1, channels, n))).astype(np.float32)
        mag, nz = tex.rfft_mag_exact(torch.from_numpy(x))
        assert _rel(mag.numpy(), _f64_mag(x, np.ones(n))) <= TOL
        assert nz.numpy().all()


def test_packed_pair_keeps_garbage_finite(fused_never):
    """A 1e20 channel gives huge but finite magnitudes through the packed
    unpack (the ±2^63 clamp before squaring), and its stream-mate keeps
    its exact spectrum: 0.5 at every bin for an impulse of 0.5."""
    x = np.zeros((2, 2, 1024), np.float32)
    x[0, 0, 10] = 1e20
    x[0, 1, 3] = -5e19
    x[1, 0, 5] = 0.5
    mag, _ = tex.rfft_mag_exact(torch.from_numpy(x))
    m = mag.numpy()
    assert np.isfinite(m).all() and m[0].max() > 1e18
    np.testing.assert_allclose(m[1, 0], 0.5, atol=1e-5)
