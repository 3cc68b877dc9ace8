"""Exact |rFFT| of the PyTorch port against the JAX package.

The port's plain twin (what a CPU tensor runs) is held against the Pallas
kernel in interpret mode and against float64 numpy, at the kernel's own
bound: max|Δ| / max|ref| <= 2.5e-7 (tests/test_exact_pallas.py).  Silence
counts must be exact.  The CUDA kernel itself is checked against the twin
by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu.kernels import exact_pallas as jep
from waveform_tpu.kernels import exactfft as jex
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels import exactfft as tex

TOL = 2.5e-7


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _hann(n):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return w64, hi, lo


def _windows(n, windowed):
    """(float64 window, port window pair, JAX window pair)."""
    if not windowed:
        return np.ones(n), None, None
    w64, hi, lo = _hann(n)
    return (w64, (torch.from_numpy(hi), torch.from_numpy(lo)),
            (jnp.asarray(hi), jnp.asarray(lo)))


def _f64_mag(x, w64):
    n = x.shape[-1]
    return np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]


@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_plan_constants_match_jax(n):
    """Digit planes and twiddles equal the JAX plan builder's, exactly
    (the JAX plan stacks classes and tiles per stream block; bs=1 leaves
    the tiles as the [n1, 128] base)."""
    port = exact_cuda._kernel_plan_real(n)
    ref = jep._kernel_plan_real(n, 1)
    assert port[:2] == ref[:2]
    z = np.zeros_like(port[2][0])
    f1bd = np.stack([np.block([[p, z], [z, p]]) for p in port[2]])
    np.testing.assert_array_equal(ref[2], jep._stacked_classes(f1bd, axis=1))
    np.testing.assert_array_equal(ref[3], jep._stacked_classes(port[3],
                                                               axis=0))
    for got, want in zip(port[4:], ref[4:]):
        np.testing.assert_array_equal(got, want)


def test_plan_builders_match_jax():
    rng = np.random.default_rng(11)
    a = rng.uniform(-1, 1, (16, 24))
    np.testing.assert_array_equal(exact_cuda._digit_planes(a),
                                  jep._digit_planes(a))
    f = (rng.standard_normal(64) * 10).astype(np.float32)
    np.testing.assert_array_equal(exact_cuda._vsplit_host(f),
                                  jep._vsplit_host(f))


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", [1024, 4096])
def test_twin_matches_jax_kernel_and_f64(n, windowed):
    rng = np.random.default_rng(1000 + n + windowed)
    x = (0.5 * rng.standard_normal((4, 2, n))).astype(np.float32)
    t = np.arange(n) / 48000.0
    x[0, 0] += np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    x[1, 1] = 0.0            # a silent channel
    x[3] = 0.0               # a silent stream
    x[2, 0, ::3] = 0.0       # scattered zero samples count as silence
    w64, wt, wj = _windows(n, windowed)
    mag, nz = exact_cuda.rfft_pair_mag(torch.from_numpy(x), wt)
    mag_j, nz_j = jep.rfft_pair_mag_kernel(jnp.asarray(x), window=wj,
                                           interpret=True)
    want = _f64_mag(x, w64)
    assert mag.shape == (4, 2, n // 2) and mag.dtype == torch.float32
    assert _rel(mag.numpy(), np.asarray(mag_j, np.float64)) <= TOL
    assert _rel(mag.numpy(), want) <= TOL
    assert (mag.numpy()[3] == 0).all() and (mag.numpy()[1, 1] == 0).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))
    np.testing.assert_array_equal(nz.numpy() > 0, np.asarray(nz_j))


def test_corrupt_streams_isolated():
    """A 1e20 stream and a NaN stream degrade only themselves: per-lane
    pow2 scales keep their neighbours at full accuracy, and the 1e20
    stream stays finite (the pre-square clamp)."""
    n = 1024
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((5, 2, n))).astype(np.float32)
    x[1] = (1e20 * rng.standard_normal((2, n))).astype(np.float32)
    x[3, 0, 7] = np.nan
    w64, wt, wj = _windows(n, True)
    mag, nz = exact_cuda.rfft_pair_mag(torch.from_numpy(x), wt)
    mag_j, _ = jep.rfft_pair_mag_kernel(jnp.asarray(x), window=wj,
                                        interpret=True)
    got = mag.numpy()
    want = _f64_mag(x, w64)
    for s in (0, 2, 4):
        assert _rel(got[s], want[s]) <= TOL, s
        assert _rel(got[s], np.asarray(mag_j[s], np.float64)) <= TOL, s
    assert np.isfinite(got[1]).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))


@pytest.mark.parametrize("streams,channels", [(3, 1), (1, 1), (2, 3)])
def test_lone_channels_pair_streams(streams, channels, monkeypatch):
    """Mono (and the odd channel of an odd count) rides the pair kernel by
    pairing streams, an odd stream count padded by one zero row — as the
    JAX rfft_mag_exact routes it."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    n = 1024
    rng = np.random.default_rng(streams * 10 + channels)
    x = (0.5 * rng.standard_normal((streams, channels, n))).astype(np.float32)
    x[-1, -1, :100] = 0.0
    w64, wt, wj = _windows(n, True)
    mag, nz = tex.rfft_mag_exact(torch.from_numpy(x), wt)
    mag_j, nz_j = jex.rfft_mag_exact(jnp.asarray(x), window=wj, with_nz=True)
    assert mag.shape == (streams, channels, n // 2)
    assert _rel(mag.numpy(), np.asarray(mag_j, np.float64)) <= TOL
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    np.testing.assert_array_equal(nz.numpy(), np.asarray(nz_j))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 2, 1024))
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag(x.double())
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag(torch.zeros((2, 3, 1024)))
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag(x, (torch.ones(512), torch.zeros(512)))
    with pytest.raises(NotImplementedError):       # N % 128 != 0
        exact_cuda.rfft_pair_mag(torch.zeros((2, 2, 1040)))
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag(x.to("meta"))


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    before = (exact_cuda.launches_gen, exact_cuda.launches_gen_df)
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 2, 2048))
        .astype(np.float32))
    mag, nz = exact_cuda.rfft_pair_mag(x)
    ref, nz_ref = exact_cuda.rfft_pair_mag_ref(x)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
    assert (exact_cuda.launches_gen, exact_cuda.launches_gen_df) == before


@pytest.mark.parametrize("tier", ["f32", "df"])
@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_k1_sizes_route_to_k1_gen(n, tier, monkeypatch):
    """N1 in {8, 16, 32} (N = 1024, 2048, 4096) reach ``rfft_pair_mag_gen``
    at both twiddle tiers: K1-gen (or K1-df) is the only kernel of K1's
    body."""
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", tier)
    calls = []
    gen = exact_cuda.rfft_pair_mag_gen

    def record(x, window=None, twiddle=None):
        calls.append((x.shape[-1], twiddle))
        return gen(x, window, twiddle)

    monkeypatch.setattr(exact_cuda, "rfft_pair_mag_gen", record)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (1, 2, n)).astype(np.float32))
    mag, nz = exact_cuda.rfft_pair_mag(x)
    assert calls == [(n, tier)]
    twin = (exact_cuda.rfft_pair_mag_df_ref if tier == "df"
            else exact_cuda.rfft_pair_mag_ref)
    ref, nz_ref = twin(x)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)


def test_df32_primitives_are_error_free():
    """TwoSum/TwoProd are exact and the df ops carry ~2^-44 relative error,
    checked in float64 — the arithmetic the kernel's window product needs."""
    rng = np.random.default_rng(12)
    a64 = rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)
    b64 = rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)
    a = torch.from_numpy(a64.astype(np.float32))
    b = torch.from_numpy(b64.astype(np.float32))
    A, B = a.double().numpy(), b.double().numpy()
    s, e = tex.two_sum(a, b)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), A + B)
    p, e = tex.two_prod(a, b)
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(), A * B)

    def df(x64):
        hi = x64.astype(np.float32)
        lo = (x64 - hi.astype(np.float64)).astype(np.float32)
        return (torch.from_numpy(hi), torch.from_numpy(lo)), \
            hi.astype(np.float64) + lo.astype(np.float64)

    (x, X), (y, Y) = df(a64), df(b64)

    def val(z):
        return z[0].double().numpy() + z[1].double().numpy()

    bound = 2.0 ** -44
    np.testing.assert_allclose(val(tex.df_mul(x, y)), X * Y, rtol=bound)
    summed = val(tex.df_add(x, tex.df_neg(y)))
    assert (np.abs(summed - (X - Y))
            <= bound * (np.abs(X) + np.abs(Y))).all()
