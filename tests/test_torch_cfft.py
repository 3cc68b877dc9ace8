"""K3, the complex exact FFT of the PyTorch port, against the JAX package.

The port's plain twin of K3 (what a CPU tensor runs) is held against the
Pallas ``_kernel`` in interpret mode with atol = 2e-7·max|ref|
(tests/test_exact_pallas.py:35-53) and against float64 numpy within
max|Δ|/max|ref| <= 2.5e-7 (tests/test_exact_pallas.py:21-32).  The CUDA
kernel itself is checked against the twin by tests/test_torch_cuda.py and
chip_smoke.py on the card.  The routing predicates are held equal to the
JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu.kernels import exact_pallas as jep
from waveform_tpu.kernels import exactfft as jex
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels import exactfft as tex

from test_torch_exact_mag3 import _unpack_b2
from test_torch_exact_mag_gen import _unpack_a1

TOL = 2.5e-7
ATOL = 2e-7


def _c128(z):
    """((re_hi, re_lo), (im_hi, im_lo)) of torch or JAX arrays -> complex."""
    def val(p):
        return np.asarray(p[0], np.float64) + np.asarray(p[1], np.float64)
    return val(z[0]) + 1j * val(z[1])


def _inputs(n, S, df, seed):
    """Seeded (x_r, x_i) [S, n] and the same as port and JAX operands: f32
    tensors, or Hann-windowed df32 pairs (the packed pair's input)."""
    rng = np.random.default_rng(seed)
    xr = (0.4 * rng.standard_normal((S, n))).astype(np.float32)
    xi = (0.4 * rng.standard_normal((S, n))).astype(np.float32)
    if not df:
        return (xr, xi, np.ones(n),
                (torch.from_numpy(xr), torch.from_numpy(xi)),
                (jnp.asarray(xr), jnp.asarray(xi)))
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    w_hi = w64.astype(np.float32)
    w_lo = (w64 - w_hi.astype(np.float64)).astype(np.float32)
    port = tuple(tex._windowed_df(torch.from_numpy(a), torch.from_numpy(w_hi),
                                  torch.from_numpy(w_lo)) for a in (xr, xi))
    ref = tuple(jex._windowed_df(jnp.asarray(a), jnp.asarray(w_hi),
                                 jnp.asarray(w_lo)) for a in (xr, xi))
    return xr, xi, w64, port, ref


def _f64(xr, xi, w64):
    return np.fft.fft((xr.astype(np.float64) + 1j * xi.astype(np.float64))
                      * w64)


@pytest.mark.parametrize("n", [1024, 3072, 32768])
def test_plan_constants_match_jax(n):
    """Digit planes and twiddles equal ``exact_pallas._kernel_plan(n, 1)``
    once the port's planes are class-stacked as the JAX plan stacks them."""
    port = exact_cuda._kernel_plan_cfft(n)
    ref = jep._kernel_plan(n, 1)
    assert port[:2] == ref[:2]
    np.testing.assert_array_equal(ref[2],
                                  jep._stacked_classes(port[2], axis=1))
    np.testing.assert_array_equal(ref[3],
                                  jep._stacked_classes(port[3], axis=0))
    for got, want in zip(port[4:], ref[4:]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1024, 3072, 4096, 32768])
def test_packed_words_hold_the_planes(n):
    """The int8x4 words the kernel reads unpack to the digit planes: ``f1f``
    to F1b (A fragments, the 2·N1-deep contraction zero-padded to k-steps
    of 32: N1 = 8 one half-empty k-step, 24 two, 32 two, 256 sixteen),
    ``f2b`` to all 256 columns of F2b (B fragments, 32 N tiles)."""
    n1, _, f1d, f2d, *tw = exact_cuda._kernel_plan_cfft(n)
    c = exact_cuda._consts_cfft(n, torch.device("cpu"))
    frag = c["f1f"].numpy()
    assert frag.dtype == np.int32 and frag.shape == (
        4, n1 // 8, -(-2 * n1 // 32), 32, 4)
    np.testing.assert_array_equal(_unpack_a1(frag, 2 * n1), f1d)
    assert c["f2b"].shape == (4, 8, 32, 32, 2)
    np.testing.assert_array_equal(_unpack_b2(c["f2b"].numpy()), f2d)
    np.testing.assert_array_equal(c["tw"].numpy(), np.stack(tw))
    assert np.abs(f1d).max() <= 64 and np.abs(f2d).max() <= 64


@pytest.mark.parametrize("df", [False, True])
@pytest.mark.parametrize("n", [1024, 3072])
def test_twin_matches_jax_kernel_and_f64(n, df):
    xr, xi, w64, port, ref = _inputs(n, 3, df, 100 + n + df)
    got = _c128(exact_cuda.cfft_exact_kernel(*port))
    want_j = _c128(jep.cfft_exact_kernel(*ref, interpret=True))
    want = _f64(xr, xi, w64)
    scale = np.abs(want_j).max()
    for a, b in ((got.real, want_j.real), (got.imag, want_j.imag)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * scale)
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL


def test_twin_keeps_leading_axes():
    """[..., N] in, [..., N] out: two leading axes flatten to streams and
    come back, each stream the same as alone."""
    _, _, _, port, _ = _inputs(1024, 6, True, 7)
    z = exact_cuda.cfft_exact_kernel(
        *(tuple(a.reshape(2, 3, 1024) for a in p) for p in port))
    assert z[0][0].shape == (2, 3, 1024)
    alone = exact_cuda.cfft_exact_kernel(
        tuple(a[4:5] for a in port[0]), tuple(a[4:5] for a in port[1]))
    for got, want in zip((*z[0], *z[1]), (*alone[0], *alone[1])):
        assert torch.equal(got.reshape(6, 1024)[4:5], want)


def test_corrupt_streams_isolated():
    """A 1e20 stream and a NaN stream degrade only themselves: per-lane
    scales keep their neighbours at full accuracy, and the 1e20 stream
    stays finite."""
    n = 2048
    rng = np.random.default_rng(5)
    xr = (0.5 * rng.standard_normal((5, n))).astype(np.float32)
    xi = (0.5 * rng.standard_normal((5, n))).astype(np.float32)
    xr[1] = 1e20 * rng.standard_normal(n)
    xi[3, 7] = np.nan
    got = _c128(exact_cuda.cfft_exact_kernel(torch.from_numpy(xr),
                                             torch.from_numpy(xi)))
    want = _f64(xr, xi, np.ones(n))
    for s in (0, 2, 4):
        assert np.abs(got[s] - want[s]).max() / np.abs(want[s]).max() <= TOL
    assert np.isfinite(got[1]).all()
    assert np.isnan(got[3]).any()


def test_silent_stream_is_exactly_zero():
    z = exact_cuda.cfft_exact_kernel(torch.zeros((2, 1024)),
                                     torch.zeros((2, 1024)))
    for a in (*z[0], *z[1]):
        assert (a == 0).all()


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    before = exact_cuda.launches_cfft
    _, _, _, port, _ = _inputs(2048, 2, True, 3)
    z = exact_cuda.cfft_exact_kernel(*port)
    ref = exact_cuda.cfft_exact_ref(*port)
    for got, want in zip((*z[0], *z[1]), (*ref[0], *ref[1])):
        assert torch.equal(got, want)
    assert exact_cuda.launches_cfft == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 1024))
    with pytest.raises(NotImplementedError):       # N % 128 != 0
        exact_cuda.cfft_exact_kernel(torch.zeros((2, 1040)),
                                     torch.zeros((2, 1040)))
    with pytest.raises(NotImplementedError):       # above 32768
        exact_cuda.cfft_exact_kernel(torch.zeros((1, 65536)),
                                     torch.zeros((1, 65536)))
    with pytest.raises(ValueError):
        exact_cuda.cfft_exact_kernel(x.double(), x.double())
    with pytest.raises(ValueError):
        exact_cuda.cfft_exact_kernel(x, torch.zeros((3, 1024)))
    with pytest.raises(ValueError):
        exact_cuda.cfft_exact_kernel(x.to("meta"), x.to("meta"))


def test_predicates_match_jax(monkeypatch):
    """``supports`` and ``supports_cfft`` equal the JAX package's at every
    reference-legal size (multiples of 16, 128-65536)."""
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    for n in range(128, 65537, 16):
        assert exact_cuda.supports(n) == jep.supports(n), n
        assert exact_cuda.supports_cfft(n) == jep.supports_cfft(n), n


def test_kernel_would_run_honours_fused_gate(monkeypatch):
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
    assert exact_cuda.kernel_would_run(4096)
    assert not exact_cuda.kernel_would_run(800)
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")
    assert not exact_cuda.kernel_would_run(4096)
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "auto")
    assert exact_cuda.kernel_would_run(65536)


def test_sizes_without_pair_kernel_geometry_raise(monkeypatch):
    """The pair kernel raises exactly at the sizes the JAX package's
    ``supports`` refuses; every size it admits has a kernel in the port
    (the 22 that K1-gen added among them, 3072 to 31744), and the router
    sends the others to the packed pair."""
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    admitted = [n for n in range(128, 65537, 16) if jep.supports(n)]
    assert len(admitted) == 40 and admitted[0] == 1024
    gen = [n for n in admitted
           if exact_cuda.stage1_split(n) == 2 and n not in (1024, 2048, 4096)]
    assert len(gen) == 28 and gen[0] == 3072 and gen[-1] == 31744
    for n in (128, 1040, 3080, 65536 + 128):
        assert not jep.supports(n)
        with pytest.raises(NotImplementedError):
            exact_cuda.rfft_pair_mag(torch.zeros((1, 2, n)))
    mag, nz = tex.rfft_mag_exact(torch.zeros((1, 2, 3072)))
    assert mag.shape == (1, 2, 1536) and not mag.any() and not nz.any()
