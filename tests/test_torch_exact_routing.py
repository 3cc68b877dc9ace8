"""The port's exact-FFT routing switches against the JAX package's.

* ``WAVEFORM_TPU_EXACT_KERNEL=never`` (``exact_pallas.enabled``) sends
  every size to the digit lowering: no pair kernel, and ``cfft_exact``
  takes ``cfft_lowering`` even where K3 would serve the size.
* ``WAVEFORM_TPU_EXACT_PACKED=never`` (``exactfft._use_real_split_xla``)
  sends the streams the pair kernel does not serve to the real-split
  lowering (``_rfft_mag_real_xla``, ported as
  ``exactfft.rfft_mag_real_lowering``), pairs and lone channels alike;
  an odd N2 factor stays on the packed pair.

Each route is held to the JAX package under the same variables and to
float64 within max|Δ| / max|ref| <= 2.5e-7 (the kernel bound of
tests/test_exact_pallas.py).  The two lowerings scale per block with
frexp in the port and with ``jnp.exp2`` in JAX, so they are compared by
tolerance, not bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waveform_tpu.kernels import exactfft as jex
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels import exactfft as tex

TOL = 2.5e-7
GATES = ("WAVEFORM_TPU_EXACT_KERNEL", "WAVEFORM_TPU_EXACT_FUSED",
         "WAVEFORM_TPU_EXACT_PACKED", "WAVEFORM_TPU_STAGE1_SPLIT",
         "WAVEFORM_TPU_KERNEL_TWIDDLE", "WAVEFORM_TPU_EXACT_INTERPRET")


@pytest.fixture
def gates(monkeypatch):
    """Every routing variable unset; returns a setter."""
    for name in GATES:
        monkeypatch.delenv(name, raising=False)

    def set_(**kw):
        for name, value in kw.items():
            monkeypatch.setenv(f"WAVEFORM_TPU_{name}", value)
    return set_


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _hann(n):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return w64, hi, lo


def _input(n, channels, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((3, channels, n))).astype(np.float32)
    x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / 48000.0).astype(
        np.float32)
    x[-1] = 0.0
    x[1, -1, ::4] = 0.0
    return x


def _both(x, hi, lo):
    """(port mag, port nz), (JAX mag, JAX nz) of ``rfft_mag_exact`` under
    the variables as set.  The JAX side is traced anew on every call (a
    fresh function), so it reads the variables as set now; jit compiles
    the whole lowering at once, ~20x faster than op-by-op dispatch."""
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    mag, nz = tex.rfft_mag_exact(torch.from_numpy(x), win)
    mag_j, nz_j = jax.jit(lambda a, h, l: jex.rfft_mag_exact(
        a, window=(h, l), with_nz=True))(
            jnp.asarray(x), jnp.asarray(hi), jnp.asarray(lo))
    return (mag.numpy(), nz.numpy()), (np.asarray(mag_j, np.float64),
                                       np.asarray(nz_j))


def _launches():
    return (exact_cuda.launches3, exact_cuda.launches_cfft,
            exact_cuda.launches_gen, exact_cuda.launches_gen_df,
            exact_cuda.launches3_df)


@pytest.mark.parametrize("mode,on", [(None, True), ("auto", True),
                                     ("always", True), ("never", False)])
def test_enabled_reads_the_variable(mode, on, gates):
    if mode is not None:
        gates(EXACT_KERNEL=mode)
    assert exact_cuda.enabled() is on
    assert exact_cuda.kernel_would_run(4096) is on
    assert exact_cuda.kernel_would_run(65536) is on


@pytest.mark.parametrize("n", [1024, 3072, 4096])
def test_kernel_never_sends_cfft_to_the_lowering(n, gates):
    """K3 serves these sizes; under ``EXACT_KERNEL=never`` ``cfft_exact``
    takes the digit lowering instead (per-block scales: its bits differ
    from K3's per-lane ones)."""
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy((0.5 * rng.standard_normal((2, n)))
                               .astype(np.float32)) for _ in range(2))
    assert exact_cuda.supports_cfft(n)
    kernel = tex.cfft_exact(re, im)
    lowering = tex.cfft_lowering(re, im)
    for got, want in zip((*kernel[0], *kernel[1]),
                         (*exact_cuda.cfft_exact_ref(re, im)[0],
                          *exact_cuda.cfft_exact_ref(re, im)[1])):
        assert torch.equal(got, want)
    gates(EXACT_KERNEL="never")
    z = tex.cfft_exact(re, im)
    for got, want in zip((*z[0], *z[1]), (*lowering[0], *lowering[1])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,channels", [(800, 2), (4096, 2), (4096, 1)])
def test_kernel_never_matches_jax_and_f64(n, channels, gates):
    """``EXACT_KERNEL=never`` in both packages: the packed pair through
    the digit lowering, stereo and mono, no kernel launch counted."""
    gates(EXACT_KERNEL="never")
    x = _input(n, channels, 900 + n + channels)
    w64, hi, lo = _hann(n)
    before = _launches()
    (mag, nz), (mag_j, nz_j) = _both(x, hi, lo)
    assert _launches() == before
    want = np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]
    assert mag.shape == (3, channels, n // 2)
    assert _rel(mag, mag_j) <= TOL
    assert _rel(mag, want) <= TOL
    np.testing.assert_array_equal(nz, nz_j)
    np.testing.assert_array_equal(nz, np.count_nonzero(x, axis=-1) > 0)


@pytest.mark.parametrize("n,channels,gate", [
    (800, 2, None), (800, 1, None), (4096, 2, "KERNEL"), (4096, 1, "FUSED"),
    (4096, 3, "KERNEL")])
def test_packed_never_takes_the_real_split_lowering(n, channels, gate,
                                                    gates):
    """``EXACT_PACKED=never`` where the pair kernel does not run (N=800,
    which it does not serve, or N=4096 under ``EXACT_KERNEL=never`` or
    ``EXACT_FUSED=never``): every channel through the real-split lowering
    at once, as the JAX package routes, against the JAX result and
    float64."""
    gates(EXACT_PACKED="never")
    if gate is not None:
        gates(**{f"EXACT_{gate}": "never"})
    x = _input(n, channels, 950 + n + channels)
    w64, hi, lo = _hann(n)
    (mag, nz), (mag_j, nz_j) = _both(x, hi, lo)
    lowering = tex.rfft_mag_real_lowering(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    np.testing.assert_array_equal(mag, lowering.numpy())
    want = np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]
    assert _rel(mag, mag_j) <= TOL
    assert _rel(mag, want) <= TOL
    np.testing.assert_array_equal(nz, nz_j)
    np.testing.assert_array_equal(nz, np.count_nonzero(x, axis=-1) > 0)


def test_packed_never_leaves_the_pair_kernel_alone(gates):
    """The pair kernel, when it runs, wins over ``EXACT_PACKED=never``."""
    n = 4096
    x = torch.from_numpy(_input(n, 2, 990))
    want, _ = exact_cuda.rfft_pair_mag_ref(x)
    gates(EXACT_PACKED="never")
    mag, _ = tex.rfft_mag_exact(x)
    assert torch.equal(mag, want)


def test_packed_never_keeps_odd_n2_on_the_packed_pair(gates):
    """336 splits as 16 x 21: no kept-half column split, so the packed
    pair serves it under ``EXACT_PACKED=never`` too, bit for bit."""
    n = 336
    assert tex._split_factors(n)[1] % 2 == 1
    x = torch.from_numpy(_input(n, 2, 991))
    want, nz_want = tex.rfft_mag_exact(x)
    gates(EXACT_PACKED="never")
    assert not tex.use_real_split(n)
    mag, nz = tex.rfft_mag_exact(x)
    assert torch.equal(mag, want) and torch.equal(nz, nz_want)
    ref = np.abs(np.fft.rfft(x.numpy().astype(np.float64)))[..., :n // 2]
    assert _rel(mag.numpy(), ref) <= TOL


@pytest.mark.parametrize("n,form", [(800, "folded"), (65536, "twiddle")])
def test_real_split_lowering_matches_jax(n, form, gates):
    """Both stage-2 forms of the real-split plan (the twiddle folded into
    per-k1 constants while they fit, else a df32 twiddle), against
    ``_rfft_mag_real_xla`` and float64, windowed and not."""
    assert tex._real_split_plan(n)[3][0] == form
    x = _input(n, 2, 992 + n)[:1 if n > 4096 else 3]
    w64, hi, lo = _hann(n)
    want = np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]
    mag = tex.rfft_mag_real_lowering(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    mag_j = jax.jit(lambda a, h, l: jex._rfft_mag_real_xla(
        a, n // 2, (h, l)))(jnp.asarray(x), jnp.asarray(hi), jnp.asarray(lo))
    assert _rel(mag.numpy(), np.asarray(mag_j, np.float64)) <= TOL
    assert _rel(mag.numpy(), want) <= TOL
    bare = tex.rfft_mag_real_lowering(torch.from_numpy(x))
    want = np.abs(np.fft.rfft(x.astype(np.float64)))[..., :n // 2]
    assert _rel(bare.numpy(), want) <= TOL


def test_real_split_plan_matches_jax():
    """The real-split plan's digit planes and twiddle pairs equal the JAX
    package's exactly, in both forms."""
    for n in (800, 65536):
        port, ref = tex._real_split_plan(n), jex._real_split_plan(n)
        assert port[:2] == ref[:2]
        np.testing.assert_array_equal(port[2], np.asarray(ref[2]))
        assert port[3][0] == ref[3][0]
        for got, want in zip(port[3][1:], ref[3][1:]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
