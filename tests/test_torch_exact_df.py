"""The df twiddle tier of the port's real-split kernels against the JAX
package.

``WAVEFORM_TPU_KERNEL_TWIDDLE=df`` (``exact_pallas._twiddle_choice``) runs
the compensated branch of ``_kernel_real_mag`` (K1's body) and
``_kernel_real_mag3`` (K2): the serial digit slice, TwoSum recombination,
the Dekker df32 twiddle and ``_tail_stage2``'s df magnitude.  The port's
twins ``rfft_pair_mag_df_ref`` (K1-df) and ``rfft_pair_mag3_df_ref`` (K2-df)
are held here against those Pallas bodies in interpret mode and against
float64 numpy, and the router is held to the tier the variable names.

Tolerances, with their reasons:

* twin vs the JAX df body and vs float64: max|Δ| / max|ref| <= 2.5e-7,
  the kernel bound of tests/test_exact_pallas.py (XLA contracts the JAX
  body's df32 products into FMAs on the CPU, so it is no bitwise
  reference);
* df twin vs the f32 twin against float64: strictly smaller, on noise
  under a Hann window (the f32 output's own rounding bounds the gain);
* nonzero counts: exact.

The CUDA kernels are checked against the twins, bit for bit, by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu.kernels import exact_pallas as jep
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES

TOL = 2.5e-7

TWINS = {2: (exact_cuda.rfft_pair_mag_df_ref, exact_cuda.rfft_pair_mag_ref),
         3: (exact_cuda.rfft_pair_mag3_df_ref, exact_cuda.rfft_pair_mag3_ref)}


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _hann(n):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return w64, hi, lo


def _f64_mag(x, w64):
    n = x.shape[-1]
    return np.abs(np.fft.rfft(x.astype(np.float64) * w64))[..., :n // 2]


def _jax_df(x, hi, lo, split):
    """The df tier of ``_kernel_real_mag`` (split 2) or ``_kernel_real_mag3``
    (split 3) in interpret mode, int8 digits, its block-ordered
    channel-planar output put back in natural order: [S, 2, N/2]
    magnitudes and [S, 2] nonzero counts."""
    S, _, n = x.shape
    mag2, nz = jep.rfft_rows_mag_packed(
        jnp.asarray(x.reshape(S * 2, n)), jnp.asarray(hi), jnp.asarray(lo),
        interpret=True, split=split, ddt="int8", twiddle="df")
    mag = np.swapaxes(np.asarray(mag2), 0, 1)
    inv = np.argsort(jep.block_bin_of_pos(n, split))
    return mag[..., inv], np.asarray(nz)


def _signal(rng, S, n):
    """Noise plus a tone, with a silent channel, a silent stream and
    scattered zero samples (zeros count as silence)."""
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / 48000.0).astype(
        np.float32)
    x[1, 1] = 0.0
    x[-1] = 0.0
    x[2 % S, 0, ::3] = 0.0
    return x


@pytest.mark.parametrize("env,tier", [
    (None, "f32"), ("f32", "f32"), ("df", "df"), ("DF", "f32"),
    ("fast", "f32"), ("", "f32")])
def test_twiddle_tier_reads_the_variable(env, tier, monkeypatch):
    """``_twiddle_choice``: "df" or "f32" as set, anything else the f32
    default; read at each call."""
    if env is None:
        monkeypatch.delenv("WAVEFORM_TPU_KERNEL_TWIDDLE", raising=False)
    else:
        monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", env)
    assert exact_cuda.twiddle_tier() == tier


def test_direct_entries_take_a_named_tier_only():
    x = torch.zeros((1, 2, 4096))
    for fn in (exact_cuda.rfft_pair_mag_gen, exact_cuda.rfft_pair_mag3):
        with pytest.raises(ValueError, match="twiddle"):
            fn(x, twiddle="f64")


@pytest.mark.parametrize("n", [1024, 6144, 32768])
def test_plan_constants_match_jax(n):
    """K1's plan equals the JAX package's exactly (bs=1 leaves the twiddle
    tiles as the [n1, 128] base; the JAX plan stacks the classes and runs
    stage 1 block-diagonally over the two channels), and the df planes the
    kernel reads carry the (hi, lo, Veltkamp-high) twiddle."""
    port = exact_cuda._kernel_plan_real(n)
    ref = jep._kernel_plan_real(n, 1)
    assert port[:2] == ref[:2]
    zero = np.zeros_like(port[2][0])
    f1bd = np.stack([np.block([[p, zero], [zero, p]]) for p in port[2]])
    np.testing.assert_array_equal(ref[2], jep._stacked_classes(f1bd, 1))
    np.testing.assert_array_equal(ref[3], jep._stacked_classes(port[3], 0))
    for got, want in zip(port[4:], ref[4:]):
        np.testing.assert_array_equal(got, want)
    c = exact_cuda._consts(n, torch.device("cpu"))
    twr_hi, twr_lo, twi_hi, twi_lo, twr_h, twi_h = port[4:]
    np.testing.assert_array_equal(c["twr_df"].numpy(),
                                  np.stack([twr_hi, twr_lo, twr_h]))
    np.testing.assert_array_equal(c["twi_df"].numpy(),
                                  np.stack([twi_hi, twi_lo, twi_h]))


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n,split,S", [
    (1024, 2, 4), (4096, 2, 3), (4096, 3, 3), (8192, 3, 3)])
def test_df_twin_matches_jax_df_body_and_f64(n, split, S, windowed):
    rng = np.random.default_rng(500 + n + split + windowed)
    x = _signal(rng, S, n)
    w64, hi, lo = _hann(n)
    if not windowed:
        w64, hi, lo = (np.ones(n), np.ones(n, np.float32),
                       np.zeros(n, np.float32))
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    mag, nz = TWINS[split][0](torch.from_numpy(x), win)
    mag_j, nz_j = _jax_df(x, hi, lo, split)
    want = _f64_mag(x, w64)
    assert mag.shape == (S, 2, n // 2) and mag.dtype == torch.float32
    assert _rel(mag.numpy(), mag_j.astype(np.float64)) <= TOL
    assert _rel(mag.numpy(), want) <= TOL
    assert (mag.numpy()[-1] == 0).all() and (mag.numpy()[1, 1] == 0).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))
    np.testing.assert_array_equal(nz.numpy(), nz_j)


@pytest.mark.parametrize("n,split", [(1024, 2), (4096, 2), (4096, 3),
                                     (8192, 3)])
def test_df_twin_beats_the_f32_twin(n, split):
    """On Hann-windowed noise each df twin lands within 2.5e-7 of float64
    and strictly closer to it than the f32 twin on the same input."""
    rng = np.random.default_rng(600 + n + split)
    S = 4 if n <= 4096 else 2
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    w64, hi, lo = _hann(n)
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    want = _f64_mag(x, w64)
    df_twin, f32_twin = TWINS[split]
    e_df = _rel(df_twin(torch.from_numpy(x), win)[0].numpy(), want)
    e_f32 = _rel(f32_twin(torch.from_numpy(x), win)[0].numpy(), want)
    assert e_df <= TOL
    assert e_df < e_f32, (e_df, e_f32)


@pytest.mark.parametrize("n,split", [(2048, 2), (3072, 2), (8192, 3)])
def test_router_takes_the_tier_the_variable_names(n, split, monkeypatch):
    """Under ``KERNEL_TWIDDLE=df`` the router runs the df twin of its split
    on a CPU tensor, K1's own sizes included; under f32, unset or any
    other value it runs the f32 twin, bit for bit; no call counts a
    launch.  (8192 takes split 3 under ``WAVEFORM_TPU_STAGE1_SPLIT=3``.)"""
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", str(split))
    rng = np.random.default_rng(700 + n)
    x = torch.from_numpy(_signal(rng, 2, n))
    _, hi, lo = _hann(n)
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    df_twin, f32_twin = TWINS[split]
    counts = (LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K1-gen"],
              LAUNCHES["K1-df"], LAUNCHES["K2-df"])
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    mag, nz = exact_cuda.rfft_pair_mag(x, win)
    ref, nz_ref = df_twin(x, win)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
    f32_ref, _ = f32_twin(x, win)
    assert not torch.equal(mag, f32_ref)
    for env in (None, "f32", "bogus"):
        if env is None:
            monkeypatch.delenv("WAVEFORM_TPU_KERNEL_TWIDDLE")
        else:
            monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", env)
        mag, nz = exact_cuda.rfft_pair_mag(x, win)
        assert torch.equal(mag, f32_ref) and torch.equal(nz, nz_ref), env
    assert (LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K1-gen"],
            LAUNCHES["K1-df"], LAUNCHES["K2-df"]) == counts


@pytest.mark.parametrize("split", [2, 3])
def test_direct_entries_follow_their_twiddle_argument(split, monkeypatch):
    """``rfft_pair_mag_gen`` and ``rfft_pair_mag3`` take the tier from
    ``twiddle`` over the environment, and from the environment when it
    is None."""
    n = 4096
    fn = exact_cuda.rfft_pair_mag_gen if split == 2 else \
        exact_cuda.rfft_pair_mag3
    df_twin, f32_twin = TWINS[split]
    rng = np.random.default_rng(800 + split)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, 2, n)))
                         .astype(np.float32))
    df_ref, f32_ref = df_twin(x)[0], f32_twin(x)[0]
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    assert torch.equal(fn(x)[0], df_ref)
    assert torch.equal(fn(x, twiddle="f32")[0], f32_ref)
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "f32")
    assert torch.equal(fn(x)[0], f32_ref)
    assert torch.equal(fn(x, twiddle="df")[0], df_ref)


def test_corrupt_streams_isolated_df():
    """A 1e20 stream and a NaN stream degrade only themselves at the df
    tier too: the scale rules are the f32 tier's, and the clamp of the hi
    words keeps the 1e20 stream finite."""
    n = 4096
    rng = np.random.default_rng(9)
    x = (0.5 * rng.standard_normal((5, 2, n))).astype(np.float32)
    x[1] = (1e20 * rng.standard_normal((2, n))).astype(np.float32)
    x[3, 0, 7] = np.nan
    w64, hi, lo = _hann(n)
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    want = _f64_mag(x, w64)
    for split in (2, 3):
        got = TWINS[split][0](torch.from_numpy(x), win)[0].numpy()
        for s in (0, 2, 4):
            assert _rel(got[s], want[s]) <= TOL, (split, s)
        if split == 3:          # K2 scales each channel on its own
            assert _rel(got[3, 1], want[3, 1]) <= TOL
        assert np.isfinite(got[1]).all()
