"""The port's 3-factor exact |rFFT| (K2) against the JAX package.

K2 is ``exact_pallas._kernel_real_mag3``: a df32 radix-4 butterfly over the
four a-row chunks of stage 1, then two twiddle-folded DFT_a digit GEMMs.
The port's plain twin ``rfft_pair_mag3_ref`` (what a CPU tensor runs) is
held here against that Pallas body in interpret mode (forced to split 3:
on the CPU the JAX package resolves 8192 to the 2-factor body, because its
plan table applies on a v5e only) and against float64 numpy.  Below
N = 32768 the port's router follows the same rule and sends the pair to
K1-gen, so these tests reach K2 through its direct entry point
``rfft_pair_mag3`` there.

Tolerances, with their reasons:

* twin vs the JAX kernel and vs float64: max|Δ| / max|ref| <= 2.5e-7, the
  kernel bound of tests/test_exact_pallas.py.  The JAX kernel is not a
  bitwise reference on the CPU: XLA contracts its df32 products into FMAs;
* K2 twin vs K1 twin at N=4096: <= 3e-7 · max, the bound of
  tests/test_exact_pallas.py::test_real_split3_matches_2factor (the two
  splits slice at different points, so they are not bit-equal);
* nonzero counts: exact.

The CUDA kernel itself is checked against the twin, bit for bit, by
tests/test_torch_cuda.py and chip_smoke.py on the card.
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
TOL_SPLITS = 3e-7


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


def _jax_k2(x, hi, lo):
    """``_kernel_real_mag3`` in interpret mode (int8 digits, f32 twiddle
    tier), its block-ordered channel-planar output put back in natural
    order: [S, 2, N/2] magnitudes and [S, 2] nonzero counts."""
    S, _, n = x.shape
    mag2, nz = jep.rfft_rows_mag_packed(
        jnp.asarray(x.reshape(S * 2, n)), jnp.asarray(hi), jnp.asarray(lo),
        interpret=True, split=3, ddt="int8", twiddle="f32")
    mag = np.swapaxes(np.asarray(mag2), 0, 1)
    inv = np.argsort(jep.block_bin_of_pos(n, 3))
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


@pytest.mark.parametrize("n", [4096, 8192, 65536])
def test_plan3_constants_match_jax(n):
    """Digit planes and chunk-major twiddles equal the JAX plan builder's,
    exactly (the JAX plan stacks the classes; bs=1 leaves the twiddle tiles
    as the [n1, 128] base), and the packed words hold the same digits."""
    port = exact_cuda._kernel_plan_real3(n)
    ref = jep._kernel_plan_real3(n, 1)
    assert port[:3] == ref[:3]
    np.testing.assert_array_equal(ref[3], jep._stacked_classes(port[3], 1))
    np.testing.assert_array_equal(ref[4], jep._stacked_classes(port[4], 1))
    np.testing.assert_array_equal(ref[5], jep._stacked_classes(port[5], 0))
    for got, want in zip(port[6:], ref[6:]):
        np.testing.assert_array_equal(got, want)
    c = exact_cuda._consts3(n, torch.device("cpu"))
    for key, planes in (("c02f", port[3]), ("c13f", port[4])):
        np.testing.assert_array_equal(_unpack_a3(c[key].numpy()), planes)
    np.testing.assert_array_equal(_unpack_b2(c["f2b"].numpy()), port[5])


def _unpack_a3(frag):
    """K2's stage-1 A fragments [4, a/4, k, 32, 4] back to the digit
    planes [4, 4a, 2a], read by the PTX ISA's mma.m16n8k32 .s8 layout
    (lane = 4g + t; register r holds fragment row g + 8·(r % 2) at k =
    16·(r // 2) + 4t .. +3 of its k-step); M tile T = h·(a/8) + kb has its
    fragment row i at c row h·2a + kb·8 + i % 8 + a·(i // 8).  The
    contraction past 2a must be zero padding."""
    nd, tiles, ksteps = frag.shape[:3]
    a = 4 * tiles
    out = np.zeros((nd, 4 * a, 32 * ksteps), np.int8)
    digits = frag.view(np.int8).reshape(nd, tiles, ksteps, 32, 4, 4)
    for tile in range(tiles):
        h, kb = divmod(tile, a // 8)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for r in range(4):
                i = g + 8 * (r % 2)
                row = h * 2 * a + kb * 8 + i % 8 + a * (i // 8)
                for ks in range(ksteps):
                    k0 = 32 * ks + 16 * (r // 2) + 4 * t
                    out[:, row, k0:k0 + 4] = digits[:, tile, ks, lane, r]
    assert not out[:, :, 2 * a:].any()
    return out[:, :, :2 * a]


def _unpack_b2(frag):
    """The stage-2 B fragments [4, 8, T, 32, 2] back to the digit planes
    [4, 256, 8T] (register r of lane 4g + t holds column 8·tile + g at
    k = 16r + 4t .. +3 of its k-step)."""
    tiles = frag.shape[2]
    out = np.zeros((4, 256, 8 * tiles), np.int8)
    digits = frag.view(np.int8).reshape(4, 8, tiles, 32, 2, 4)
    for ks in range(8):
        for tile in range(tiles):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for r in range(2):
                    k0 = 32 * ks + 16 * r + 4 * t
                    out[:, k0:k0 + 4, 8 * tile + g] = digits[:, ks, tile,
                                                             lane, r]
    return out


@pytest.mark.parametrize("n", [4096, 8192, 65536])
def test_fragment_words_unpack_to_plan3_digits(n):
    """The tensor-core kernel's constant words (c02f/c13f, f2b) hold
    exactly the plan's digit planes, N=4096's 16-deep contraction padded
    with zero digits to one k-step of 32."""
    plan = exact_cuda._kernel_plan_real3(n)
    a = plan[2]
    c = exact_cuda._consts3(n, torch.device("cpu"))
    for key, planes in (("c02f", plan[3]), ("c13f", plan[4])):
        frag = c[key].numpy()
        assert frag.dtype == np.int32 and frag.shape == (
            4, a // 4, -(-2 * a // 32), 32, 4)
        np.testing.assert_array_equal(_unpack_a3(frag), planes)
    assert c["f2b"].shape == (4, 8, 16, 32, 2)
    np.testing.assert_array_equal(_unpack_b2(c["f2b"].numpy()), plan[5])


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n,S", [(4096, 4), (8192, 3)])
def test_twin3_matches_jax_kernel_and_f64(n, S, windowed):
    rng = np.random.default_rng(300 + n + windowed)
    x = _signal(rng, S, n)
    w64, hi, lo = _hann(n)
    if not windowed:
        w64, hi, lo = (np.ones(n), np.ones(n, np.float32),
                       np.zeros(n, np.float32))
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    mag, nz = exact_cuda.rfft_pair_mag3_ref(torch.from_numpy(x), win)
    mag_j, nz_j = _jax_k2(x, hi, lo)
    want = _f64_mag(x, w64)
    assert mag.shape == (S, 2, n // 2) and mag.dtype == torch.float32
    assert _rel(mag.numpy(), mag_j.astype(np.float64)) <= TOL
    assert _rel(mag.numpy(), want) <= TOL
    assert (mag.numpy()[-1] == 0).all() and (mag.numpy()[1, 1] == 0).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))
    np.testing.assert_array_equal(nz.numpy(), nz_j)


@pytest.mark.parametrize("n", [16384, 65536])
def test_twin3_matches_f64_at_large_n(n):
    rng = np.random.default_rng(n)
    x = (0.4 * rng.standard_normal((1, 2, n))).astype(np.float32)
    x[0, 1, : n // 3] = 0.0
    w64, hi, lo = _hann(n)
    mag, nz = exact_cuda.rfft_pair_mag3(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))


def test_corrupt_streams_isolated3():
    """A 1e20 stream and a NaN stream degrade only themselves: each
    (stream, channel, column) keeps its own pow2 scales, and the 1e20
    stream stays finite (the pre-square clamp)."""
    n = 8192
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((5, 2, n))).astype(np.float32)
    x[1] = (1e20 * rng.standard_normal((2, n))).astype(np.float32)
    x[3, 0, 7] = np.nan
    w64, hi, lo = _hann(n)
    mag, nz = exact_cuda.rfft_pair_mag3(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    mag_j, _ = _jax_k2(x, hi, lo)
    got = mag.numpy()
    want = _f64_mag(x, w64)
    for s in (0, 2, 4):
        assert _rel(got[s], want[s]) <= TOL, s
        assert _rel(got[s], mag_j[s].astype(np.float64)) <= TOL, s
    assert _rel(got[3, 1], want[3, 1]) <= TOL    # the NaN's other channel
    assert np.isfinite(got[1]).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))


def test_quiet_channel_keeps_its_own_scale():
    """K2 scales each (stream, channel, j2) column on its own, so a channel
    120 dB below its partner keeps the full bound relative to itself (a
    scale shared across the pair, K1's rule, would cost it ~20 bits)."""
    n = 8192
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 2, n)).astype(np.float32)
    x[:, 1] *= np.float32(1e-6)
    w64, hi, lo = _hann(n)
    mag, _ = exact_cuda.rfft_pair_mag3(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    mag_j, _ = _jax_k2(x, hi, lo)
    want = _f64_mag(x, w64)
    for s in range(2):
        for c in range(2):
            assert _rel(mag.numpy()[s, c], want[s, c]) <= TOL, (s, c)
            assert _rel(mag_j[s, c], want[s, c]) <= TOL, (s, c)


@pytest.mark.parametrize("windowed", [True, False])
def test_twin3_matches_twin2_at_4096(windowed):
    n = 4096
    rng = np.random.default_rng(41 + windowed)
    x = torch.from_numpy((0.4 * rng.standard_normal((2, 2, n)))
                         .astype(np.float32))
    _, hi, lo = _hann(n)
    win = (torch.from_numpy(hi), torch.from_numpy(lo)) if windowed else None
    m2, nz2 = exact_cuda.rfft_pair_mag_ref(x, win)
    m3, nz3 = exact_cuda.rfft_pair_mag3_ref(x, win)
    scale = float(m2.max())
    assert float((m3 - m2).abs().max()) <= TOL_SPLITS * scale
    assert torch.equal(nz2, nz3)


@pytest.mark.parametrize("n,split", [
    (1024, 2), (2048, 2), (4096, 2), (6144, 2), (8192, 2), (10240, 2),
    (12288, 2), (16384, 2), (32768, 3), (65536, 3),
    (128, None), (800, None), (1040, None), (131072, None)])
def test_stage1_split_routes_each_size(n, split, monkeypatch):
    """The JAX package's split rule with no plan: 2 below N = 32768 (K1 at
    N1 in {8, 16, 32}, K1-gen at the other N1 % 8 == 0), 3 from 32768
    (K2); sizes outside the pair geometry raise NotImplementedError in the
    pair kernel, on the CPU as on the card."""
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    if split is None:
        assert not exact_cuda.supports(n)
        with pytest.raises(NotImplementedError):
            exact_cuda.rfft_pair_mag(torch.zeros((1, 2, n)))
    else:
        assert exact_cuda.supports(n)
        assert exact_cuda.stage1_split(n) == split


def test_direct_k2_entry_takes_its_geometry_only():
    for n in (1024, 2048, 5120, 131072):
        with pytest.raises(NotImplementedError):
            exact_cuda.rfft_pair_mag3(torch.zeros((1, 2, n)))
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag3(torch.zeros((1, 3, 4096)))
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag3(torch.zeros((1, 2, 4096)).to("meta"))


@pytest.mark.parametrize("streams,channels", [(3, 1), (2, 3)])
def test_lone_channels_pair_streams_at_8192(streams, channels, monkeypatch):
    """Mono, and the odd channel of an odd count, ride K2 by pairing
    streams, as the JAX rfft_mag_exact routes them with its kernel on and
    split 3."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", "3")
    n = 8192
    rng = np.random.default_rng(streams * 10 + channels + 80)
    x = (0.5 * rng.standard_normal((streams, channels, n))).astype(np.float32)
    x[-1, -1, :500] = 0.0
    w64, hi, lo = _hann(n)
    mag, nz = tex.rfft_mag_exact(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    mag_j, nz_j = jex.rfft_mag_exact(
        jnp.asarray(x), window=(jnp.asarray(hi), jnp.asarray(lo)),
        with_nz=True)
    assert mag.shape == (streams, channels, n // 2)
    assert _rel(mag.numpy(), np.asarray(mag_j, np.float64)) <= TOL
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    np.testing.assert_array_equal(nz.numpy(), np.asarray(nz_j))


def test_cpu_tensors_take_the_k2_twin_and_count_no_launch(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", "3")
    before = (exact_cuda.launches3, exact_cuda.launches_gen)
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 2, 8192))
        .astype(np.float32))
    mag, nz = exact_cuda.rfft_pair_mag(x)
    ref, nz_ref = exact_cuda.rfft_pair_mag3_ref(x)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
    y = x[..., :4096].contiguous()
    mag, nz = exact_cuda.rfft_pair_mag3(y)
    ref, nz_ref = exact_cuda.rfft_pair_mag3_ref(y)
    assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
    assert (exact_cuda.launches3, exact_cuda.launches_gen) == before
