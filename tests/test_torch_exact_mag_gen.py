"""K1-gen: K1's body (``_kernel_real_mag``) at every other N1 % 8 == 0,
and the JAX package's routing of the pair kernels.

On the CPU a K1-gen size takes the same plain twin as K1,
``rfft_pair_mag_ref`` (general in N1), so these tests hold that twin, the
router and the serving path at K1-gen sizes against the JAX package; the
CUDA kernel itself is held bit for bit against the twin by
tests/test_torch_cuda.py and chip_smoke.py on the card.

Tolerances, with their reasons:

* twin vs the JAX kernel (interpret mode, N = 3072 and 6144) and vs
  float64: max|Δ| / max|ref| <= 2.5e-7, the kernel bound of
  tests/test_exact_pallas.py; XLA on the CPU contracts the JAX kernel's
  df32 products into FMAs, so it is no bitwise reference;
* K1-gen's twin vs K2's twin at 8192 and 16384: <= 3e-7 · max, the bound
  of tests/test_exact_pallas.py::test_real_split3_matches_2factor;
* the serving slice: 1e-4 dB against the JAX engine and the float64
  oracle on bins above -120 dBFS, the bench's accuracy gate;
* nonzero counts and the routing predicates: exact.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import waveform_tpu as jwt
from waveform_tpu.kernels import exact_pallas as jep
from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
import waveform_tpu_torch as wt
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels import exactfft as tex
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES
from waveform_tpu_torch.runtime.serving import ServingEngine

from test_torch_exact_mag3 import _unpack_b2

TOL = 2.5e-7
TOL_SPLITS = 3e-7
SR, HOP, T0, FRAME_NS = 48000, 800, 10_000_000_000, 16_666_667


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


def _signal(rng, S, n):
    """Noise plus a tone; with S >= 2 the second stream has a silent
    channel and scattered zero samples (zeros count as silence)."""
    x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
    x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / SR).astype(
        np.float32)
    if S >= 2:
        x[1, 1] = 0.0
        x[1, 0, ::3] = 0.0
    return x


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", [3072, 6144])
def test_twin_matches_jax_kernel_and_f64(n, windowed):
    """The twin at two K1-gen sizes against ``_kernel_real_mag`` in
    interpret mode (the JAX split rule gives it 2 there) and float64."""
    assert jep._stage1_split(n) == 2 and exact_cuda.stage1_split(n) == 2
    rng = np.random.default_rng(2000 + n + windowed)
    x = _signal(rng, 2, n)
    if windowed:
        w64, hi, lo = _hann(n)
        win = (torch.from_numpy(hi), torch.from_numpy(lo))
        win_j = (jnp.asarray(hi), jnp.asarray(lo))
    else:
        w64, win, win_j = np.ones(n), None, None
    mag, nz = exact_cuda.rfft_pair_mag(torch.from_numpy(x), win)
    mag_j, nz_j = jep.rfft_pair_mag_kernel(jnp.asarray(x), window=win_j,
                                           interpret=True)
    want = _f64_mag(x, w64)
    assert mag.shape == (2, 2, n // 2) and mag.dtype == torch.float32
    assert _rel(mag.numpy(), np.asarray(mag_j, np.float64)) <= TOL
    assert _rel(mag.numpy(), want) <= TOL
    assert (mag.numpy()[1, 1] == 0).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))
    np.testing.assert_array_equal(nz.numpy() > 0, np.asarray(nz_j))


@pytest.mark.parametrize("n", [9216, 16384, 31744])
def test_twin_matches_f64_at_large_n(n):
    rng = np.random.default_rng(n + 1)
    x = _signal(rng, 2, n)
    w64, hi, lo = _hann(n)
    mag, nz = exact_cuda.rfft_pair_mag(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))


@pytest.mark.parametrize("n", [8192, 16384])
def test_twin_matches_k2_twin(n):
    """At the sizes the JAX rule moved from K2 to K1-gen the two bodies
    agree within the splits' bound (they slice at different points)."""
    rng = np.random.default_rng(n + 2)
    x = torch.from_numpy(_signal(rng, 2, n))
    _, hi, lo = _hann(n)
    win = (torch.from_numpy(hi), torch.from_numpy(lo))
    m1, nz1 = exact_cuda.rfft_pair_mag(x, win)
    m3, nz3 = exact_cuda.rfft_pair_mag3_ref(x, win)
    assert float((m1 - m3).abs().max()) <= TOL_SPLITS * float(m3.max())
    assert torch.equal(nz1, nz3)


def test_quiet_channel_shares_its_partners_scale():
    """K1's scale rule: one pow2 scale per (stream, j2) column over both
    channels.  A channel 120 dB below its partner is sliced at the loud
    channel's scale, so it keeps the bound relative to the pair and not to
    itself, as the JAX kernel does (K2 keeps it per channel:
    tests/test_torch_exact_mag3.py::test_quiet_channel_keeps_its_own_scale).
    """
    n = 3072
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 2, n)).astype(np.float32)
    x[:, 1] *= np.float32(1e-6)
    w64, hi, lo = _hann(n)
    mag, _ = exact_cuda.rfft_pair_mag(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    mag_j, _ = jep.rfft_pair_mag_kernel(
        jnp.asarray(x), window=(jnp.asarray(hi), jnp.asarray(lo)),
        interpret=True)
    mag_j = np.asarray(mag_j, np.float64)
    want = _f64_mag(x, w64)
    for s in range(2):
        assert _rel(mag.numpy()[s], want[s]) <= TOL, s
        assert _rel(mag.numpy()[s], mag_j[s]) <= TOL, s
        assert _rel(mag.numpy()[s, 1], want[s, 1]) > 1e-4, s
        assert _rel(mag_j[s, 1], want[s, 1]) > 1e-4, s


def test_corrupt_streams_isolated():
    """A 1e20 stream and a NaN stream degrade only themselves at a K1-gen
    size, and the 1e20 stream stays finite."""
    n = 5120
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((5, 2, n))).astype(np.float32)
    x[1] = (1e20 * rng.standard_normal((2, n))).astype(np.float32)
    x[3, 0, 7] = np.nan
    w64, hi, lo = _hann(n)
    mag, nz = exact_cuda.rfft_pair_mag(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    got = mag.numpy()
    want = _f64_mag(x, w64)
    for s in (0, 2, 4):
        assert _rel(got[s], want[s]) <= TOL, s
    assert np.isfinite(got[1]).all()
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1))


@pytest.mark.parametrize("mode", [None, "2", "3"])
def test_routing_matches_jax(mode, monkeypatch):
    """``stage1_split``, ``supports`` and ``kernel_would_run`` equal the
    JAX package's at every reference-legal size under each
    ``WAVEFORM_TPU_STAGE1_SPLIT`` setting (the JAX kernel forced on, as on
    a TPU; no measured plan), and no admitted size raises in the port."""
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", "/nonexistent/plans.json")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
    if mode is None:
        monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    else:
        monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", mode)
    admitted = []
    for n in range(128, 65537, 16):
        assert exact_cuda.stage1_split(n) == jep._stage1_split(n), n
        assert exact_cuda.supports(n) == jep.supports(n), n
        assert exact_cuda.kernel_would_run(n) == jep.kernel_would_run(n), n
        if exact_cuda.supports(n):
            admitted.append(n)
    gen = [n for n in admitted
           if exact_cuda.stage1_split(n) == 2 and n not in (1024, 2048, 4096)]
    k2 = [n for n in admitted if exact_cuda.stage1_split(n) == 3]
    want_gen, want_k2 = {None: (28, 9), "2": (29, 0), "3": (0, 16)}[mode]
    assert (len(gen), len(k2)) == (want_gen, want_k2)
    for n in (gen[:1] + gen[-1:]) + (k2[:1] if mode == "3" else []):
        mag, nz = exact_cuda.rfft_pair_mag(torch.zeros((1, 2, n)))
        assert mag.shape == (1, 2, n // 2) and not nz.any()


def test_split3_sends_6144_to_the_packed_pair(monkeypatch):
    """Under ``WAVEFORM_TPU_STAGE1_SPLIT=3`` N = 6144 (N1 = 48) leaves the
    pair kernels' geometry, so the stream takes the packed pair (K3's
    twin here), as the JAX package routes it."""
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", "3")
    n = 6144
    assert not exact_cuda.kernel_would_run(n) and exact_cuda.supports_cfft(n)
    rng = np.random.default_rng(12)
    x = _signal(rng, 2, n)
    w64, hi, lo = _hann(n)
    mag, nz = tex.rfft_mag_exact(
        torch.from_numpy(x), (torch.from_numpy(hi), torch.from_numpy(lo)))
    assert _rel(mag.numpy(), _f64_mag(x, w64)) <= TOL
    np.testing.assert_array_equal(nz.numpy(), np.count_nonzero(x, axis=-1)
                                  > 0)


def _unpack_a1(frag, depth=None):
    """K1-gen's stage-1 A fragments [4, n1/8, k, 32, 4] back to F1r's digit
    planes [4, 2n1, n1], read by the PTX ISA's mma.m16n8k32 .s8 layout
    (lane = 4g + t; register r holds fragment row g + 8·(r % 2) at k =
    16·(r // 2) + 4t .. +3 of its k-step): M tile T has the re row
    k1 = 8T + g as fragment row g and the im row n1 + 8T + g as row g + 8.
    The contraction past ``depth`` (n1 for None; K3's F1b: 2n1) must be
    zero padding."""
    nd, tiles, ksteps = frag.shape[:3]
    n1 = 8 * tiles
    depth = n1 if depth is None else depth
    out = np.zeros((nd, 2 * n1, 32 * ksteps), np.int8)
    digits = frag.view(np.int8).reshape(nd, tiles, ksteps, 32, 4, 4)
    for tile in range(tiles):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for r in range(4):
                row = 8 * tile + g + n1 * (r % 2)
                for ks in range(ksteps):
                    k0 = 32 * ks + 16 * (r // 2) + 4 * t
                    out[:, row, k0:k0 + 4] = digits[:, tile, ks, lane, r]
    assert not out[:, :, depth:].any()
    return out[:, :, :depth]


@pytest.mark.parametrize("n1", [8, 24, 48, 128, 256])
def test_fragment_words_unpack_to_plan_digits(n1):
    """K1-gen's tensor-core constant words (``f1f``, ``f2b``) hold exactly
    the plan's digit planes: N1 = 8 and 24 padded with zero digits to one
    k-step of 32 and a partial 64-row group, 48 to two k-steps, 256 the
    largest (8 k-steps, 8 full groups)."""
    n = 128 * n1
    plan = exact_cuda._kernel_plan_real(n)
    c = exact_cuda._consts(n, torch.device("cpu"))
    frag = c["f1f"].numpy()
    assert frag.dtype == np.int32 and frag.shape == (
        4, n1 // 8, -(-n1 // 32), 32, 4)
    np.testing.assert_array_equal(_unpack_a1(frag), plan[2])
    assert c["f2b"].shape == (4, 8, 16, 32, 2)
    np.testing.assert_array_equal(_unpack_b2(c["f2b"].numpy()), plan[3])


def test_direct_entry_and_constants():
    """``rfft_pair_mag_gen`` takes every 2-factor size, N1 in {8, 16, 32}
    included, runs the twin on a CPU tensor and counts no launch; K1-gen's
    stage-2 B fragments are K2's at every size (one f2 block)."""
    before = (LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K1-gen"])
    rng = np.random.default_rng(3)
    f2b = exact_cuda._consts3(4096, torch.device("cpu"))["f2b"]
    for n in (1024, 3072, 4096):
        x = torch.from_numpy(_signal(rng, 2, n))
        mag, nz = exact_cuda.rfft_pair_mag_gen(x)
        ref, nz_ref = exact_cuda.rfft_pair_mag_ref(x)
        assert torch.equal(mag, ref) and torch.equal(nz, nz_ref)
        assert torch.equal(exact_cuda._consts(n, torch.device("cpu"))["f2b"],
                           f2b)
    assert (LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K1-gen"]) == before
    for n in (1040, 512, 65536):
        with pytest.raises(NotImplementedError):
            exact_cuda.rfft_pair_mag_gen(torch.zeros((1, 2, n)))
    with pytest.raises(ValueError):
        exact_cuda.rfft_pair_mag_gen(torch.zeros((1, 3, 3072)))


def _to_jax(v):
    """A port enum member or config dataclass -> the JAX package's own, by
    name; other values as they are."""
    if isinstance(v, enum.Enum):
        return getattr(jwt, type(v).__name__)[v.name]
    if dataclasses.is_dataclass(v):
        return getattr(jwt, type(v).__name__)(
            **{f.name: _to_jax(getattr(v, f.name))
               for f in dataclasses.fields(v)})
    return v


def test_serving_slice_at_6144_matches_jax_and_oracle():
    """The slice: ``ServingEngine`` at N = 6144 (an FFT-size slider
    position that raised before K1-gen), Hann, Lanczos, stereo capture,
    S = 3 with a silent stream, against the JAX engine (its XLA lowering on
    the CPU) every tick, and a TSmoothing-NONE engine's frame against the
    float64 oracle."""
    settings = dict(fft_size=6144, width=800, window=wt.FFTWindow.HANN,
                    interp_mode=wt.InterpMode.LANCZOS)
    cfg = wt.resolve(wt.Settings(**settings), wt.AudioInfo(SR, 2))
    assert cfg.fft_size == 6144 and exact_cuda.kernel_would_run(6144)
    S = 3
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(jwt.resolve(_to_jax(cfg.settings), _to_jax(cfg.audio),
                                _to_jax(cfg.video)), S, use_native=False)
    rng = np.random.default_rng(61)
    for k in range(9):
        t = (np.arange(HOP) + k * HOP) / SR
        x = 0.3 * rng.standard_normal((S, 2, HOP)) + 0.1 * np.sin(
            2 * np.pi * 440.0 * t)
        x[2] = 0.0
        x = x.astype(np.float32)
        now = T0 + k * FRAME_NS
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
        got, want = port.read_decibels(), ref.read_decibels()
        vis = want > -120.0
        np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
        floor = want == np.float32(wt.DB_MIN)
        np.testing.assert_array_equal(got[floor], want[floor])
        np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    assert port.last_silent[2] and not port.last_silent[:2].any()
    px, px_ref = port.read_pixels(), ref.read_pixels()
    vis = px_ref > -120.0
    np.testing.assert_allclose(px[vis], px_ref[vis], rtol=0, atol=1e-4)

    gcfg = wt.resolve(wt.Settings(
        **settings, temporal_smoothing=wt.TSmoothingMode.NONE),
        wt.AudioInfo(SR, 2))
    eng = ServingEngine(gcfg, 2, device="cpu")
    for k in range(9):
        now = T0 + k * FRAME_NS
        eng.feed_batch(rng.uniform(-0.5, 0.5, (2, 2, HOP)).astype(
            np.float32), now, now_ns=now)
        eng.tick(now_ns=now)
    window = eng.ring.buf[0].numpy().astype(np.float64)
    want, _ = wt.oracle.spectrum_frame(window, None, gcfg, dt=1 / 60)
    got = eng.read_decibels()[0]
    vis = want > -120.0
    assert vis.sum() > 1000
    assert np.abs(got[vis] - want[vis]).max() < 1e-4
