"""The whole slice: the port's ServingEngine against the JAX ServingEngine.

Both engines take the same packets (made with numpy from a seed) through
the same entry points, with the pure-Python assembly (``use_native=False``)
and the JAX exact kernel in interpret mode; each package resolves the
same settings with its own ``resolve``.  Pixels and ``read_decibels``
must agree within 1e-4 dB (exactly where the reference reads DB_MIN), the
silence latch exactly.  Audio is noise-dominated, like the bench gate's
input (see tests/test_torch_spectrum.py for why).
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import waveform_tpu as jwt
from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import (
    DB_MIN,
    AudioInfo,
    ChannelMode,
    FFTWindow,
    InterpMode,
    Settings,
    TSmoothingMode,
    oracle,
    resolve,
)
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES
from waveform_tpu_torch.runtime.serving import ServingEngine

SR, HOP, T0 = 48000, 800, 10_000_000_000
FRAME_NS = 16_666_667


@pytest.fixture
def kernel_on(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")


def _audio(rng, S, k, silent=()):
    t = (np.arange(HOP) + k * HOP) / SR
    x = 0.3 * rng.standard_normal((S, 2, HOP))
    x += 0.1 * np.sin(2 * np.pi * 440.0 * t)
    x[list(silent)] = 0.0
    return x.astype(np.float32)


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    got, want = port.read_decibels(), ref.read_decibels()
    assert got.shape == want.shape
    vis = want > -120.0
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
    floor = want == np.float32(DB_MIN)
    np.testing.assert_array_equal(got[floor], want[floor])
    px, px_ref = port.read_pixels(), ref.read_pixels()
    assert px.shape == px_ref.shape
    vis = px_ref > -120.0
    np.testing.assert_allclose(px[vis], px_ref[vis], rtol=0, atol=1e-4)


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


def _jax_cfg(cfg):
    """The port config's settings, audio and video resolved by the JAX
    package."""
    return jwt.resolve(_to_jax(cfg.settings), _to_jax(cfg.audio),
                       _to_jax(cfg.video))


def _engines(cfg, S):
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False)
    return port, ref


@pytest.mark.parametrize("stereo", [False, True])
def test_feed_batch_slice_matches_jax(stereo, kernel_on):
    cfg = resolve(Settings(fft_size=1024, width=300,
                           channel_mode=(ChannelMode.STEREO if stereo
                                         else ChannelMode.MONO)),
                  AudioInfo(SR, 2))
    S = 4
    port, ref = _engines(cfg, S)
    rng = np.random.default_rng(20 + stereo)
    for k in range(6):
        x = _audio(rng, S, k, silent=[3])
        now = T0 + k * FRAME_NS
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
        _assert_same(port, ref)
    assert port.last_silent[3] and not port.last_silent[:3].any()


def test_per_stream_feed_slice_matches_jax(kernel_on):
    """Per-stream packets with uneven sizes (per-stream ring counts), a
    muted stream, a stream hidden mid-run, a silent stream, and a capture
    gap long enough to time a stream out."""
    cfg = resolve(Settings(fft_size=1024, width=300, slope=1.0,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(SR, 2))
    S = 4
    port, ref = _engines(cfg, S)
    rng = np.random.default_rng(30)
    now = T0
    for k in range(8):
        now += FRAME_NS if k != 6 else 600_000_000
        for s in range(S):
            if k >= 6 and s == 2:
                continue                     # stream 2 stops capturing
            frames = HOP + (37 * s if k % 2 else -37 * s)
            x = (0.3 * rng.standard_normal((2, frames))).astype(np.float32)
            if s == 3:
                x[:] = 0.0
            for eng in (port, ref):
                eng.feed(s, x, now, now_ns=now, muted=(s == 1 and k in (2, 3)))
        if k == 4:
            for eng in (port, ref):
                eng.set_show(0, False)
        for eng in (port, ref):
            eng.tick(now_ns=now)
        _assert_same(port, ref)
    assert port.last_silent[0] and port.last_silent[2]


def test_full_width_slice_matches_jax(kernel_on):
    """The headline configuration at full width: N=4096, 800 px, Hann,
    Lanczos, stereo capture."""
    cfg = resolve(Settings(fft_size=4096, width=800, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS), AudioInfo(SR, 2))
    S = 2
    port, ref = _engines(cfg, S)
    rng = np.random.default_rng(40)
    for k in range(7):
        x = _audio(rng, S, k)
        now = T0 + k * FRAME_NS
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    _assert_same(port, ref)
    assert port.read_pixels().shape == (S, 1, 800)


def test_native_and_python_assembly_agree():
    """The shared C++ assembler and the pure-Python assembly feed the
    port's device path the same rows."""
    cfg = resolve(Settings(fft_size=1024, width=200), AudioInfo(SR, 2))
    S = 3
    engines = [ServingEngine(cfg, S, use_native=None, device="cpu"),
               ServingEngine(cfg, S, use_native=False, device="cpu")]
    if engines[0]._native is None:
        pytest.skip("no C++ toolchain for the native assembler")
    rng = np.random.default_rng(50)
    for k in range(5):
        x = _audio(rng, S, k)
        now = T0 + k * FRAME_NS
        for eng in engines:
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    np.testing.assert_array_equal(engines[0].read_pixels(),
                                  engines[1].read_pixels())


def test_large_fft_slice_matches_jax(kernel_on, monkeypatch):
    """The large-FFT path at full width: N=8192 (the FFT-size slider's top
    without enable_large_fft), 800 px, Hann, Lanczos, stereo capture; the
    port runs its 3-factor twin (K2), the JAX kernel is forced to its
    3-factor body."""
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", "3")
    cfg = resolve(Settings(fft_size=8192, width=800, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS), AudioInfo(SR, 2))
    assert exact_cuda.stage1_split(cfg.fft_size) == 3
    S = 2
    port, ref = _engines(cfg, S)
    rng = np.random.default_rng(45)
    for k in range(5):
        x = _audio(rng, S, k)
        now = T0 + k * FRAME_NS
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    _assert_same(port, ref)
    assert port.read_pixels().shape == (S, 1, 800)


@pytest.mark.parametrize("n,channels,fused", [
    (800, 2, None), (1024, 2, "never"), (1024, 1, "never")])
def test_packed_pair_slice_matches_jax(n, channels, fused, kernel_on,
                                       monkeypatch):
    """The packed-pair path: the auto FFT size N=800 (48 kHz at 60 fps)
    through the digit lowering, and N=1024 under
    ``WAVEFORM_TPU_EXACT_FUSED=never`` through K3, stereo and mono capture.
    Hann, Lanczos, a silent stream; no pair-kernel launch and, on the CPU,
    no K3 launch either (the twin runs)."""
    if fused:
        monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", fused)
    else:
        monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
    settings = (Settings(auto_fft_size=True, width=400,
                         window=FFTWindow.HANN, interp_mode=InterpMode.LANCZOS)
                if n == 800 else
                Settings(fft_size=n, width=400, window=FFTWindow.HANN,
                         interp_mode=InterpMode.LANCZOS))
    cfg = resolve(settings, AudioInfo(SR, channels))
    assert cfg.fft_size == n
    S = 3
    port, ref = _engines(cfg, S)
    rng = np.random.default_rng(70 + n + channels)
    before = (LAUNCHES["K2"], LAUNCHES["K3"])
    for k in range(4):
        x = _audio(rng, S, k, silent=[2])[:, :channels]
        now = T0 + k * FRAME_NS
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
        _assert_same(port, ref)
    assert port.last_silent[2] and not port.last_silent[:2].any()
    assert (LAUNCHES["K2"], LAUNCHES["K3"]) == before


def _oracle_gate(settings, ticks, seed):
    """The bench's accuracy gate on the port: a TSmoothing-NONE engine's
    frame against the float64 oracle on the window in its ring, max |dB
    err| < 1e-4 on the bins above -120 dBFS."""
    cfg = resolve(settings, AudioInfo(SR, 2))
    eng = ServingEngine(cfg, 2, device="cpu")
    rng = np.random.default_rng(seed)
    for k in range(ticks):
        x = rng.uniform(-0.5, 0.5, (2, 2, HOP)).astype(np.float32)
        now = T0 + k * FRAME_NS
        eng.feed_batch(x, now, now_ns=now)
        eng.tick(now_ns=now)
    window = eng.ring.buf[0].numpy().astype(np.float64)
    want, _ = oracle.spectrum_frame(window, None, cfg, dt=1 / 60)
    got = eng.read_decibels()[0]
    vis = want > -120.0
    assert vis.sum() > min(1000, vis.size // 2)
    assert np.abs(got[vis] - want[vis]).max() < 1e-4


def test_slice_meets_oracle_gate():
    _oracle_gate(Settings(fft_size=4096, width=800, window=FFTWindow.HANN,
                          temporal_smoothing=TSmoothingMode.NONE), 8, 60)


@pytest.mark.parametrize("n,fused", [(800, None), (4096, "never")])
def test_packed_slice_meets_oracle_gate(n, fused, monkeypatch):
    """The packed pair end to end: N=800 through the lowering, N=4096 under
    ``WAVEFORM_TPU_EXACT_FUSED=never`` through K3's twin."""
    if fused:
        monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", fused)
    else:
        monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
    _oracle_gate(Settings(fft_size=n, width=800, window=FFTWindow.HANN,
                          temporal_smoothing=TSmoothingMode.NONE),
                 n // HOP + 2, 62)


def test_large_fft_slice_meets_oracle_gate():
    """N=16384 behind enable_large_fft, through K1-gen's twin (the JAX
    split rule gives 16384 the 2-factor body); the ring holds a
    whole window of noise after 21 hops."""
    settings = Settings(fft_size=16384, enable_large_fft=True, width=800,
                        window=FFTWindow.HANN,
                        temporal_smoothing=TSmoothingMode.NONE)
    assert resolve(settings, AudioInfo(SR, 2)).fft_size == 16384
    _oracle_gate(settings, 21, 61)


def test_cuda_engine_requires_a_card():
    cfg = resolve(Settings(fft_size=1024), AudioInfo(SR, 2))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, 2, device="cuda")


def test_rfft_fn_slice_matches_jax(kernel_on):
    """``ServingEngine(rfft_fn=torch.fft.rfft)`` against the JAX engine
    with ``jnp.fft.rfft``, with the exact backend and kernel set (which the
    override must beat): single ticks, then ``resized`` (which keeps the
    function), a k=2 microbatch flush and ``tick_many``, within
    :func:`_assert_same`'s bounds, and no exact kernel twin reached."""
    import jax.numpy as jnp
    cfg = resolve(Settings(fft_size=1024, width=300,
                           channel_mode=ChannelMode.STEREO),
                  AudioInfo(SR, 2))
    S = 3
    port = ServingEngine(cfg, S, rfft_fn=torch.fft.rfft, use_native=False,
                         device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, rfft_fn=jnp.fft.rfft, use_native=False)
    rng = np.random.default_rng(31)
    twins = (exact_cuda.rfft_pair_mag_ref, exact_cuda.rfft_pair_mag3_ref)

    def run(engines, ticks, k0):
        for k in range(k0, k0 + ticks):
            x = _audio(rng, engines[0].S, k, silent=[engines[0].S - 1])
            now = T0 + k * FRAME_NS
            for eng in engines:
                eng.feed_batch(x, now, now_ns=now)
                eng.tick(now_ns=now)
            _assert_same(*engines)

    import unittest.mock as mock
    with mock.patch.object(exact_cuda, "rfft_pair_mag_ref",
                           side_effect=AssertionError("exact twin ran")), \
            mock.patch.object(exact_cuda, "rfft_pair_mag3_ref",
                              side_effect=AssertionError("exact twin ran")):
        run([port, ref], 4, 0)
        port, ref = port.resized(4, keep=[0, 2]), ref.resized(4, keep=[0, 2])
        assert port._rfft_fn is torch.fft.rfft
        run([port, ref], 2, 4)
        new = _audio(rng, 8, 9).reshape(2, 4, 2, HOP)
        got = port.tick_many(new).numpy()
        want = np.asarray(ref.tick_many(new))
        vis = want > -120.0
        np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=1e-4)
    assert exact_cuda.rfft_pair_mag_ref is twins[0]
