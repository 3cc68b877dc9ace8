"""The port's demo CLI (``waveform_tpu_torch/demo.py``) against the JAX
package's.

``read_wav`` must give the JAX reader's samples bit for bit at 16, 24 and
32 bits.  ``demo.main([..., "--device", "cpu"])`` and the JAX ``main``
run the same WAV (noise plus a tone, made with numpy) and the same OBS
settings JSON for a curve scene at N=4096, a level meter and a waveform,
both on the exact FFT backend: they must write the same PNG names, and
each frame must match within the renderer's tolerance
(``tests/test_torch_render.py``: 1e-6 on RGBA floats in [0, 1], which
after the 8-bit encode is at most one step of 255 where a value straddles
a rounding edge).

The JAX reference runs with each engine tick blocked to completion
(:func:`synchronous_reference`): ``waveform_tpu``'s ``WaveformEngine``
hands its host meter windows to an asynchronous jitted step through
``jnp.asarray``, which on the CPU aliases a 64-byte-aligned numpy array
instead of copying it, and the next tick's drain rewrites those windows
in place.  When the step runs late (a loaded machine) it reads the next
tick's samples, and the reference's meter moves by whole pixel rows.
The JAX ``ServingEngine`` fences the same hazard with its double-buffered
upload (``waveform_tpu/runtime/serving.py:369-385``); the meter tick does
not.
"""

import json
import os
import struct
import wave
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import waveform_tpu as jwt
import waveform_tpu_torch as wt
from waveform_tpu import demo as jdemo
from waveform_tpu.runtime import engine as jengine
from waveform_tpu.runtime import serving as jserving
from waveform_tpu_torch import demo
from waveform_tpu_torch.runtime.engine import WaveformEngine

SR = 48000


def _write_wav(path, x: np.ndarray, width: int) -> None:
    """[C, n] floats in [-1, 1] as little-endian PCM of ``width`` bytes."""
    scale = float(1 << (8 * width - 1))
    q = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64).T
    if width == 2:
        raw = q.astype("<i2").tobytes()
    elif width == 4:
        raw = q.astype("<i4").tobytes()
    else:
        b = np.ascontiguousarray(q, "<i4").view(np.uint8).reshape(
            *q.shape, 4)[..., :3]
        raw = b.tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(width)
        w.setframerate(SR)
        w.writeframes(raw)


def _noise(seconds: float, channels: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    x = 0.2 * rng.standard_normal((channels, t.size))
    x[0] += 0.3 * np.sin(2 * np.pi * 440.0 * t)
    return np.clip(x, -1.0, 1.0)


def read_png(path) -> np.ndarray:
    """RGBA8 [H, W, 4] of a PNG as ``render/image.write_png`` writes it
    (one IDAT stream, filter 0 on every row)."""
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 4)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_read_wav_matches_jax(width, channels, tmp_path):
    x = _noise(0.05, channels, seed=width)
    p = tmp_path / "t.wav"
    _write_wav(p, x, width)
    got, sr = demo.read_wav(str(p))
    want, jsr = jdemo.read_wav(str(p))
    assert sr == jsr == SR and got.shape == want.shape == x.shape
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # one quantization step, plus the f32 rounding of a 32-bit sample
    np.testing.assert_allclose(got, x, rtol=0,
                               atol=2.0 ** (1 - 8 * width) + 2.0 ** -24)


def synchronous_reference(monkeypatch) -> None:
    """Block every tick of the JAX reference's engines until its result is
    ready, so that a step reads the host inputs it was handed before the
    next tick rewrites them (see the module docstring)."""
    for cls in (jengine.WaveformEngine, jserving.ServingEngine):
        tick = cls.tick
        monkeypatch.setattr(cls, "tick", lambda self, *a, _t=tick, **k:
                            jax.block_until_ready(_t(self, *a, **k)))


SCENES = {
    "curve": {"display_mode": "curve", "fft_size": 4096},
    "level_meter": {"display_mode": "level_meter", "meter_buf": 100},
    "waveform": {"display_mode": "waveform"},
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_demo_matches_jax(scene, tmp_path, monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    synchronous_reference(monkeypatch)
    wav = tmp_path / "in.wav"
    _write_wav(wav, _noise(0.4), 2)
    sp = tmp_path / f"{scene}.json"
    sp.write_text(json.dumps(SCENES[scene]))
    args = [str(wav), "--settings", str(sp), "--max-frames", "20",
            "--every", "6"]
    out, jout = tmp_path / "port", tmp_path / "jax"
    assert demo.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    assert jdemo.main(args + ["--out", str(jout)]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jout))
    assert names == [f"frame_{k:06d}.png" for k in (6, 12, 18)]
    for name in names:
        got = read_png(out / name).astype(np.int16)
        want = read_png(jout / name).astype(np.int16)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name
        assert got[..., 3].any(), name         # something was drawn


def _aligned(shape, align: int = 64) -> np.ndarray:
    """A zeroed f32 array whose data starts on an ``align``-byte edge."""
    n = int(np.prod(shape))
    buf = np.zeros(n + align // 4, np.float32)
    off = (-buf.ctypes.data % align) // 4
    return buf[off:off + n].reshape(shape)


def _late(step, n: int = 1024, reps: int = 8):
    """``step`` jitted so that it reads the meter windows only after ``reps``
    [n, n] matmuls: a step that runs late, as one does on a loaded
    machine, while the dispatch returns at once."""
    def run(windows, *rest):
        a = jnp.full((n, n), 1.0 / n, jnp.float32)
        for _ in range(reps):
            a = a @ a
        return step(jnp.where(jnp.sum(a) > -1.0, windows, 0.0), *rest)
    return jax.jit(run)


def test_meter_reference_reads_its_own_window(monkeypatch):
    """The level-meter demo's minimal input (the scene's config, S=1, the
    test WAV's samples) with the reference's windows 64-byte aligned and
    its step late (``_late``): with the reference's ticks blocked, its meter
    matches the port's within 1e-5 dB after 12 ticks."""
    synchronous_reference(monkeypatch)
    x = np.round(_noise(0.4) * 32768).clip(-32768, 32767) / 32768.0
    x = x.astype(np.float32)
    jcfg = jwt.resolve(jwt.Settings(display_mode=jwt.DisplayMode.METER,
                                    meter_buf=100),
                       jwt.AudioInfo(SR, 2), jwt.VideoInfo(60.0))
    cfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER,
                                 meter_buf=100),
                     wt.AudioInfo(SR, 2), wt.VideoInfo(60.0))
    ref = jengine.WaveformEngine(jcfg, 1)
    ref._meter_windows = _aligned(ref._meter_windows.shape)
    assert ref._meter_windows.ctypes.data % 64 == 0
    ref._meter_step = _late(ref._meter_step)
    port = WaveformEngine(cfg, 1, device="cpu")
    NS, hop, now = 1_000_000_000, 800, 1_000_000_000
    for k in range(12):
        chunk = x[:, k * hop:(k + 1) * hop]
        ref.feed(0, chunk, now, now_ns=now)
        port.feed(0, chunk, now, now_ns=now)
        now += hop * NS // SR
        ref.tick(now_ns=now)
        port.tick(now_ns=now)
    # read once, at the end: a read blocks, as the demo's reads every 6th
    # tick do, and would hide the late reads in between
    np.testing.assert_allclose(port.render_values(), ref.render_values(),
                               rtol=0, atol=1e-5)
    assert np.isfinite(port.render_values()).all()


def test_demo_needs_a_card_unless_told(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wav = tmp_path / "in.wav"
    _write_wav(wav, _noise(0.1), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main([str(wav), "--out", str(tmp_path / "f")])
