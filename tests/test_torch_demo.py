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
"""

import json
import os
import struct
import wave
import zlib

import numpy as np
import pytest

from waveform_tpu import demo as jdemo
from waveform_tpu_torch import demo

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


SCENES = {
    "curve": {"display_mode": "curve", "fft_size": 4096},
    "level_meter": {"display_mode": "level_meter", "meter_buf": 100},
    "waveform": {"display_mode": "waveform"},
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_demo_matches_jax(scene, tmp_path, monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
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


def test_demo_needs_a_card_unless_told(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wav = tmp_path / "in.wav"
    _write_wav(wav, _noise(0.1), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main([str(wav), "--out", str(tmp_path / "f")])
