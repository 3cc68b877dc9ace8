"""Checkpoints of the port's engines against the JAX engine's files.

``save_state`` writes the JAX package's ``.npz`` (``leaf_i`` arrays, a
``__treedef__`` string; the spectrum engine's rings flat ``[S*C, L]``), so
a checkpoint saved by either package loads into the other.  Each case
ticks an engine on numpy-seeded packets under
``WAVEFORM_TPU_FFT_BACKEND=xla``, saves, loads into a fresh engine of
each package, and ticks both on: within 1e-4 dB (exactly where the
reference reads DB_MIN), latches exact.
"""

import numpy as np
import pytest
import torch

from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import AudioInfo, ChannelMode, Settings, resolve
from waveform_tpu_torch.dsp.devring import init_ring
from waveform_tpu_torch.runtime.serving import ServingEngine
from waveform_tpu_torch.utils.checkpoint import load_pytree, save_pytree

from test_torch_serving import _assert_same, _jax_cfg

SR, NS = 48000, 1_000_000_000


@pytest.fixture(autouse=True)
def xla_backend(monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")


def _cfg(fft_size=1024):
    return resolve(Settings(fft_size=fft_size, width=300,
                            normalize_volume=True,
                            channel_mode=ChannelMode.STEREO),
                   AudioInfo(SR, 2))


def _run(engines, S, rng, ticks, now):
    for _ in range(ticks):
        x = (0.4 * rng.standard_normal((S, 2, 480))).astype(np.float32)
        x[-1] = 0.0
        for eng in engines:
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
        now += 10_000_000
    return now


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_loads_across_packages(saver, tmp_path):
    """Save from one package, load into a fresh engine of each, tick on:
    the port equals the JAX engine continuing from the same file."""
    cfg = _cfg()
    S = 3
    rng = np.random.default_rng(51)
    src = (JaxEngine(_jax_cfg(cfg), S, use_native=False) if saver == "jax"
           else ServingEngine(cfg, S, use_native=False, device="cpu"))
    now = _run([src], S, rng, 5, NS)
    path = str(tmp_path / "state.npz")
    src.save_state(path)
    port = ServingEngine(cfg, S, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), S, use_native=False)
    ring0 = port.ring.buf
    for eng in (port, ref):
        eng.load_state(path)
    assert port.ring.buf is ring0                 # loaded in place
    np.testing.assert_array_equal(
        port.ring.buf.numpy().reshape(S * 2, -1), np.asarray(ref.ring.buf))
    np.testing.assert_array_equal(port.rms_ring.buf.numpy()[:, 0],
                                  np.asarray(ref.rms_ring.buf))
    np.testing.assert_array_equal(port.read_decibels(), ref.read_decibels())
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    _run([port, ref], S, rng, 3, now)
    _assert_same(port, ref)
    assert port.last_silent[-1]


def test_checkpoint_keep_migration_matches_jax(tmp_path):
    """``load_state(keep)`` into an engine of another stream count: row
    ``i`` takes checkpoint row ``keep[i]``, the rest keep their state; the
    JAX engine migrates the same rows."""
    cfg = _cfg()
    rng = np.random.default_rng(52)
    src = ServingEngine(cfg, 3, use_native=False, device="cpu")
    now = _run([src], 3, rng, 4, NS)
    path = str(tmp_path / "state.npz")
    src.save_state(path)
    port = ServingEngine(cfg, 4, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), 4, use_native=False)
    for eng in (port, ref):
        eng.load_state(path, keep=[2, 0])
    db = port.read_decibels()
    np.testing.assert_array_equal(db[:2], src.read_decibels()[[2, 0]])
    np.testing.assert_array_equal(port.ring.buf[:2].numpy(),
                                  src.ring.buf[[2, 0]].numpy())
    assert not port.ring.buf[2:].any()
    np.testing.assert_array_equal(db, ref.read_decibels())
    np.testing.assert_array_equal(port.last_silent, ref.last_silent)
    _run([port, ref], 4, rng, 2, now)
    _assert_same(port, ref)


@pytest.mark.parametrize("case", ["keep_range", "config", "streams"])
def test_checkpoint_errors_match_jax(case, tmp_path):
    """A keep index past the checkpoint's streams, a changed config under
    ``keep``, and a changed stream count without ``keep`` raise
    ValueError in both packages."""
    cfg = _cfg()
    path = str(tmp_path / "state.npz")
    ServingEngine(cfg, 3, use_native=False, device="cpu").save_state(path)
    keep = None
    if case == "keep_range":
        S, keep = 4, [0, 3]
    elif case == "config":
        cfg, S, keep = _cfg(fft_size=2048), 3, [0]
    else:
        S = 4
    engines = (ServingEngine(cfg, S, use_native=False, device="cpu"),
               JaxEngine(_jax_cfg(cfg), S, use_native=False))
    for eng in engines:
        with pytest.raises(ValueError):
            eng.load_state(path, keep=keep)


def test_ring_layouts_load_and_channel_guard(tmp_path):
    """A ring stored [S, C, L] (the JAX meter engine's layout) or flat
    [S*C, L] loads into the port's [S, C, L] ring; a mono 8-stream ring
    never loads into a stereo 4-stream one, though the element counts
    match."""
    rng = np.random.default_rng(53)
    ring = init_ring(4, 2, 16, device="cpu")
    ring.buf.copy_(torch.from_numpy(
        rng.standard_normal((4, 2, 16)).astype(np.float32)))
    for flat in (False, True):
        path = str(tmp_path / f"ring{flat}.npz")
        save_pytree(path, (ring,), flat_rings=flat)
        data = np.load(path)
        assert data["leaf_0"].shape == ((8, 16) if flat else (4, 2, 16))
        (back,) = load_pytree(path, (init_ring(4, 2, 16, device="cpu"),))
        assert torch.equal(back.buf, ring.buf)
    mono = init_ring(8, 1, 16, device="cpu")
    path = str(tmp_path / "mono.npz")
    save_pytree(path, (mono,))
    with pytest.raises(ValueError):
        load_pytree(path, (init_ring(4, 2, 16, device="cpu"),))
