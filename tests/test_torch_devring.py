"""Device ring push of the PyTorch port: bit-equal to the JAX ring."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu.dsp import devring as jring
from waveform_tpu_torch.dsp import devring as tring

S, C, L, H = 3, 2, 64, 20


def _rings(rng, flat):
    buf = rng.standard_normal((S, C, L)).astype(np.float32)
    ref = jring.init_ring(S, C, L, flat=flat)
    ref = jring.DeviceRing(buf=jnp.asarray(buf.reshape(ref.buf.shape)),
                           channels=ref.channels)
    return ref, tring.ring_from_numpy(buf, device="cpu")


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("count", [0, 1, 13, H, H + 5])
def test_scalar_push_matches_jax(count, flat):
    rng = np.random.default_rng(count + 100 * flat)
    ref, ring = _rings(rng, flat)
    new = rng.standard_normal((S, C, H)).astype(np.float32)
    out = tring.push(ring, torch.from_numpy(new), count)
    want = jring.push(ref, jnp.asarray(new), jnp.int32(count)).view3
    assert out is ring
    np.testing.assert_array_equal(ring.buf.numpy(), np.asarray(want))


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("count", [0, 1, 13, H, H + 5])
def test_device_count_push_matches_jax(count, flat):
    """The uniform push with its count as a 0-d tensor on the ring's device
    (the form a captured graph replays): the JAX scalar push's window,
    clamped to H on the device, and the host-int push's bits."""
    rng = np.random.default_rng(count + 50 + 100 * flat)
    ref, ring = _rings(rng, flat)
    host = tring.ring_from_numpy(ring.buf.numpy(), device="cpu")
    new = rng.standard_normal((S, C, H)).astype(np.float32)
    buf0 = ring.buf
    out = tring.push(ring, torch.from_numpy(new),
                     torch.tensor(count, dtype=torch.int64))
    want = jring.push(ref, jnp.asarray(new), jnp.int32(count)).view3
    assert out is ring and ring.buf is buf0
    np.testing.assert_array_equal(ring.buf.numpy(), np.asarray(want))
    tring.push(host, torch.from_numpy(new), count)
    assert torch.equal(ring.buf, host.buf)


@pytest.mark.parametrize("flat", [False, True])
def test_per_stream_push_matches_jax(flat):
    rng = np.random.default_rng(7)
    ref, ring = _rings(rng, flat)
    buf0 = ring.buf
    for counts in ([0, 7, H], [H + 4, 1, 19], [3, 0, 5]):
        new = rng.standard_normal((S, C, H)).astype(np.float32)
        tring.push(ring, torch.from_numpy(new),
                   torch.tensor(counts, dtype=torch.int32))
        ref = jring.push(ref, jnp.asarray(new),
                         jnp.asarray(counts, jnp.int32))
        np.testing.assert_array_equal(ring.buf.numpy(),
                                      np.asarray(ref.view3))
    assert ring.buf is buf0            # updated in place


def test_init_ring_is_zero_and_contiguous():
    ring = tring.init_ring(S, C, L, device="cpu")
    assert ring.buf.shape == (S, C, L) and ring.buf.is_contiguous()
    assert ring.buf.dtype == torch.float32 and not ring.buf.any()


# -- the rotating ring: its window in order against the JAX ring ----------

def _counts(form, count, step):
    """Push ``step``'s counts in ``form``: a host int, a 0-d tensor (the
    batch shift a captured graph replays) or an [S] tensor (the gather);
    the per-stream counts differ from stream to stream."""
    if form == "host":
        return count, jnp.int32(count)
    if form == "device":
        return (torch.tensor(count, dtype=torch.int64), jnp.int32(count))
    per = [(count + 7 * s + step) % (H + 6) for s in range(S)]
    return (torch.tensor(per, dtype=torch.int32),
            jnp.asarray(per, jnp.int32))


@pytest.mark.parametrize("form", ["host", "device", "per_stream"])
@pytest.mark.parametrize("count", [0, 1, 13, H, H + 5])
def test_rotating_push_window_matches_jax(count, form):
    """Eight pushes into a rotating ring (the heads wrap past L): after
    each, its window in order equals the JAX ring's bit for bit, the
    buffer and the heads are updated in place and every head lies in
    [0, L)."""
    rng = np.random.default_rng(count + 1000 * len(form))
    ref, shifted = _rings(rng, False)
    ring = tring.init_ring(S, C, L, device="cpu", rotating=True)
    tring.set_window(ring, shifted.buf)
    buf0, head0 = ring.buf, ring.head
    for step in range(8):
        new = rng.standard_normal((S, C, H)).astype(np.float32)
        ours, theirs = _counts(form, count, step)
        out = tring.push_rotating(ring, torch.from_numpy(new), ours)
        ref = jring.push(ref, jnp.asarray(new), theirs)
        assert out is ring and ring.buf is buf0 and ring.head is head0
        np.testing.assert_array_equal(tring.window(ring).numpy(),
                                      np.asarray(ref.view3))
        assert ((ring.head >= 0) & (ring.head < L)).all()
    assert count in (0, H + 5) or ring.head.any()


@pytest.mark.parametrize("form", ["host", "device", "per_stream"])
def test_rotating_push_longer_than_the_window(form):
    """A hop budget past L: a count above L keeps its last L samples, as
    the shifting ring does."""
    s, c, l, h = 2, 1, 16, 40
    rng = np.random.default_rng(5)
    shifted = tring.init_ring(s, c, l, device="cpu")
    ring = tring.init_ring(s, c, l, device="cpu", rotating=True)
    for count in (35, 3, 40, 17):
        new = torch.from_numpy(rng.standard_normal((s, c, h))
                               .astype(np.float32))
        counts = {"host": count,
                  "device": torch.tensor(count, dtype=torch.int64),
                  "per_stream": torch.tensor([count, h - count])}[form]
        tring.push(shifted, new, counts)
        tring.push_rotating(ring, new, counts)
        assert torch.equal(tring.window(ring), shifted.buf)


def test_window_and_set_window():
    """``window`` of a rotating ring is its buffer put in order at its
    heads, a new tensor; of a shifting ring, the buffer itself;
    ``set_window`` writes the windows in order and zeroes the heads, so
    the pushes after it continue from the windows written."""
    rng = np.random.default_rng(9)
    ring = tring.init_ring(S, C, L, device="cpu", rotating=True)
    for count in (13, 20, 7, 19):
        tring.push_rotating(ring, torch.from_numpy(
            rng.standard_normal((S, C, H)).astype(np.float32)), count)
    assert ring.head.any()
    want = torch.stack([torch.roll(ring.buf[:, c], -int(ring.head[0, c]),
                                   dims=-1) for c in range(C)], dim=1)
    assert ring.head.eq(ring.head[:, :1]).all()
    got = tring.window(ring)
    assert got.data_ptr() != ring.buf.data_ptr() and torch.equal(got, want)
    shifted = tring.init_ring(S, C, L, device="cpu")
    assert tring.window(shifted) is shifted.buf
    tring.set_window(ring, want)
    tring.set_window(shifted, want)
    assert not ring.head.any() and torch.equal(ring.buf, want)
    new = torch.from_numpy(rng.standard_normal((S, C, H)).astype(np.float32))
    tring.push_rotating(ring, new, 11)
    tring.push(shifted, new, 11)
    assert torch.equal(tring.window(ring), shifted.buf)
