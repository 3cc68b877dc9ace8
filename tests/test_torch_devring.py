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
