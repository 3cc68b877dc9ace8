"""Exact-accumulation |rFFT|: df32 primitives and the channel pairing.

The PyTorch counterpart of the part of ``waveform_tpu/kernels/exactfft.py``
that the serving path runs.  Double-float (f32 hi/lo pair) arithmetic is
written without fma, one rounding per operation, exactly as the reference
writes it: PyTorch runs each of these element-wise operations as its own
kernel, so nothing contracts them.

The digit geometry is fixed: 4 digit planes of 7 bits, the first 6 bits
deep, and digit pairs with i + j <= 3 kept (``DIGIT_BITS``, ``FIRST_SHIFT``,
``MAX_T``).  The transform itself lives in :mod:`.exact_cuda`.
"""

from __future__ import annotations

import torch

DIGIT_BITS = 7
FIRST_SHIFT = 6
MAX_T = 3


def two_sum(a, b):
    """Knuth TwoSum: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _veltkamp_split(a):
    """a = hi + lo with 12-bit-mantissa halves (f32)."""
    t = 4097.0 * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """a * b = p + e exactly (Dekker via Veltkamp split)."""
    p = a * b
    ah, al = _veltkamp_split(a)
    bh, bl = _veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """(hi,lo) + (hi,lo) -> (hi,lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_mul(x, y):
    """(hi,lo) * (hi,lo) -> (hi,lo)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return two_sum(p, e)


def _windowed_df(x, w_hi, w_lo):
    """x * (w_hi + w_lo) as df32 (TwoProd + low-word correction)."""
    p, e = two_prod(x, w_hi)
    return two_sum(p, e + x * w_lo)


def rfft_mag_exact(x: torch.Tensor, window=None):
    """|rFFT| and the raw-sample nonzero predicate of [..., C, N] f32.

    Returns ``(mag [..., C, N/2] f32, nz [..., C] bool)``, bins in natural
    order.  Channels go through the pair kernel two at a time; a lone
    channel (mono capture, or the last of an odd count) rides it by pairing
    streams instead, with one zero row padding an odd stream count — the
    kernel treats its two rows as independent real transforms.
    """
    from .exact_cuda import rfft_pair_mag

    c, n = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    nbins = n // 2
    mags, nzs = [], []
    for i in range(0, c - 1, 2):
        m, nzc = rfft_pair_mag(
            x[..., i:i + 2, :].reshape(-1, 2, n).contiguous(), window)
        mags.append(m.reshape(*lead, 2, nbins))
        nzs.append(nzc.reshape(*lead, 2) > 0)
    if c % 2:
        flat = x[..., -1, :].reshape(-1, n)
        s_flat = flat.shape[0]
        if s_flat % 2:
            flat = torch.cat([flat, flat.new_zeros((1, n))])
        m, nzc = rfft_pair_mag(flat.reshape(-1, 2, n).contiguous(), window)
        mags.append(m.reshape(-1, nbins)[:s_flat].reshape(*lead, 1, nbins))
        nzs.append(nzc.reshape(-1)[:s_flat].reshape(*lead, 1) > 0)
    return torch.cat(mags, dim=-2), torch.cat(nzs, dim=-1)
