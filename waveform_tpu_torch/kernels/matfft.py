"""GEMM FFT: the transform as two full-f32 matrix products.

The PyTorch counterpart of ``waveform_tpu/kernels/matfft.py``, the
``matmul`` FFT backend.  The 4-step Cooley-Tukey factorization
N = N1·N2 runs as two real matrix products and a twiddle multiply:

    x[n1,n2] --F1[N1,N1]--> A[k1,n2] --·W_N^{n2·k1}--> B --F2[N2,N2]--> X

with complex arithmetic as 2×2 real blocks ([[Re,-Im],[Im,Re]]).  Real
input rides the two-channels-in-one-complex-FFT packing (z = ch0 + i·ch1,
unpacked by conjugate symmetry).

The JAX package computes these products as ``precision="highest"``
einsums in XLA, outside any Pallas kernel; here they are ``torch.mm``
calls (cuBLAS on the card), each one 2-D product over every batch row at
once.  They must run in full float32: TF32 would drop ~13 mantissa bits,
so :func:`cfft` refuses a reduced matmul precision
(``rebin/apply.check_full_f32_matmul``).  Accumulation in plain f32 is
what bounds the accuracy (the JAX package documents ~1e-4 to 1e-3 dB at
deep spectral nulls); the exact backend (``kernels/exactfft.py``) is the
one held to 1e-4 dB.  ``precise=True`` adds the double-float residuals of
the constants, which does not touch the accumulation error.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..rebin.apply import _rows_mm, check_full_f32_matmul


def _split_factors(n: int) -> tuple[int, int]:
    """N = N1·N2 with N1 ≈ N2, N1 <= N2."""
    best = (1, n)
    for n1 in range(1, int(math.isqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


def _split_f32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Double-float split: a ≈ hi + lo with hi = f32(a), lo = f32(a - hi)."""
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


@lru_cache(maxsize=32)
def _plan(n: int):
    """Host-precomputed block-DFT matrices and twiddles (float64 rounded
    to float32, with the double-float residuals for ``precise``)."""
    n1, n2 = _split_factors(n)
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    # left block [[Re,-Im],[Im,Re]]: [ar; ai] = F1b @ [xr; xi]
    f1b = np.block([[f1.real, -f1.imag], [f1.imag, f1.real]])
    # right block for row-vector multiply: [cr, ci] = [br, bi] @ F2b
    f2b = np.block([[f2.real, f2.imag], [-f2.imag, f2.real]])
    return (n1, n2, _split_f32(f1b), _split_f32(f2b),
            _split_f32(tw.real), _split_f32(tw.imag))


@lru_cache(maxsize=32)
def _plan_tensors(n: int, device: torch.device):
    """:func:`_plan` on ``device``: F1bᵀ (the step-1 product runs with the
    batch on the rows), F2b and the twiddles, each a (hi, lo) pair."""
    n1, n2, f1b, f2b, twr, twi = _plan(n)

    def dev(pair, transpose=False):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            a.T if transpose else a)).to(device) for a in pair)

    return n1, n2, dev(f1b, True), dev(f2b), dev(twr), dev(twi)


def cfft(re: torch.Tensor, im: torch.Tensor,
         precise: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex FFT over the last axis via two block products; [..., N]
    f32 in, (re, im) [..., N] f32 out, bins in natural order.

    ``precise=True`` adds one product against each constant's
    double-float residual; the accumulation error, which dominates, is
    unchanged."""
    check_full_f32_matmul("the matmul FFT")
    n = re.shape[-1]
    lead = re.shape[:-1]
    n1, n2, (f1t, f1t_lo), (f2b, f2b_lo), (twr, twr_lo), (twi, twi_lo) = \
        _plan_tensors(n, re.device)

    # step 1: [A_r; A_i] = F1b @ [x_r; x_i], run as [x_r; x_i]ᵀ @ F1bᵀ so
    # that every (batch, n2) column is a row of one product
    x2 = torch.cat([re.reshape(*lead, n1, n2), im.reshape(*lead, n1, n2)],
                   dim=-2).transpose(-1, -2)                # [..., N2, 2N1]
    a2 = _rows_mm(x2, f1t)
    if precise:
        a2 = a2 + _rows_mm(x2, f1t_lo)
    a2 = a2.transpose(-1, -2)                               # [..., 2N1, N2]
    ar, ai = a2[..., :n1, :], a2[..., n1:, :]

    # step 2: twiddle B = A · W_N^{k1·n2}
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    if precise:
        br = br + (ar * twr_lo - ai * twi_lo)
        bi = bi + (ar * twi_lo + ai * twr_lo)

    # step 3: [C_r, C_i] = [B_r, B_i] @ F2b
    b2 = torch.cat([br, bi], dim=-1)                        # [..., N1, 2N2]
    c2 = _rows_mm(b2, f2b)
    if precise:
        c2 = c2 + _rows_mm(b2, f2b_lo)
    cr, ci = c2[..., :n2], c2[..., n2:]

    # output index k = k1 + N1·k2: transpose (k2, k1) then flatten
    zr = cr.transpose(-1, -2).reshape(*lead, n)
    zi = ci.transpose(-1, -2).reshape(*lead, n)
    return zr, zi


def rfft_pair_mag(x: torch.Tensor, nbins: int | None = None,
                  precise: bool = False) -> torch.Tensor:
    """|rFFT| of a channel pair via one packed complex FFT.

    ``x`` is [..., 2, N] float32; returns magnitudes [..., 2, nbins]
    (default N//2, the reference's kept bins).

    z = x0 + i·x1 ⇒ X0[k] = (Z[k]+conj(Z[N-k]))/2,
                    X1[k] = (Z[k]-conj(Z[N-k]))/(2i).
    """
    n = x.shape[-1]
    nbins = n // 2 if nbins is None else nbins
    zr, zi = cfft(x[..., 0, :], x[..., 1, :], precise=precise)
    # Z[(N-k) mod N] = reverse-roll
    zrr = torch.roll(zr.flip(-1), 1, dims=-1)
    zir = torch.roll(zi.flip(-1), 1, dims=-1)
    x0r = 0.5 * (zr + zrr)
    x0i = 0.5 * (zi - zir)
    x1r = 0.5 * (zi + zir)
    x1i = 0.5 * (zrr - zr)
    mag0 = torch.sqrt(x0r * x0r + x0i * x0i)[..., :nbins]
    mag1 = torch.sqrt(x1r * x1r + x1i * x1i)[..., :nbins]
    return torch.stack([mag0, mag1], dim=-2)


def rfft_real(x: torch.Tensor,
              precise: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """rFFT of real input: (re, im) each [..., N//2+1].  Pairs of
    channels should prefer :func:`rfft_pair_mag`."""
    n = x.shape[-1]
    zr, zi = cfft(x, torch.zeros_like(x), precise=precise)
    return zr[..., :n // 2 + 1], zi[..., :n // 2 + 1]


def rfft_mag(x: torch.Tensor, nbins: int | None = None,
             precise: bool = False) -> torch.Tensor:
    """|rFFT| for any channel count, [..., C, N] → [..., C, nbins].

    Channels pair up through :func:`rfft_pair_mag`; an odd last channel
    takes a transform with a zero imaginary part."""
    c, n = x.shape[-2], x.shape[-1]
    nbins = n // 2 if nbins is None else nbins
    outs = []
    for i in range(0, c - 1, 2):
        outs.append(rfft_pair_mag(x[..., i:i + 2, :], nbins, precise=precise))
    if c % 2:
        zr, zi = cfft(x[..., -1, :], torch.zeros_like(x[..., -1, :]),
                      precise=precise)
        m = torch.sqrt(zr * zr + zi * zi)[..., :nbins]
        outs.append(m[..., None, :])
    return torch.cat(outs, dim=-2)
