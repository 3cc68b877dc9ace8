"""Exact-accumulation |rFFT|: df32 primitives, the digit lowering, routing.

The PyTorch counterpart of ``waveform_tpu/kernels/exactfft.py``.
Double-float (f32 hi/lo pair) arithmetic is written without fma, one
rounding per operation, exactly as the reference writes it: PyTorch runs
each of these element-wise operations as its own kernel, so nothing
contracts them.

The digit geometry is fixed: 4 digit planes of 7 bits, the first 6 bits
deep, and digit pairs with i + j <= 3 kept (``DIGIT_BITS``, ``FIRST_SHIFT``,
``MAX_T``).  Digit products run in float64, where every integer class sum
is exact (the reference's int32-accumulation branch: unlimited class
stacking, no chunk cascade).

Routing (:func:`rfft_mag_exact`), by size and the ``EXACT_KERNEL``,
``EXACT_FUSED`` and ``EXACT_PACKED`` gates as the JAX package routes: the
pair kernels K1/K2 when ``exact_cuda.kernel_would_run(n)``; otherwise,
under ``WAVEFORM_TPU_EXACT_PACKED=never`` and an even N2 factor, the
real-split lowering :func:`rfft_mag_real_lowering`; otherwise the
conjugate-symmetry packed pair through :func:`cfft_exact`, which runs K3
(``exact_cuda.cfft_exact_kernel``) when ``exact_cuda.supports_cfft(n)``
and the kernels are enabled (``WAVEFORM_TPU_EXACT_KERNEL`` is not
``never``), and the digit lowering here (plain torch ops on any device)
otherwise.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

DIGIT_BITS = 7
FIRST_SHIFT = 6
MAX_T = 3
N_DIGITS = MAX_T + 1

# fold the twiddle into per-k1 stage-2 constants while the folded tensor
# (N1 · (2 N2)^2 entries a plane) stays this small
_FOLD_LIMIT = 16 * 1024 * 1024
_CLAMP = 2.0 ** 63


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


def df_scale(x, s):
    """Multiply a df value by an exact power of two."""
    return (x[0] * s, x[1] * s)


def split_f64_df32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host f64 constant -> exact df32 (hi, lo) pair."""
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _windowed_df(x, w_hi, w_lo):
    """x * (w_hi + w_lo) as df32 (TwoProd + low-word correction)."""
    p, e = two_prod(x, w_hi)
    return two_sum(p, e + x * w_lo)


def _df_pair(z):
    """A df32 (hi, lo) pair as given, or an f32 tensor with a zero lo."""
    return z if isinstance(z, tuple) else (z, torch.zeros_like(z))


def _df_head(z, nbins):
    """First ``nbins`` of a df32 pair."""
    return tuple(a[..., :nbins] for a in z)


def _df_rev_head(z, nbins):
    """(Z[(N-k) mod N])[..., :nbins] = [Z_0, Z_{N-1}, .., Z_{N-nbins+1}]."""
    n = z[0].shape[-1]
    return tuple(torch.cat([a[..., :1], torch.flip(a[..., n - nbins + 1:],
                                                   dims=(-1,))], dim=-1)
                 for a in z)


def _df_mag(re, im):
    """sqrt(re^2 + im^2) in f32 from df32 parts.  The hi words clamp to
    ±2^63 first, so a corrupted buffer gives a huge but finite magnitude,
    not the NaN an overflowing square would."""
    rh = torch.clamp(re[0], -_CLAMP, _CLAMP)
    ih = torch.clamp(im[0], -_CLAMP, _CLAMP)
    rr = df_mul((rh, re[1]), (rh, re[1]))
    ii = df_mul((ih, im[1]), (ih, im[1]))
    s = df_add(rr, ii)
    return torch.sqrt(torch.clamp_min(s[0] + s[1], 0.0))


# ---------------------------------------------------------------------------
# digits
# ---------------------------------------------------------------------------

def _split_factors(n: int) -> tuple[int, int]:
    """N = N1·N2 with N1 the largest divisor <= sqrt(N)
    (``waveform_tpu/kernels/matfft.py:_split_factors``)."""
    best = (1, n)
    for n1 in range(1, math.isqrt(n) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


def _digit_planes(a64: np.ndarray) -> np.ndarray:
    """Offline f64 constant (|a| <= 1) -> N_DIGITS integer digit planes
    (f32 storage): digit k = rint(r·2^(6+7k)), r -= digit / 2^(6+7k)."""
    out = np.empty((N_DIGITS,) + a64.shape, np.float32)
    r = a64.astype(np.float64)
    for k in range(N_DIGITS):
        sc = 2.0 ** (FIRST_SHIFT + DIGIT_BITS * k)
        d = np.rint(r * sc)
        out[k] = d.astype(np.float32)
        r = r - d / sc
    return out


def _pow2_scale_block(hi: torch.Tensor) -> torch.Tensor:
    """The smallest power of two above max|hi| per batch element, over the
    last two (block) axes, from the exponent frexp returns: 2^e with
    max|hi| = f·2^e, f in [1/2, 1), e clipped to ±125; 1 where max|hi| is
    0 or NaN.  The kernels scale per lane instead
    (``exact_cuda._pow2_scale_lane``)."""
    m = torch.amax(torch.abs(hi), dim=(-2, -1), keepdim=True)
    _, e = torch.frexp(m)
    e = torch.clamp(e, -125, 125)
    s = ((e + 127) << 23).view(torch.float32)
    return torch.where(m > 0, s, torch.ones_like(s))


def _slice_df(hi: torch.Tensor, lo: torch.Tensor, s_inv: torch.Tensor):
    """Serial 4-digit slice of the df32 (hi, lo) scaled by the power of two
    ``s_inv``: digit k = round(r·2^(6+7k)) (half to even), r -= digit /
    2^(6+7k); the lo word joins the residual at k = 3.  Digits come back
    as float64 tensors for the exact products."""
    r = hi * s_inv
    digits = []
    for k in range(N_DIGITS):
        if k == 3:
            r = r + lo * s_inv
        sc = 2.0 ** (FIRST_SHIFT + DIGIT_BITS * k)
        d = torch.round(r * sc)
        digits.append(d.to(torch.float64))
        r = r - d / sc
    return digits


def _digit_gemm(product, planes, digits, scale):
    """Class sums S_t = Σ_{i<=t} product(planes[i], digits[t - i]), exact
    in float64, recombined with TwoSum: w_t = f32(S_t)·(2^-(12+7t)·scale),
    tail = (w3 + w2) + w1, TwoSum(w0, tail) -> df32 (hi, lo)."""
    w = []
    for t in range(N_DIGITS):
        s_t = sum(product(planes[i], digits[t - i]) for i in range(t + 1))
        w.append(s_t.to(torch.float32)
                 * (scale * 2.0 ** -(2 * FIRST_SHIFT + DIGIT_BITS * t)))
    return two_sum(w[0], (w[3] + w[2]) + w[1])


def _df_cmul(ar, ai, twr, twi):
    """The df32 complex product (ar + i·ai)·(twr + i·twi)."""
    br = df_add(df_mul(ar, twr), df_neg(df_mul(ai, twi)))
    bi = df_add(df_mul(ar, twi), df_mul(ai, twr))
    return br, bi


def _left(c, d):
    return c @ d


def _right(c, d):
    return d @ c


def _folded(g, d):
    return torch.einsum("knm,...kn->...km", g, d)


@functools.lru_cache(maxsize=16)
def _exact_plan(n: int):
    """Digit planes of the block-DFT matrices (host).

    Returns ``(n1, n2, f1_digits, stage2)``: ``stage2`` is
    ``("folded", g2b_digits)`` (the twiddle folded into per-k1 stage-2
    constants [N1, 2N2, 2N2]) while that stays under ``_FOLD_LIMIT``, else
    ``("twiddle", f2b_digits, (twr_hi, twr_lo), (twi_hi, twi_lo))``.
    """
    n1, n2 = _split_factors(n)
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    f1b = np.block([[f1.real, -f1.imag], [f1.imag, f1.real]])
    if n1 * (2 * n2) ** 2 <= _FOLD_LIMIT:
        g = tw[:, :, None] * f2[None, :, :]
        g2b = np.concatenate([
            np.concatenate([g.real, g.imag], axis=-1),
            np.concatenate([-g.imag, g.real], axis=-1)], axis=-2)
        return n1, n2, _digit_planes(f1b), ("folded", _digit_planes(g2b))
    f2b = np.block([[f2.real, f2.imag], [-f2.imag, f2.real]])
    return (n1, n2, _digit_planes(f1b),
            ("twiddle", _digit_planes(f2b), split_f64_df32(tw.real),
             split_f64_df32(tw.imag)))


def _plan_tensors(plan, device: torch.device):
    """A digit plan ``(n1, n2, f1_digits, stage2)`` (:func:`_exact_plan`,
    :func:`_real_split_plan`) as tensors on ``device``: digit planes in
    float64, twiddles as df32 pairs."""
    n1, n2, f1d, stage2 = plan

    def t(a, dtype=torch.float64):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    if stage2[0] == "folded":
        return n1, n2, t(f1d), ("folded", t(stage2[1]))
    _, f2d, twr, twi = stage2
    return (n1, n2, t(f1d),
            ("twiddle", t(f2d), tuple(t(a, torch.float32) for a in twr),
             tuple(t(a, torch.float32) for a in twi)))


@functools.lru_cache(maxsize=16)
def _exact_consts(n: int, device: torch.device):
    return _plan_tensors(_exact_plan(n), device)


def _digit_fft(x_hi, x_lo, n1: int, f1d, stage2):
    """The two digit stages both lowerings share, on df32 blocks (x_hi,
    x_lo) [..., R, N2]: one pow2 scale per block and stage
    (:func:`_pow2_scale_block`), serial slices, exact float64 digit
    products against ``f1d`` (rows [A_r; A_i], n1 each), TwoSum
    recombination, then the folded stage 2 or a df32 twiddle and the
    plain one.  Returns the df32 (c_hi, c_lo) [..., n1, columns of the
    stage-2 constants]."""
    s = _pow2_scale_block(x_hi)
    a_hi, a_lo = _digit_gemm(_left, f1d, _slice_df(x_hi, x_lo, 1.0 / s), s)
    ar = (a_hi[..., :n1, :], a_lo[..., :n1, :])
    ai = (a_hi[..., n1:, :], a_lo[..., n1:, :])

    if stage2[0] == "folded":
        f2d, product = stage2[1], _folded
        br, bi = ar, ai
    else:
        _, f2d, twr, twi = stage2
        product = _right
        br, bi = _df_cmul(ar, ai, twr, twi)

    # [C_r | C_i] = [B_r | B_i] @ F2 (per k1 row)
    b2_hi = torch.cat([br[0], bi[0]], dim=-1)
    b2_lo = torch.cat([br[1], bi[1]], dim=-1)
    s2 = _pow2_scale_block(b2_hi)
    return _digit_gemm(product, f2d, _slice_df(b2_hi, b2_lo, 1.0 / s2), s2)


def cfft_lowering(re, im):
    """The digit lowering of the exact complex FFT (the JAX package's XLA
    path, ``exactfft.cfft_exact`` below its kernel branch), in plain torch
    ops: 4-step N = N1·N2 (:func:`_split_factors`), one pow2 scale per
    batch element and stage (:func:`_pow2_scale_block`), serial slices,
    exact float64 digit products, TwoSum recombination, and either the
    folded stage 2 or a df32 twiddle then the plain one.

    ``re``/``im`` are f32 tensors [..., N] or df32 (hi, lo) pairs; returns
    ``((zr_hi, zr_lo), (zi_hi, zi_lo))`` [..., N], bins in natural order.
    """
    re, im = _df_pair(re), _df_pair(im)
    n = re[0].shape[-1]
    n1, n2, f1d, stage2 = _exact_consts(n, re[0].device)
    shp = re[0].shape[:-1]

    # [A_r; A_i] = F1b @ [x_r; x_i], then stage 2 over [B_r | B_i]
    x2_hi = torch.cat([re[0].reshape(*shp, n1, n2),
                       im[0].reshape(*shp, n1, n2)], dim=-2)
    x2_lo = torch.cat([re[1].reshape(*shp, n1, n2),
                       im[1].reshape(*shp, n1, n2)], dim=-2)
    c2 = _digit_fft(x2_hi, x2_lo, n1, f1d, stage2)

    # k = k1 + N1·k2: transpose (k1, k2) -> (k2, k1) and flatten
    def fin(a):
        return a.transpose(-1, -2).reshape(*shp, n)

    return ((fin(c2[0][..., :n2]), fin(c2[1][..., :n2])),
            (fin(c2[0][..., n2:]), fin(c2[1][..., n2:])))


def cfft_exact(re, im):
    """Complex FFT, last axis, df32 out: ``((zr_hi, zr_lo), (zi_hi,
    zi_lo))``.  ``re``/``im`` are f32 tensors or df32 (hi, lo) pairs.

    K3 (``exact_cuda.cfft_exact_kernel``) serves every size
    ``exact_cuda.supports_cfft`` admits while ``exact_cuda.enabled()``,
    :func:`cfft_lowering` the rest."""
    from .exact_cuda import cfft_exact_kernel, enabled, supports_cfft

    re, im = _df_pair(re), _df_pair(im)
    if supports_cfft(re[0].shape[-1]) and enabled():
        return cfft_exact_kernel(re, im)
    return cfft_lowering(re, im)


@functools.lru_cache(maxsize=16)
def _real_split_plan(n: int):
    """Digit planes of the real-split lowering (host), the JAX package's
    ``exactfft._real_split_plan``: stage 1 per channel against
    F1r = [Re f1; Im f1] [2N1, N1], stage 2 on the kept half-spectrum
    columns k2 < N2/2 only.

    Returns ``(n1, n2, f1r_digits, stage2)``: ``stage2`` is ``("folded",
    g2_digits)`` (the twiddle folded into per-k1 constants [N1, 2N2, N2])
    while that stays under ``_FOLD_LIMIT``, else ``("twiddle", f2k_digits,
    (twr_hi, twr_lo), (twi_hi, twi_lo))`` with f2k [2N2, N2]."""
    n1, n2 = _split_factors(n)
    if n2 % 2:
        raise ValueError(f"real-split needs an even N2 factor; {n} splits "
                         f"as {n1}x{n2}: use the packed pair")
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    f1r = np.concatenate([f1.real, f1.imag], axis=0)
    keep = n2 // 2
    if n1 * (2 * n2) * n2 <= _FOLD_LIMIT:
        g = tw[:, :, None] * f2[None, :, :keep]
        g2 = np.concatenate([
            np.concatenate([g.real, g.imag], axis=-1),
            np.concatenate([-g.imag, g.real], axis=-1)], axis=-2)
        return n1, n2, _digit_planes(f1r), ("folded", _digit_planes(g2))
    f2k = np.block([[f2.real[:, :keep], f2.imag[:, :keep]],
                    [-f2.imag[:, :keep], f2.real[:, :keep]]])
    return (n1, n2, _digit_planes(f1r),
            ("twiddle", _digit_planes(f2k), split_f64_df32(tw.real),
             split_f64_df32(tw.imag)))


@functools.lru_cache(maxsize=16)
def _real_split_consts(n: int, device: torch.device):
    return _plan_tensors(_real_split_plan(n), device)


def use_real_split(n: int) -> bool:
    """The JAX package's ``_use_real_split_xla(n)``:
    ``WAVEFORM_TPU_EXACT_PACKED=never`` (read at call time) sends the
    streams the pair kernel does not serve to :func:`rfft_mag_real_lowering`
    when N's split has an even N2 (odd N2, e.g. 336 = 16 x 21, stays on the
    packed pair)."""
    return (os.environ.get("WAVEFORM_TPU_EXACT_PACKED", "always") == "never"
            and _split_factors(n)[1] % 2 == 0)


def rfft_mag_real_lowering(x: torch.Tensor, window=None) -> torch.Tensor:
    """|rFFT| of [..., C, N] f32 raw channels through the real-split
    lowering, the JAX package's ``_rfft_mag_real_xla`` in torch ops: each
    channel an independent real-input transform (N = N1·N2 by
    :func:`_split_factors`), one pow2 scale per (batch, channel) block and
    stage (:func:`_pow2_scale_block`), serial slices, exact float64 digit
    products, TwoSum recombination, stage 2 on the kept half only (folded,
    or a df32 twiddle then the plain one), :func:`_df_mag`.  Returns
    ``mag [..., C, N/2]`` f32, bins in natural order; ``window`` is a
    (w_hi, w_lo) df32 pair of [N] tensors or None."""
    shp = x.shape[:-2]
    c, n = x.shape[-2], x.shape[-1]
    n1, n2, f1d, stage2 = _real_split_consts(n, x.device)
    keep = n2 // 2

    xb = x.reshape(*shp, c, n1, n2)
    if window is not None:
        hi, lo = _windowed_df(xb, window[0].reshape(n1, n2),
                              window[1].reshape(n1, n2))
    else:
        hi, lo = xb, torch.zeros_like(xb)

    # per-channel real-input DFT over block rows, kept-half stage 2
    c_hi, c_lo = _digit_fft(hi, lo, n1, f1d, stage2)
    mag = _df_mag((c_hi[..., :keep], c_lo[..., :keep]),
                  (c_hi[..., keep:], c_lo[..., keep:]))  # [..., C, n1, keep]
    # block coords -> flat bins k = k1 + n1·k2
    return mag.transpose(-1, -2).reshape(*shp, c, n // 2)


# ---------------------------------------------------------------------------
# |rFFT| of real channels
# ---------------------------------------------------------------------------

def check_rotated(n: int, head) -> None:
    """A rotating ring's rows (``head`` given) reach only the pair kernel,
    which reads them at their heads: raise ValueError where it does not
    serve ``n`` (``exact_cuda.kernel_would_run``).  An engine rotates its
    ring only where it does (``dsp/spectrum.reads_rotating_ring``), so
    this fails where the route changed after the engine was built."""
    from .exact_cuda import kernel_would_run

    if head is not None and not kernel_would_run(n):
        raise ValueError(
            f"a rotating ring's rows reach only the exact pair kernel, which "
            f"does not serve N={n} now: the FFT route changed after the "
            f"engine chose its ring's layout")


def rfft_pair_mag_exact(x: torch.Tensor, window=None, head=None):
    """|rFFT| and the raw-sample nonzero predicate of channel pairs
    [..., 2, N] f32: ``(mag [..., 2, N/2] f32, nz [..., 2] bool)``.

    The pair kernel (K1/K2) when ``exact_cuda.kernel_would_run(n)``;
    otherwise the real-split lowering when :func:`use_real_split`; otherwise
    the pair packs into one complex transform z = x0 + i·x1
    (:func:`cfft_exact`) and unpacks by conjugate symmetry on the kept
    bins.  ``head`` [..., 2] int32: the rows are a rotating ring's
    (``kernels/ring_cuda.py``), which only the pair kernel reads
    (:func:`check_rotated`)."""
    from .exact_cuda import kernel_would_run, rfft_pair_mag

    n = x.shape[-1]
    lead = x.shape[:-2]
    nbins = n // 2
    check_rotated(n, head)
    if kernel_would_run(n):
        m, nzc = rfft_pair_mag(
            x.reshape(-1, 2, n).contiguous(), window,
            None if head is None else head.reshape(-1, 2).contiguous())
        return m.reshape(*lead, 2, nbins), nzc.reshape(*lead, 2) > 0
    if use_real_split(n):
        return rfft_mag_real_lowering(x, window), torch.any(x != 0, dim=-1)
    x0, x1 = x[..., 0, :], x[..., 1, :]
    if window is not None:
        re = _windowed_df(x0, *window)
        im = _windowed_df(x1, *window)
    else:
        re, im = x0, x1
    zr, zi = cfft_exact(re, im)
    zr_h, zi_h = _df_head(zr, nbins), _df_head(zi, nbins)
    zrr, zir = _df_rev_head(zr, nbins), _df_rev_head(zi, nbins)
    x0r = df_scale(df_add(zr_h, zrr), 0.5)
    x0i = df_scale(df_add(zi_h, df_neg(zir)), 0.5)
    x1r = df_scale(df_add(zi_h, zir), 0.5)
    x1i = df_scale(df_add(zrr, df_neg(zr_h)), 0.5)
    mag = torch.stack([_df_mag(x0r, x0i), _df_mag(x1r, x1i)], dim=-2)
    return mag, torch.any(x != 0, dim=-1)


def rfft_mag_exact(x: torch.Tensor, window=None, head=None):
    """|rFFT| and the raw-sample nonzero predicate of [..., C, N] f32.

    Returns ``(mag [..., C, N/2] f32, nz [..., C] bool)``, bins in natural
    order.  ``window`` is a (w_hi, w_lo) df32 pair of [N] tensors or None.
    ``head`` [..., C] int32, or None: ``x`` is a rotating ring's buffer
    (``dsp/devring.py``), row r's sample j at ``(j + head[r]) mod N``,
    which the pair kernel reads in place (:func:`check_rotated`).
    Channels go through :func:`rfft_pair_mag_exact` two at a time.  A lone
    channel (mono capture, or the last of an odd count) rides the pair
    kernel by pairing streams when it runs, one zero row padding an odd
    stream count (the kernel's two rows are independent real transforms);
    otherwise it is the real part of one complex transform.  When the pair
    kernel does not run and :func:`use_real_split` holds, every channel
    goes through :func:`rfft_mag_real_lowering` at once instead.
    """
    from .exact_cuda import kernel_would_run, rfft_pair_mag

    c, n = x.shape[-2], x.shape[-1]
    check_rotated(n, head)
    if not kernel_would_run(n) and use_real_split(n):
        return rfft_mag_real_lowering(x, window), torch.any(x != 0, dim=-1)
    lead = x.shape[:-2]
    nbins = n // 2
    mags, nzs = [], []
    for i in range(0, c - 1, 2):
        m, nz = rfft_pair_mag_exact(
            x[..., i:i + 2, :], window,
            None if head is None else head[..., i:i + 2])
        mags.append(m)
        nzs.append(nz)
    if c % 2:
        xc = x[..., -1, :]
        if kernel_would_run(n):
            # rows of different streams pair up, each with its own head
            flat = xc.reshape(-1, n)
            hflat = None if head is None else head[..., -1].reshape(-1)
            s_flat = flat.shape[0]
            if s_flat % 2:
                flat = torch.cat([flat, flat.new_zeros((1, n))])
                if hflat is not None:
                    hflat = torch.cat([hflat, hflat.new_zeros(1)])
            m, nzc = rfft_pair_mag(
                flat.reshape(-1, 2, n).contiguous(), window,
                None if hflat is None else hflat.reshape(-1, 2).contiguous())
            mags.append(m.reshape(-1, nbins)[:s_flat]
                        .reshape(*lead, 1, nbins))
            nzs.append(nzc.reshape(-1)[:s_flat].reshape(*lead, 1) > 0)
        else:
            re = _windowed_df(xc, *window) if window is not None else xc
            zr, zi = cfft_exact(re, torch.zeros_like(xc))
            mags.append(_df_mag(_df_head(zr, nbins),
                                _df_head(zi, nbins))[..., None, :])
            nzs.append(torch.any(xc != 0, dim=-1)[..., None])
    return torch.cat(mags, dim=-2), torch.cat(nzs, dim=-1)
