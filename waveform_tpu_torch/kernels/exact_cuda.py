"""Exact FFT kernels: the Hopper kernels, their plain twins, the build.

The PyTorch counterpart of ``waveform_tpu/kernels/exact_pallas.py``: its
routing predicates (:func:`stage1_split`, :func:`supports`,
:func:`supports_cfft`, :func:`enabled`, :func:`kernel_would_run`,
:func:`twiddle_tier`), the real-split magnitude kernels K1
(``_kernel_real_mag``, 2-factor stage 1) and K2 (``_kernel_real_mag3``,
3-factor stage 1: a df32 radix-4 butterfly, then two twiddle-folded DFT_a
digit GEMMs) at both twiddle tiers, and the complex df32 kernel K3
(``_kernel``).  K1's body is K1-gen (``csrc/exact_mag_gen.cu``, two
launches) at every N1 % 8 == 0 up to 256, and its df instance K1-df at the
df tier.  K2 and K2-df share ``csrc/exact_mag3.cu``.  Every kernel runs
its digit GEMMs on the int8 tensor cores.  Entry points:
:func:`rfft_pair_mag` (routed by :func:`stage1_split` and
:func:`twiddle_tier` as the JAX package routes) and
:func:`cfft_exact_kernel` (K3).

* a CUDA tensor launches the hand-written kernel,
  ``csrc/exact_mag_gen.cu`` (K1-gen, K1-df), ``csrc/exact_mag3.cu`` (K2,
  K2-df) or ``csrc/exact_cfft.cu`` (K3), built with ``nvcc`` at first use
  into ``build/waveform_tpu_torch/`` and bound with ``ctypes``; a build or
  launch failure raises;
* a CPU tensor runs the twin, :func:`rfft_pair_mag_ref` (K1-gen),
  :func:`rfft_pair_mag_df_ref` (K1-df), :func:`rfft_pair_mag3_ref`,
  :func:`rfft_pair_mag3_df_ref` or :func:`cfft_exact_ref`: the same
  arithmetic in torch ops (digit products in float64, exact because every
  integer partial sum stays far below 2^53).

Each kernel and its twin take the same rounding steps in the same order,
so they agree bit for bit.  Bins come out in natural order.

Geometry: N = 128·N1 (j = 128·j1 + j2, k = k1 + N1·k2), 4 base-2^7 digit
planes with the first 6 bits deep, digit pairs with i + j <= 3 kept
(``exactfft.DIGIT_BITS/FIRST_SHIFT/MAX_T``).  K2 splits N1 = 4a
(j1 = jq·a + jp, k1 = kq + 4·kp) and produces its rows chunk-major
(pos = kq·a + kp).

Scale rule: K1-gen takes one pow2 scale per (stream, j2) column
over both channels; K2 one per (stream, channel, j2) column, for
U02 = [u0; u2] and U13 = [u1; u3] separately, as ``_kernel_real_mag3``
does; K3 one per (stream, j2) column over [x_r; x_i] in stage 1 and one
per (stream, k1) row over [b_r | b_i] in stage 2.  The df tier keeps each
body's rule.  Twiddle tiers (``_twiddle_choice``): at the f32 tier K1-gen
and K2 slice with the fast fixed-point extract, sum their digit
classes in plain f32, multiply the twiddle with single roundings and
square in f32; at the df tier they slice serially, recombine with TwoSum,
multiply the twiddle as Dekker df32 products and take ``_tail_stage2``'s
df magnitude.  K3 always runs the df arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .exactfft import (_CLAMP, DIGIT_BITS, FIRST_SHIFT, N_DIGITS,
                       _df_cmul, _df_pair, _digit_gemm, _digit_planes, _left,
                       _right, _slice_df, _windowed_df, df_add, df_mul, df_neg,
                       two_sum)

LANES = 128                     # N2: the stage-2 transform length
SIZES3 = (8192, 16384, 32768, 65536)   # the K2 sizes the JAX plan ships
MAX_N2 = 32768                  # K1-gen and K3 serve N1 % 8 == 0 up to here
MAX_N3 = 65536                  # K2 serves N1 % 32 == 0 up to here
K2_CONSTS = ("c02f", "c13f", "f2b")   # K2's constants, in its C order
K1GEN_CONSTS = ("f1f", "f2b")         # K1-gen's and K1-df's
K3_CONSTS = ("f1f", "f2b", "tw")      # K3's

# fixed-point geometry of the parallel digit extraction: i = rint(r·2^27)
# splits into 4 offset-binary base-128 fields
_SLICE_TOP = FIRST_SHIFT + (N_DIGITS - 1) * DIGIT_BITS            # 27
_SLICE_BIAS = sum(64 << (_SLICE_TOP - FIRST_SHIFT - DIGIT_BITS * k)
                  for k in range(N_DIGITS))

# counts of kernel launches (not of twin calls), K2, K3, K1-gen, K1-df and
# K2-df apart: a run reads them to show that its main path went through
# the kernel it expects
launches3 = 0
launches_cfft = 0
launches_gen = 0
launches_gen_df = 0
launches3_df = 0

TIERS = ("f32", "df")


# ---------------------------------------------------------------------------
# routing: the JAX package's predicates
# ---------------------------------------------------------------------------

def stage1_split(n: int) -> int:
    """``exact_pallas._stage1_split(n)`` without the v5e plan table (which
    never applies on this card): ``WAVEFORM_TPU_STAGE1_SPLIT`` in
    {"2", "3"} (read at call time) wins, else 3 from N = 32768 up and 2
    below.  Split 2 is K1's body (K1-gen), split 3 K2's."""
    mode = os.environ.get("WAVEFORM_TPU_STAGE1_SPLIT", "auto")
    if mode in ("2", "3"):
        return int(mode)
    return 3 if n >= 32768 else 2


def supports(n: int) -> bool:
    """``exact_pallas.supports(n)``: the pair-kernel geometry, N1 = n/128 a
    multiple of 8, and the split's own bound: split 2 up to N = 32768,
    split 3 with N1 % 32 == 0 up to 65536."""
    n1, rem = divmod(n, LANES)
    if rem or n1 % 8:
        return False
    if stage1_split(n) == 2:
        return n <= MAX_N2
    return n1 % 32 == 0 and n <= MAX_N3


def _two_factor(n: int) -> bool:
    """The 2-factor geometry of K1-gen and K3: N1 = n/128 a multiple of 8,
    N <= 32768."""
    n1, rem = divmod(n, LANES)
    return rem == 0 and n1 % 8 == 0 and 0 < n <= MAX_N2


def supports_cfft(n: int) -> bool:
    """``exact_pallas.supports_cfft(n)``: K3 runs the 2-factor stage 1,
    N1 % 8 == 0 up to N = 32768."""
    return _two_factor(n)


def enabled() -> bool:
    """``exact_pallas.enabled()`` on this card: the kernels run unless
    ``WAVEFORM_TPU_EXACT_KERNEL=never`` (read at call time) sends every
    size to the digit lowering (``exactfft``); ``auto`` and ``always``
    keep them on."""
    return os.environ.get("WAVEFORM_TPU_EXACT_KERNEL", "auto") != "never"


def kernel_would_run(n: int) -> bool:
    """``exact_pallas.kernel_would_run(n)``: the pair kernel serves ``n``
    unless :func:`enabled` is False or ``WAVEFORM_TPU_EXACT_FUSED=never``
    (read at call time) routes the stream to the packed pair
    (``exactfft.rfft_pair_mag_exact``)."""
    return (supports(n) and enabled()
            and os.environ.get("WAVEFORM_TPU_EXACT_FUSED", "auto") != "never")


def twiddle_tier() -> str:
    """``exact_pallas._twiddle_choice()``: the accuracy tier of K1's body
    and K2, ``WAVEFORM_TPU_KERNEL_TWIDDLE`` read at call time: "df" (the
    compensated serial slice, TwoSum recombination, Dekker twiddle and df
    magnitude) or "f32" (the default; any other value gives it too)."""
    env = os.environ.get("WAVEFORM_TPU_KERNEL_TWIDDLE")
    return env if env in TIERS else "f32"


def _tier(twiddle: str | None) -> str:
    """An entry point's ``twiddle`` argument: None reads the environment
    (:func:`twiddle_tier`), else it must name a tier."""
    if twiddle is None:
        return twiddle_tier()
    if twiddle not in TIERS:
        raise ValueError(f"twiddle must be one of {TIERS} or None, got "
                         f"{twiddle!r}")
    return twiddle


# ---------------------------------------------------------------------------
# host plan: the same numpy builders as exact_pallas
# ---------------------------------------------------------------------------

def _vsplit_host(a_f32: np.ndarray) -> np.ndarray:
    """Veltkamp-high half of an f32 array, in f32 arithmetic."""
    c = np.float32(4097.0)
    t = (c * a_f32).astype(np.float32)
    return (t - (t - a_f32).astype(np.float32)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_plan_real(n: int):
    """Constants of the real-split transform at size ``n``.

    Returns ``(n1, n2, f1d, f2d, twr_hi, twr_lo, twi_hi, twi_lo, twr_h,
    twi_h)``: ``f1d`` [4, 2n1, n1] digit planes of F1r = [Re f1; Im f1]
    (stage 1 per channel, contracting j1), ``f2d`` [4, 2n2, n2] digit
    planes of the kept-half stage-2 block [[Re f2, Im f2], [-Im f2, Re f2]]
    restricted to k2 < n2/2, the outer twiddle exp(-2πi·k1·j2/n) [n1, n2]
    as a df32 pair, and the Veltkamp-high halves of its hi words.  The f32
    twiddle tier reads ``twr_hi``/``twi_hi`` only; the df tier reads all
    six.
    """
    n1, n2 = n // LANES, LANES
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f1r = np.concatenate([f1.real, f1.imag], axis=0)          # [2n1, n1]
    return (n1, n2, _digit_planes(f1r), _f2_kept_planes(),
            *_twiddle_df(np.arange(n1), n))


def _f2_kept_planes() -> np.ndarray:
    """Digit planes [4, 2n2, n2] of the kept-half stage-2 block
    [[Re f2, Im f2], [-Im f2, Re f2]] restricted to k2 < n2/2."""
    n2, keep = LANES, LANES // 2
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    return _digit_planes(np.block([[f2.real[:, :keep], f2.imag[:, :keep]],
                                   [-f2.imag[:, :keep], f2.real[:, :keep]]]))


def _twiddle_df(k1_rows: np.ndarray, n: int):
    """The outer twiddle exp(-2πi·k1·j2/n) for rows ``k1_rows`` as
    (twr_hi, twr_lo, twi_hi, twi_lo, twr_h, twi_h): df32 pairs and the
    Veltkamp-high halves of the hi words."""
    tw = np.exp(-2j * np.pi * np.outer(k1_rows, np.arange(LANES)) / n)
    twr_hi = tw.real.astype(np.float32)
    twi_hi = tw.imag.astype(np.float32)
    twr_lo = (tw.real - twr_hi.astype(np.float64)).astype(np.float32)
    twi_lo = (tw.imag - twi_hi.astype(np.float64)).astype(np.float32)
    return (twr_hi, twr_lo, twi_hi, twi_lo,
            _vsplit_host(twr_hi), _vsplit_host(twi_hi))


def _row_unscramble(n: int) -> np.ndarray:
    """pos(k1) of K2's chunk-major rows: natural k1 lives at row
    (k1 % 4)·a + k1 // 4."""
    n1 = n // LANES
    k1 = np.arange(n1)
    return (k1 % 4) * (n1 // 4) + k1 // 4


@functools.lru_cache(maxsize=8)
def _kernel_plan_real3(n: int):
    """Constants of the 3-factor real-split transform at size ``n``.

    Returns ``(n1, n2, a, c02d, c13d, f2d, twr_hi, twr_lo, twi_hi, twi_lo,
    twr_h, twi_h)``: ``c02d``/``c13d`` [4, 4a, 2a] digit planes of the
    twiddle-folded DFT_a blocks (pair (0, 2) maps [u0; u2] to
    [A0r; A0i; A2r; A2i], pair (1, 3) maps [u1; u3] to [A1r; A1i; A3r;
    A3i]), ``f2d`` as in :func:`_kernel_plan_real`, and the outer twiddle
    with its rows in chunk-major order (pos = kq·a + kp holds
    k1 = kq + 4·kp).
    """
    n1, n2 = n // LANES, LANES
    a = n1 // 4
    fa = np.exp(-2j * np.pi * np.outer(np.arange(a), np.arange(a)) / a)
    g = [fa * np.exp(-2j * np.pi * np.arange(a) * kq / n1)[None, :]
         for kq in range(4)]
    c02 = np.block([[g[0].real, g[0].real],
                    [g[0].imag, g[0].imag],
                    [g[2].real, -g[2].real],
                    [g[2].imag, -g[2].imag]])
    c13 = np.block([[g[1].real, g[1].imag],
                    [g[1].imag, -g[1].real],
                    [g[3].real, -g[3].imag],
                    [g[3].imag, g[3].real]])
    k1_of_pos = np.arange(n1) // a + 4 * (np.arange(n1) % a)
    return (n1, n2, a, _digit_planes(c02), _digit_planes(c13),
            _f2_kept_planes(), *_twiddle_df(k1_of_pos, n))


@functools.lru_cache(maxsize=16)
def _consts(n: int, device: torch.device):
    """K1's plan as tensors on ``device``: the digit planes as float64
    matrices (``f1``, ``f2``) for the twin's exact products, and for
    K1-gen's tensor cores ``f1f`` (:func:`_frag_a1`) and ``f2b``
    (:func:`_frag_b2`), the digit words in the fragment order of stage 1's
    A and stage 2's B operands.  The twiddle as in
    :func:`_twiddle_consts`."""
    _, _, f1d, f2d, *tw = _kernel_plan_real(n)
    f2 = _f2_consts(f2d)
    host = {"f1": f1d.astype(np.float64), "f1f": _frag_a1(f1d),
            "f2": f2["f2"], "f2b": _frag_b2(f2["f2w"]),
            **_twiddle_consts(*tw)}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


@functools.lru_cache(maxsize=16)
def _consts3(n: int, device: torch.device):
    """K2's plan as tensors on ``device``: ``c02``/``c13`` as float64
    [4, 4a, 2a] and ``f2`` for the twin; for the kernel's tensor cores
    ``c02f``/``c13f`` (:func:`_frag_a3`) and ``f2b`` (:func:`_frag_b2`), the
    digit words in the fragment order of stage 1's A and stage 2's B
    operands; the chunk-major twiddle as in :func:`_twiddle_consts`."""
    _, _, _, c02d, c13d, f2d, *tw = _kernel_plan_real3(n)
    f2 = _f2_consts(f2d)
    host = {"c02": c02d.astype(np.float64), "c13": c13d.astype(np.float64),
            "c02f": _frag_a3(c02d), "c13f": _frag_a3(c13d), "f2": f2["f2"],
            "f2b": _frag_b2(f2["f2w"]), **_twiddle_consts(*tw)}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


# The A fragment of the int8 tensor cores (PTX ISA, mma.m16n8k32 .s8, and
# each warp's 16 rows of wgmma m64nNk32), lane = 4*g + t: registers 0-3
# hold rows g, g + 8, g, g + 8 at k-words t, t, t + 4, t + 4 of a k-step of
# 8 words (32 int8).
_LANE_G = np.arange(32) >> 2
_LANE_T = np.arange(32) & 3
_A_ROW8 = np.array([0, 1, 0, 1])          # A register -> upper row half
_A_WORD4 = np.array([0, 0, 1, 1])         # A register -> upper k-word half


def _frag_a(planes: np.ndarray, row0: np.ndarray, im: int) -> np.ndarray:
    """Stage-1 digit planes [4, R, K] as int8x4 words in A-fragment order
    [4, T, k, 32, 4] int32, k = K/32 rounded up (the contraction
    zero-padded to whole k-steps): M tile T holds the re rows row0[T] + g
    (fragment rows g) and the im rows ``im`` further on (fragment rows
    g + 8)."""
    k = planes.shape[2]
    kp = -(-k // 32) * 32
    words = _words(np.pad(planes, ((0, 0), (0, 0), (0, kp - k))))
    re_row = row0[:, None] + _LANE_G[None, :]                 # [T, 32]
    row = re_row[:, :, None] + im * _A_ROW8                   # [T, 32, 4]
    word = (np.arange(kp // 32)[:, None, None] * 8 + _LANE_T[None, :, None]
            + 4 * _A_WORD4)                                  # [k, 32, 4]
    return np.ascontiguousarray(words[:, row[:, None], word[None]])


def _frag_a1(f1d: np.ndarray) -> np.ndarray:
    """K1-gen's F1r digit planes [4, 2n1, n1] in A-fragment order
    [4, n1/8, k, 32, 4], k = n1/32 rounded up: M tile T holds the re rows
    k1 = 8T + g and the im rows n1 + 8T + g."""
    n1 = f1d.shape[2]
    return _frag_a(f1d, 8 * np.arange(n1 // 8), n1)


def _frag_a3(planes: np.ndarray) -> np.ndarray:
    """K2's stage-1 digit planes [4, 4a, 2a] (c02 or c13) in A-fragment
    order [4, a/4, k, 32, 4], k = 2a/32 rounded up.  M tile T = h·(a/8) +
    kb holds the re rows h·2a + kb·8 + g and the im rows a further on: the
    re and im rows of the 8 positions (2h + c)·a + kb·8 + g of constant
    block c."""
    a = planes.shape[1] // 4
    tile = np.arange(a // 4)
    return _frag_a(planes, (tile // (a // 8)) * 2 * a + (tile % (a // 8)) * 8,
                   a)


def _frag_b2(f2w: np.ndarray) -> np.ndarray:
    """The stage-2 digit words ``f2w`` [4, 64, M] (int8x4 along the
    [br | bi] contraction, one column per output: M = 128 kept re/im bins
    for the real-split kernels, 256 for K3) in B-fragment order
    [4, 8 k-steps, M/8 N tiles, 32, 2] int32 (lane 4g + t holds column
    8j + g of N tile j at k-words t and t + 4 of its k-step)."""
    word = (np.arange(8)[:, None, None] * 8 + _LANE_T[None, :, None]
            + 4 * np.arange(2))                              # [8, 32, 2]
    col = (np.arange(f2w.shape[2] // 8)[:, None] * 8
           + _LANE_G[None, :])                               # [M/8, 32]
    return np.ascontiguousarray(f2w[:, word[:, None], col[None, :, :, None]])


def _twiddle_consts(twr_hi, twr_lo, twi_hi, twi_lo, twr_h, twi_h) -> dict:
    """The outer twiddle [n1, 128] for both tiers: ``twr``/``twi`` (the hi
    words, all the f32 tier reads), ``twr_lo``/``twi_lo`` (the df twin's lo
    words), and ``twr_df``/``twi_df`` [3, n1, 128] = (hi, lo, Veltkamp-high
    half of hi), the planes a df kernel reads."""
    return {"twr": twr_hi, "twi": twi_hi, "twr_lo": twr_lo, "twi_lo": twi_lo,
            "twr_df": np.stack([twr_hi, twr_lo, twr_h]),
            "twi_df": np.stack([twi_hi, twi_lo, twi_h])}


def _words(planes: np.ndarray) -> np.ndarray:
    """Digit planes [..., K] -> int32 words packing 4 int8 digits along the
    last (contraction) axis, lowest index in the lowest byte."""
    return np.ascontiguousarray(planes.astype(np.int8)).view("<i4").copy()


def _f2_consts(f2d: np.ndarray) -> dict:
    """Stage-2 digits [4, K, M] (K = 256 contraction rows [br | bi]):
    float64 ``f2`` for the twin, and ``f2w`` [4, K/4, M] packed along the
    contraction for the kernel."""
    _, k, m = f2d.shape
    f2b = f2d.astype(np.int8).reshape(N_DIGITS, k // 4, 4, m) \
        .transpose(0, 1, 3, 2)
    return {"f2": f2d.astype(np.float64), "f2w": _words(f2b)[..., 0]}


@functools.lru_cache(maxsize=8)
def _kernel_plan_cfft(n: int):
    """Constants of K3 at size ``n`` (``exact_pallas._kernel_plan(n, 1)``
    before class stacking).

    Returns ``(n1, n2, f1d, f2d, twr_hi, twr_lo, twi_hi, twi_lo)``: ``f1d``
    [4, 2n1, 2n1] digit planes of F1b = [[Re f1, -Im f1], [Im f1, Re f1]]
    (stage 1, contracting its columns against [x_r; x_i]), ``f2d``
    [4, 2n2, 2n2] digit planes of F2b = [[Re f2, Im f2], [-Im f2, Re f2]]
    (stage 2, contracting its rows against [b_r | b_i]), and the outer
    twiddle exp(-2πi·k1·j2/n) [n1, n2] as df32 pairs.
    """
    n1, n2 = n // LANES, LANES
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    f1b = np.block([[f1.real, -f1.imag], [f1.imag, f1.real]])
    f2b = np.block([[f2.real, f2.imag], [-f2.imag, f2.real]])
    return (n1, n2, _digit_planes(f1b), _digit_planes(f2b),
            *_twiddle_df(np.arange(n1), n)[:4])


@functools.lru_cache(maxsize=16)
def _consts_cfft(n: int, device: torch.device):
    """K3's plan as tensors on ``device``: ``f1``/``f2`` float64 for the
    twin; for the kernel's tensor cores ``f1f`` [4, n1/8, k, 32, 4]
    (:func:`_frag_a`, k = 2n1/32 rounded up: M tile T holds the A_r rows
    k1 = 8T + g and the A_i rows n1 + 8T + g of F1b) and ``f2b``
    [4, 8, 32, 32, 2] (:func:`_frag_b2`, all 256 columns of F2b); and
    ``tw`` [4, n1, 128] = (twr_hi, twr_lo, twi_hi, twi_lo)."""
    n1, _, f1d, f2d, *tw = _kernel_plan_cfft(n)
    f2 = _f2_consts(f2d)
    host = {"f1": f1d.astype(np.float64),
            "f1f": _frag_a(f1d, 8 * np.arange(n1 // 8), n1),
            "f2": f2["f2"], "f2b": _frag_b2(f2["f2w"]), "tw": np.stack(tw)}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------

def _pow2_scale_lane(m: torch.Tensor):
    """(s, 1/s) = 2^e with e = clip(ceil(log2(max(m, 1e-30))) + 1, ±125).

    ceil(log2) is read exactly from the float's exponent and mantissa bits,
    as the kernel reads it; a NaN ``m`` gives NaN scales (the lane's own
    output turns NaN, its neighbours keep their scales).
    """
    bits = torch.clamp_min(m, 1e-30).view(torch.int32)
    e = ((bits >> 23) & 255) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    e = torch.clamp(e + 1, -125, 125)
    s = ((e + 127) << 23).view(torch.float32)
    s_inv = ((127 - e) << 23).view(torch.float32)
    nan = torch.isnan(m)
    return torch.where(nan, m, s), torch.where(nan, m, s_inv)


def _fixed27(v: torch.Tensor, s_inv: torch.Tensor) -> torch.Tensor:
    """rint(v·s_inv·2^27) as int32, half to even; NaN -> 0 and ±inf
    saturating, as the card's float-to-int conversion does."""
    r = torch.round(v * s_inv * 2.0 ** _SLICE_TOP)
    r = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128)
    return r.to(torch.int32)


def _digits(i: torch.Tensor) -> list[torch.Tensor]:
    """The 4 offset-binary digit fields of the fixed-point words, as f64."""
    u = i + _SLICE_BIAS
    return [(((u >> (_SLICE_TOP - FIRST_SHIFT - DIGIT_BITS * k)) & 127) - 64)
            .to(torch.float64) for k in range(N_DIGITS)]


def _recombine(dots: list[torch.Tensor], s: torch.Tensor) -> torch.Tensor:
    """Exact integer class sums -> f32: ((w0 + w1) + w2) + w3 with
    w_t = S_t · (2^-(12+7t) · s)."""
    v = None
    for t, d in enumerate(dots):
        w = d.to(torch.float32) * (s * 2.0 ** -(2 * FIRST_SHIFT
                                                + DIGIT_BITS * t))
        v = w if v is None else v + w
    return v


def _windowed_blocks(x: torch.Tensor, window):
    """Raw nonzero counts [S, 2] f32 of ``x`` [S, 2, N], and its df32
    windowed samples (hi, lo) as [S, 2, N1, 128] blocks (j = 128·j1 + j2)."""
    S, _, n = x.shape
    n1 = n // LANES
    w_hi, w_lo = _window_pair(window, n, x.device)
    hi, lo = _windowed_df(x.reshape(S, 2, n1, LANES),
                          w_hi.reshape(n1, LANES), w_lo.reshape(n1, LANES))
    return (x != 0).sum(-1).to(torch.float32), hi, lo


def _digit_gemm_fast(planes: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor, s: torch.Tensor,
                     s_inv: torch.Tensor) -> torch.Tensor:
    """Digit-exact ``planes`` [4, R, K] @ the df32 columns (hi, lo)
    [..., K, M] scaled by ``s_inv``: fast slice, the 10 digit pairs
    i + j <= 3, plain f32 recombination -> [..., R, M] f32."""
    d = _digits(_fixed27(hi, s_inv) + _fixed27(lo, s_inv))
    return _recombine([sum(planes[i] @ d[t - i] for i in range(t + 1))
                       for t in range(N_DIGITS)], s)


def _stage1(planes: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
            s: torch.Tensor, s_inv: torch.Tensor, df: bool):
    """Digit-exact ``planes`` [4, R, K] @ the df32 columns (hi, lo)
    [..., K, M] scaled by ``s_inv`` -> a (hi, lo) pair [..., R, M]: the
    df tier's serial slice and TwoSum recombination, or the f32 tier's
    (:func:`_digit_gemm_fast`), whose lo is None."""
    if df:
        return _digit_gemm(_left, planes, _slice_df(hi, lo, s_inv), s)
    return _digit_gemm_fast(planes, hi, lo, s, s_inv), None


def _rows(a, r0: int, r1: int):
    """Rows r0:r1 (axis 2) of both words of a stage-1 (hi, lo) pair."""
    return tuple(None if w is None else w[:, :, r0:r1] for w in a)


def _twiddle_stage2(ar, ai, c: dict):
    """The tail both bodies share, at the tier of the stage-1 rows ``ar``/
    ``ai``, (hi, lo) pairs [S, 2, n1, n2] in the order of ``c``'s twiddle
    rows (lo None at the f32 tier): the outer twiddle, kept-half stage 2
    with one pow2 scale per (s, c, row) over the hi words of [br | bi],
    clamp of the hi words to ±2^63, magnitude -> [S, 2, n1, n2/2]."""
    keep = LANES // 2
    if ar[1] is not None:
        # df tier: Dekker df32 twiddle, serial slice, TwoSum recombination,
        # then _tail_stage2's own magnitude (not exactfft._df_mag's order)
        br, bi = _df_cmul(ar, ai, (c["twr"], c["twr_lo"]),
                          (c["twi"], c["twi_lo"]))
        b_hi = torch.cat([br[0], bi[0]], dim=-1)           # [S, 2, n1, 2n2]
        b_lo = torch.cat([br[1], bi[1]], dim=-1)
        s2, s2_inv = _pow2_scale_lane(b_hi.abs().amax(dim=-1, keepdim=True))
        c_hi, c_lo = _digit_gemm(_right, c["f2"],
                                 _slice_df(b_hi, b_lo, s2_inv), s2)
        cr = (torch.clamp(c_hi[..., :keep], -_CLAMP, _CLAMP), c_lo[..., :keep])
        ci = (torch.clamp(c_hi[..., keep:], -_CLAMP, _CLAMP), c_lo[..., keep:])
        rr, ii = df_mul(cr, cr), df_mul(ci, ci)
        s0, e0 = two_sum(rr[0], ii[0])
        return torch.sqrt(torch.clamp_min(s0 + ((e0 + rr[1]) + ii[1]), 0.0))
    # f32 tier: every twiddle product rounded on its own
    br = ar[0] * c["twr"] - ai[0] * c["twi"]
    bi = ar[0] * c["twi"] + ai[0] * c["twr"]
    b = torch.cat([br, bi], dim=-1)                        # [S, 2, n1, 2n2]
    s2, s2_inv = _pow2_scale_lane(b.abs().amax(dim=-1, keepdim=True))
    d2 = _digits(_fixed27(b, s2_inv))
    cc = _recombine([sum(d2[t - i] @ c["f2"][i] for i in range(t + 1))
                     for t in range(N_DIGITS)], s2)        # [S, 2, n1, n2]
    cr = torch.clamp(cc[..., :keep], -_CLAMP, _CLAMP)
    ci = torch.clamp(cc[..., keep:], -_CLAMP, _CLAMP)
    return torch.sqrt(cr * cr + ci * ci)


def _pair_mag(x: torch.Tensor, window, df: bool):
    """K1's body (2-factor stage 1) at either tier."""
    S, _, n = x.shape
    n1 = n // LANES
    c = _consts(n, x.device)
    nz, hi, lo = _windowed_blocks(x, window)

    # stage 1: per-channel real DFT over j1, one pow2 scale per (s, j2)
    # column taken over both channels
    s, s_inv = _pow2_scale_lane(hi.abs().amax(dim=(1, 2), keepdim=True))
    a = _stage1(c["f1"], hi, lo, s, s_inv, df)            # [S, 2, 2n1, n2]
    mag = _twiddle_stage2(_rows(a, 0, n1), _rows(a, n1, 2 * n1), c)
    return mag.transpose(-1, -2).reshape(S, 2, n // 2), nz


def _pair_mag3(x: torch.Tensor, window, df: bool):
    """K2's body (3-factor stage 1) at either tier."""
    S, _, n = x.shape
    a = n // LANES // 4
    c = _consts3(n, x.device)
    nz, hi, lo = _windowed_blocks(x, window)

    # radix-4 butterflies over the four a-row chunks, df32 adds
    ch = [(hi[:, :, q * a:(q + 1) * a], lo[:, :, q * a:(q + 1) * a])
          for q in range(4)]
    u0 = df_add(ch[0], ch[2])
    u1 = df_add(ch[0], df_neg(ch[2]))
    u2 = df_add(ch[1], ch[3])
    u3 = df_add(ch[1], df_neg(ch[3]))

    # two digit GEMMs, one pow2 scale per (s, c, j2) column of each of
    # U02 = [u0; u2] and U13 = [u1; u3]
    def stage1(planes, top, bottom):
        h = torch.cat([top[0], bottom[0]], dim=2)          # [S, 2, 2a, 128]
        l = torch.cat([top[1], bottom[1]], dim=2)
        s, s_inv = _pow2_scale_lane(h.abs().amax(dim=2, keepdim=True))
        return _stage1(planes, h, l, s, s_inv, df)         # [S, 2, 4a, 128]

    a02 = stage1(c["c02"], u0, u2)      # rows [A0r; A0i; A2r; A2i]
    a13 = stage1(c["c13"], u1, u3)      # rows [A1r; A1i; A3r; A3i]

    # chunk-major rows pos = kq·a + kp, both words of each pair
    def chunk_major(r_even, r_odd):
        return tuple(None if a02[w] is None else torch.cat(
            [a02[w][:, :, r_even:r_even + a], a13[w][:, :, r_even:r_even + a],
             a02[w][:, :, r_odd:r_odd + a], a13[w][:, :, r_odd:r_odd + a]],
            dim=2) for w in (0, 1))

    ar, ai = chunk_major(0, 2 * a), chunk_major(a, 3 * a)
    unscramble = torch.from_numpy(_row_unscramble(n)).to(x.device)
    mag = _twiddle_stage2(ar, ai, c)[:, :, unscramble]
    return mag.transpose(-1, -2).reshape(S, 2, n // 2), nz


def rfft_pair_mag_ref(x: torch.Tensor, window=None):
    """Plain PyTorch twin of K1-gen (the f32 tier): ``x`` [S, 2, N]
    f32 -> ``(mag [S, 2, N/2] f32, nzcount [S, 2] f32)``, bins in natural
    order.

    ``window`` is a (w_hi, w_lo) df32 pair of [N] tensors or None.
    """
    return _pair_mag(x, window, df=False)


def rfft_pair_mag_df_ref(x: torch.Tensor, window=None):
    """Plain PyTorch twin of K1-df, K1's body at the df tier: the contract
    of :func:`rfft_pair_mag_ref`."""
    return _pair_mag(x, window, df=True)


def rfft_pair_mag3_ref(x: torch.Tensor, window=None):
    """Plain PyTorch twin of K2 (the f32 tier), the same contract as
    :func:`rfft_pair_mag_ref`: ``x`` [S, 2, N] f32 with N = 512·a,
    a % 8 == 0."""
    return _pair_mag3(x, window, df=False)


def rfft_pair_mag3_df_ref(x: torch.Tensor, window=None):
    """Plain PyTorch twin of K2-df, K2 at the df tier: the contract of
    :func:`rfft_pair_mag3_ref`."""
    return _pair_mag3(x, window, df=True)


def cfft_exact_ref(re, im):
    """Plain PyTorch twin of K3 (``exact_pallas._core``): the exact complex
    FFT of [..., N] f32 tensors or df32 (hi, lo) pairs ``re``/``im``.
    Returns ``((zr_hi, zr_lo), (zi_hi, zi_lo))`` [..., N], bins in natural
    order."""
    re, im = _df_pair(re), _df_pair(im)
    shp, n = re[0].shape[:-1], re[0].shape[-1]
    n1 = n // LANES
    c = _consts_cfft(n, re[0].device)

    def blocks(a, b):                                 # [S, 2n1, 128]
        return torch.cat([a.reshape(-1, n1, LANES),
                          b.reshape(-1, n1, LANES)], dim=1)

    x_hi, x_lo = blocks(re[0], im[0]), blocks(re[1], im[1])
    # stage 1: one pow2 scale per (s, j2) column over [x_r; x_i]
    s, s_inv = _pow2_scale_lane(x_hi.abs().amax(dim=1, keepdim=True))
    a_hi, a_lo = _digit_gemm(_left, c["f1"], _slice_df(x_hi, x_lo, s_inv), s)
    br, bi = _df_cmul((a_hi[:, :n1], a_lo[:, :n1]),
                      (a_hi[:, n1:], a_lo[:, n1:]),
                      (c["tw"][0], c["tw"][1]), (c["tw"][2], c["tw"][3]))
    # stage 2: one pow2 scale per (s, k1) row over [b_r | b_i]
    b_hi = torch.cat([br[0], bi[0]], dim=-1)              # [S, n1, 256]
    b_lo = torch.cat([br[1], bi[1]], dim=-1)
    s2, s2_inv = _pow2_scale_lane(b_hi.abs().amax(dim=-1, keepdim=True))
    c_hi, c_lo = _digit_gemm(_right, c["f2"],
                             _slice_df(b_hi, b_lo, s2_inv), s2)

    def fin(a):                         # [S, n1, 128] -> k = k1 + n1·k2
        return a.transpose(-1, -2).reshape(*shp, n)

    return ((fin(c_hi[..., :LANES]), fin(c_lo[..., :LANES])),
            (fin(c_hi[..., LANES:]), fin(c_lo[..., LANES:])))


def _window_pair(window, n: int, device: torch.device):
    if window is None:
        return (torch.ones(n, dtype=torch.float32, device=device),
                torch.zeros(n, dtype=torch.float32, device=device))
    return window


# ---------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "waveform_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_lib = None
build_info: dict = {}    # "library": the .so path; "log": nvcc's output


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def build() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` into a shared library (once per source hash)
    and bind it: one ``nvcc`` per source, all started together, then one
    link.  Raises on a failed build."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    out = _BUILD / f"libwf_exact_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        try:
            for src, proc, log in zip(sources, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
            r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                str(tmp), *map(str, objs)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                                   f"{r.stderr}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, out)
        build_info["log"] = "".join(logs)
    build_info["library"] = str(out)
    lib = ctypes.CDLL(str(out))
    lib.wf_exact_mag3.restype = ctypes.c_int
    lib.wf_exact_mag3.argtypes = ([ctypes.c_void_p] * 12
                                  + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
    lib.wf_exact_cfft.restype = ctypes.c_int
    lib.wf_exact_cfft.argtypes = ([ctypes.c_void_p] * 9
                                  + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
    # K1-gen and K1-df, K2 and K2-df: one signature a pair
    for fn in (lib.wf_exact_mag_gen, lib.wf_exact_mag_gen_df):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.wf_exact_mag3_df.restype = ctypes.c_int
    lib.wf_exact_mag3_df.argtypes = lib.wf_exact_mag3.argtypes
    # one stage alone (chip_smoke times the stages apart): (stage, df, ...)
    # for the pair kernels, (stage, ...) for K3
    for fn, whole, ints in ((lib.wf_exact_mag3_stage, lib.wf_exact_mag3, 2),
                            (lib.wf_exact_mag_gen_stage, lib.wf_exact_mag_gen,
                             2),
                            (lib.wf_exact_cfft_stage, lib.wf_exact_cfft, 1)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * ints + whole.argtypes
    _lib = lib
    return lib


def sass_counts(ops=("IMMA", "IGMMA", "IDP.4A")) -> dict:
    """Instruction counts of each kernel in the built library, read from
    its SASS (``cuobjdump -sass``, beside ``nvcc``): ``{mangled kernel
    name: {op: count}}``, an instruction counting for ``op`` when its
    opcode is ``op`` or starts with ``op.`` (``IGMMA``: the int8
    ``wgmma``; ``IMMA.16832.S8.S8``: the int8 ``mma.sync``;
    ``IDP.4A.S8.S8``: ``__dp4a``)."""
    build()
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build_info["library"]],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
            continue
        ins = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn is not None and ins:
            opcode = ins.group(1)
            for op in ops:
                if opcode == op or opcode.startswith(op + "."):
                    counts[fn][op] += 1
    return counts


def _check_pair(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != 2:
        raise ValueError(f"expected [S, 2, N] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")


def _checked_window(x: torch.Tensor, window):
    """The df32 window pair for ``x`` (ones/zeros for None), checked, and
    ``x``'s device checked: CPU takes a twin, CUDA a contiguous launch."""
    n = x.shape[-1]
    w_hi, w_lo = _window_pair(window, n, x.device)
    for w in (w_hi, w_lo):
        if (w.shape != (n,) or w.dtype != torch.float32
                or w.device != x.device or not w.is_contiguous()):
            raise ValueError("window must be a pair of contiguous [N] float32 "
                             "tensors on the input's device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return w_hi, w_lo


def rfft_pair_mag(x: torch.Tensor, window=None):
    """|rFFT| and raw nonzero counts of [S, 2, N] f32 channel pairs.

    Returns ``(mag [S, 2, N/2] f32, nzcount [S, 2] f32)`` in natural bin
    order.  ``window`` is a (w_hi, w_lo) df32 pair of [N] f32 tensors on
    ``x``'s device, or None for no window.  ``N`` must be one that
    :func:`supports` admits; :func:`stage1_split` picks the body and
    :func:`twiddle_tier` its tier: split 2 runs :func:`rfft_pair_mag_gen`
    (K1-gen, or K1-df under df), split 3 :func:`rfft_pair_mag3` (K2, or
    K2-df under df).  A CUDA tensor launches the kernel, a CPU tensor
    takes its twin.
    """
    _check_pair(x)
    n = x.shape[-1]
    if not supports(n):
        raise NotImplementedError(
            f"the exact |rFFT| pair kernels take N = 128·N1 with N1 % 8 == 0: "
            f"up to {MAX_N2} under stage-1 split 2, with N1 % 32 == 0 up to "
            f"{MAX_N3} under split 3; got N={n} at split {stage1_split(n)}")
    tier = twiddle_tier()
    if stage1_split(n) == 3:
        return rfft_pair_mag3(x, window, twiddle=tier)
    return rfft_pair_mag_gen(x, window, twiddle=tier)


def _launch_two_stage(fn, x, w_hi, w_lo, consts, c, df: bool):
    """Launch a two-launch pair kernel ``fn`` (K1-gen, K1-df, K2, K2-df)
    on ``x`` [S, 2, N]: allocate its outputs, its stage-1 scratch rows
    [S, 2, N1, 256] f32 (a (hi, lo) plane pair under df) and its int32
    nonzero sums, pass ``consts`` (keys of ``c``, in the C signature's
    order) and the tier's twiddle planes, raise on a failed launch."""
    S, _, n = x.shape
    dev = x.device
    mag = torch.empty((S, 2, n // 2), dtype=torch.float32, device=dev)
    nz = torch.empty((S, 2), dtype=torch.float32, device=dev)
    rows = torch.empty((2 if df else 1, S, 2, n // LANES, 2 * LANES),
                       dtype=torch.float32, device=dev)
    nz_int = torch.empty((S, 2), dtype=torch.int32, device=dev)
    tw = ("twr_df", "twi_df") if df else ("twr", "twi")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                 *(c[k].data_ptr() for k in (*consts, *tw)), rows.data_ptr(),
                 nz_int.data_ptr(), mag.data_ptr(), nz.data_ptr(), S, n,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError "
                           f"{err}")
    return mag, nz


def rfft_pair_mag_gen(x: torch.Tensor, window=None,
                      twiddle: str | None = None):
    """K1's body directly, at any N = 128·N1 with N1 % 8 == 0 up to 32768
    (N = 32768 included, which :func:`rfft_pair_mag` sends to K2): K1-gen
    under the f32 tier, K1-df under df.  ``twiddle`` names
    the tier; None reads :func:`twiddle_tier`.  The contract of
    :func:`rfft_pair_mag`; a CPU tensor takes :func:`rfft_pair_mag_ref` or
    :func:`rfft_pair_mag_df_ref`.
    """
    global launches_gen, launches_gen_df
    _check_pair(x)
    df = _tier(twiddle) == "df"
    n = x.shape[-1]
    if not _two_factor(n):
        raise NotImplementedError(
            f"K1-gen covers N = 128·N1 with N1 % 8 == 0 up to {MAX_N2}, "
            f"got N={n}")
    w_hi, w_lo = _checked_window(x, window)
    if x.device.type == "cpu":
        return _pair_mag(x, (w_hi, w_lo), df)
    lib = build()
    out = _launch_two_stage(
        lib.wf_exact_mag_gen_df if df else lib.wf_exact_mag_gen, x, w_hi,
        w_lo, K1GEN_CONSTS, _consts(n, x.device), df)
    if df:
        launches_gen_df += 1
    else:
        launches_gen += 1
    return out


def rfft_pair_mag3(x: torch.Tensor, window=None, twiddle: str | None = None):
    """K2's body directly, at any N = 512·a with a % 8 == 0 up to 65536
    (N=4096 included, which :func:`rfft_pair_mag` sends to K1's body): K2
    under the f32 tier, K2-df under df.  ``twiddle`` names the tier; None
    reads :func:`twiddle_tier`.  The contract of :func:`rfft_pair_mag`; a
    CPU tensor takes :func:`rfft_pair_mag3_ref` or
    :func:`rfft_pair_mag3_df_ref`.
    """
    global launches3, launches3_df
    _check_pair(x)
    df = _tier(twiddle) == "df"
    n = x.shape[-1]
    n1, rem = divmod(n, LANES)
    if rem or n1 % 32 or not 4096 <= n <= MAX_N3:
        raise NotImplementedError(
            f"the 3-factor kernel covers N = 4096·k up to {MAX_N3}, got N={n}")
    w_hi, w_lo = _checked_window(x, window)
    if x.device.type == "cpu":
        return _pair_mag3(x, (w_hi, w_lo), df)
    lib = build()
    out = _launch_two_stage(
        lib.wf_exact_mag3_df if df else lib.wf_exact_mag3, x, w_hi, w_lo,
        K2_CONSTS, _consts3(n, x.device), df)
    if df:
        launches3_df += 1
    else:
        launches3 += 1
    return out


def cfft_exact_kernel(re, im):
    """K3: the exact complex FFT of [..., N] f32 tensors or df32 (hi, lo)
    pairs ``re``/``im`` (one shape, one device), N = 128·N1 with
    N1 % 8 == 0 up to 32768 (:func:`supports_cfft`).  Returns
    ``((zr_hi, zr_lo), (zi_hi, zi_lo))`` [..., N] df32, bins in natural
    order.  A CUDA tensor launches ``csrc/exact_cfft.cu`` (two kernels,
    one count), a CPU tensor takes :func:`cfft_exact_ref`."""
    global launches_cfft
    re, im = _df_pair(re), _df_pair(im)
    parts = (*re, *im)
    shp, n = parts[0].shape[:-1], parts[0].shape[-1]
    for p in parts:
        if (p.dtype != torch.float32 or p.shape != parts[0].shape
                or p.device != parts[0].device):
            raise ValueError("re and im must be float32 tensors (or df32 "
                             "pairs of them) of one shape on one device")
    if not supports_cfft(n):
        raise NotImplementedError(
            f"K3 covers N = 128·N1 with N1 % 8 == 0 up to {MAX_N2}, got N={n}")
    dev = parts[0].device
    if dev.type == "cpu":
        return cfft_exact_ref(re, im)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = build()
    S = int(np.prod(shp)) if shp else 1
    flat = [p.reshape(S, n).contiguous() for p in parts]
    c = _consts_cfft(n, dev)
    # stage-1 rows after the twiddle, (hi, lo) planes of [S, n1, 256]
    rows = torch.empty((2, S, n // LANES, 2 * LANES), dtype=torch.float32,
                       device=dev)
    out = torch.empty((4, S, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.wf_exact_cfft(
            *(p.data_ptr() for p in flat),
            *(c[k].data_ptr() for k in K3_CONSTS), rows.data_ptr(),
            out.data_ptr(), S, n,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exact_cfft kernel launch failed: cudaError {err}")
    launches_cfft += 1
    z = out.reshape(4, *shp, n)
    return (z[0], z[1]), (z[2], z[3])
