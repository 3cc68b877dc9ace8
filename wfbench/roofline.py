"""The yardstick of a layer's share of its roofline: the work its inputs
need, counted from their shapes, and the card's published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, and 67 TFLOP/s of float32 off the tensor cores.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def rfft_mag_work(S: int, C: int, N: int) -> tuple[float, float]:
    """(bytes, flops) that |rFFT| of S·C real windows of N samples needs,
    whatever computes it: each window read once and each of its N/2
    magnitudes written once, in float32, and 2.5·N·log2 N flops a real
    transform (FFTW's nominal count, libbench2/mflops.c)."""
    nbytes = S * C * N * 4 + S * C * (N // 2) * 4
    flops = 2.5 * N * math.log2(N) * S * C
    return float(nbytes), flops


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, and which peak sets it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "flops")
