"""Gaussian spatial smoothing of the rebinned graph.

The reference smooths the pixel/bar-axis values with a σ-parameterized
Gaussian kernel whose edge pixels renormalize by the partial weight sum
(reference src/filter.hpp:40-65, 133-158; FMA3 form in
src/filter_fma3.cpp:16-74).  Because interior pixels divide by the full
kernel sum and edge pixels by the sum of in-range weights, the whole filter
is exactly ``zero-padded-conv(x, w) / renorm`` where ``renorm[i]`` is the
precomputed sum of valid weights at pixel ``i`` — one fused convolution on
TPU, no per-pixel branching.

The port's own copy of ``waveform_tpu/rebin/filter.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GaussTables:
    weights: np.ndarray   # [K] kernel, K = 2*ceil(3σ)-1
    renorm: np.ndarray    # [P] per-output normalizer


def build_gauss_tables(sigma: float, n: int, dtype=np.float32) -> GaussTables:
    sigma = max(abs(sigma), 0.01)  # reference: src/filter.hpp:44
    w = int(math.ceil(3.0 * sigma))
    offsets = np.arange(-w + 1, w, dtype=np.float64)
    weights = (1.0 / (math.sqrt(2.0 * math.pi) * sigma)) * np.exp(
        -(offsets ** 2) / (2.0 * sigma * sigma))
    # renorm[i] = sum of weights whose tap i+offset is inside [0, n)
    renorm = np.empty(n, dtype=np.float64)
    for i in range(n):
        taps = i + offsets.astype(np.int64)
        valid = (taps >= 0) & (taps < n)
        renorm[i] = weights[valid].sum()
    return GaussTables(weights=weights.astype(dtype), renorm=renorm.astype(dtype))


def apply_gauss_np(values: np.ndarray, tables: GaussTables) -> np.ndarray:
    """NumPy application (testing aid); values [..., P]."""
    k = len(tables.weights)
    pad = (k - 1) // 2
    padded = np.pad(values, [(0, 0)] * (values.ndim - 1) + [(pad, pad)])
    out = np.zeros_like(values, dtype=np.float64)
    for j in range(k):
        out += padded[..., j:j + values.shape[-1]] * tables.weights[j]
    return out / tables.renorm
