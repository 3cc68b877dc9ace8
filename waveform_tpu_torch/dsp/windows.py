"""FFT window coefficient tables.

Same five window families (plus NONE) and the exact same closed forms as the
reference's precompute loop (reference src/source.cpp:1190-1234):
denominator is ``N = fft_size - 1`` and Hamming uses the 0.53836/0.46164
"exact" coefficients.  Tables are computed in float64 on the host and baked
into the jitted pipeline as float32 constants — the TPU-native analog of the
reference's ``m_window_coefficients`` member buffer.

The port's own copy of ``waveform_tpu/dsp/windows.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..core.enums import FFTWindow


def window_coefficients(window: FFTWindow, size: int, sine_exponent: int = 2,
                        dtype=np.float64) -> np.ndarray:
    """Return window coefficients of length ``size`` (float64 by default)."""
    if window == FFTWindow.NONE:
        return np.ones(size, dtype=dtype)
    n = np.arange(size, dtype=np.float64)
    N = float(size - 1)
    t = (2.0 * np.pi * n) / N
    if window == FFTWindow.HAMMING:
        w = 0.53836 - 0.46164 * np.cos(t)
    elif window == FFTWindow.BLACKMAN:
        w = 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2.0 * t)
    elif window == FFTWindow.BLACKMAN_HARRIS:
        w = (0.35875 - 0.48829 * np.cos(t) + 0.14128 * np.cos(2.0 * t)
             - 0.01168 * np.cos(3.0 * t))
    elif window == FFTWindow.POWER_OF_SINE:
        w = np.sin((np.pi * n) / N) ** int(sine_exponent)
    else:  # HANN (default, matches reference switch fall-through)
        w = 0.5 * (1.0 - np.cos(t))
    return w.astype(dtype)


def window_sum(window: FFTWindow, size: int, sine_exponent: int = 2) -> float:
    """Sum of coefficients, used as magnitude normalizer ``2/window_sum``.

    For ``NONE`` the reference uses ``fft_size`` itself
    (reference src/source.cpp:1233-1234).
    """
    if window == FFTWindow.NONE:
        return float(size)
    return float(window_coefficients(window, size, sine_exponent).sum())
