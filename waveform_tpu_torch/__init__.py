"""Waveform on PyTorch and CUDA: the spectrum serving path for NVIDIA Hopper.

A port of ``waveform_tpu`` (the JAX package, which stays the reference):
the same configuration API, the same host-side assembly, and the same
exact-accumulation spectrum, with the digit-sliced |rFFT| as CUDA kernels
(``kernels/exact_cuda.py``, ``csrc/``).  This package imports ``torch``
and nothing of ``jax`` or of the JAX package: it keeps its own copies of
the host modules it needs (config, enums, sample ring, window tables,
rebin tables, the float64 oracle, the native assembler), so a config is
resolved with this package's :func:`resolve`.
"""

__version__ = "0.1.0"

from .core.config import (  # noqa: F401
    DB_MIN,
    RGBA,
    AudioInfo,
    ResolvedConfig,
    Settings,
    VideoInfo,
    resolve,
)
from .core.enums import (  # noqa: F401
    ChannelMode,
    DisplayMode,
    FFTWindow,
    FilterMode,
    InterpMode,
    PulseMode,
    RenderMode,
    TSmoothingMode,
)
from .dsp import oracle  # noqa: F401
