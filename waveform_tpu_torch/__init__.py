"""Waveform on PyTorch and CUDA: the spectrum serving path for NVIDIA Hopper.

A port of ``waveform_tpu`` (the JAX package, which stays the reference):
the same configuration API, the same host-side assembly, and the same
exact-accumulation spectrum, with the digit-sliced |rFFT| as a CUDA kernel
(``kernels/exact_cuda.py``, ``csrc/exact_mag.cu``).  This package imports
``torch`` and never ``jax``; the JAX-free host modules of ``waveform_tpu``
(config, enums, sample ring, window tables, rebin tables, the float64
oracle, the native assembler) are shared rather than copied.
"""

from waveform_tpu import __version__  # noqa: F401
from waveform_tpu.core.config import (  # noqa: F401
    DB_MIN,
    RGBA,
    AudioInfo,
    ResolvedConfig,
    Settings,
    VideoInfo,
    resolve,
)
from waveform_tpu.core.enums import (  # noqa: F401
    ChannelMode,
    DisplayMode,
    FFTWindow,
    FilterMode,
    InterpMode,
    PulseMode,
    RenderMode,
    TSmoothingMode,
)
from waveform_tpu.dsp import oracle  # noqa: F401
