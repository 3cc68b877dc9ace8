"""Wisdom: what a process keeps so the next one starts without a stall.

The PyTorch counterpart of ``waveform_tpu/utils/wisdom.py`` (FFTW's
wisdom files, the JAX package's persistent compilation cache).  Here the
kept plan is the kernel build: ``kernels/cuda_lib.build`` compiles
``csrc/`` with nvcc once per source hash into a build directory and later
processes load the library from there.  :func:`enable` names that
directory; :func:`warm` does a config's first-tick work before serving
starts.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ..core.device import checked_device
from ..kernels import cuda_lib


def enable(cache_dir: str | None = None) -> str:
    """Create the kernel build directory and return it.  ``cache_dir``
    moves the build there (for builds made after this call); None keeps
    the current one (``build/waveform_tpu_torch`` beside the package)."""
    if cache_dir is not None:
        cuda_lib._BUILD = Path(cache_dir)
    os.makedirs(cuda_lib._BUILD, exist_ok=True)
    return str(cuda_lib._BUILD)


def warm(cfg, num_streams: int,
         device: torch.device | str = "cuda") -> None:
    """Do the first-tick work of serving ``cfg`` before serving starts: on
    the card, build (or load) the kernels and make the cuBLAS and cuFFT
    handles; then run one silent tick of a throwaway
    :class:`~..runtime.serving.ServingEngine`, which uploads the
    kernels' constants and the rebin tables and captures its graph.  An
    engine built afterwards then starts without the build and the
    libraries' first-call set-up.  On the CPU it runs the tick and builds
    nothing."""
    from ..runtime.serving import ServingEngine

    dev = checked_device(device, "warm")
    if dev.type == "cuda":
        cuda_lib.build()
        a = torch.ones((8, 8), dtype=torch.float32, device=dev)
        torch.mm(a, a)
        torch.fft.rfft(a)
    eng = ServingEngine(cfg, num_streams, device=dev)
    eng.tick(now_ns=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
