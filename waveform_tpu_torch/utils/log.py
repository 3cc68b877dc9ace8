"""Structured logging, replacing the reference's OBS-blog wrapper.

The PyTorch counterpart of ``waveform_tpu/utils/log.py``.  The reference
streams into OBS's logger with a ``[phandasm_waveform]`` prefix (reference
src/log.hpp:24-45) and logs version, architecture and CPU capabilities on
startup (src/source.cpp:1793-1794).  Here: a stdlib logger with the
port's prefix, and a startup banner with the package, torch and CUDA
versions and the name of each device the run uses.
"""

from __future__ import annotations

import logging
import platform

import torch

LOGGER_NAME = "waveform_tpu_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[waveform_tpu_torch] %(levelname)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_startup_banner(device: torch.device | str = "cuda") -> None:
    """Versions and the devices of the run: every CUDA device's name when
    ``device`` is a CUDA device, else the CPU's."""
    from .. import __version__
    logger = get_logger()
    logger.info("Waveform-TPU (PyTorch/CUDA port) v%s; torch %s, CUDA %s",
                __version__, torch.__version__, torch.version.cuda or "none")
    if torch.device(device).type == "cuda":
        names = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                 for i in range(torch.cuda.device_count())]
    else:
        names = [f"cpu {platform.processor() or platform.machine()}"]
    logger.info("Devices: %s", ", ".join(names))
