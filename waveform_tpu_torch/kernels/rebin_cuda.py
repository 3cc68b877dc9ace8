"""The rebin on the card: one hand-written CUDA kernel for the interp and
one for the Gaussian filter.

The interp maps each row of dB bins to P pixels (or a bar look's
expanded samples) through ``rebin/interp.build_interp_tables``' tables,
``taps`` [P, T] int32 and ``weights`` [P, T] f32, T = 8 (Lanczos), 4
(Catmull-Rom) or 1 (point); the filter is the zero-padded K-tap
convolution of ``rebin/filter.build_gauss_tables`` divided by its
``renorm``.  Both launch ``csrc/rebin.cu``, built into the port's CUDA
library (``cuda_lib.build``) and counted as ``LAUNCHES["rebin"]``, one a
call.

They replace no Pallas kernel: the JAX package's rebin
(``waveform_tpu/rebin/apply.py``) is jnp code.  Its dense form, as a
float32 GEMM, multiplies by a matrix 99.9% zeros (6.7 GFLOP where 6.6
MFLOP is needed at [512, 8192] -> 800), and its filter is ~22
elementwise nodes.  Bytes bound both kernels: :func:`interp_bytes` and
:func:`gauss_bytes`.

A CUDA tensor launches the kernel (a failed build or launch raises; there
is no fallback); a CPU tensor runs the plain version,
:func:`rebin_interp_ref` (the gather of the taps and a weighted sum) or
:func:`rebin_gauss_ref` (the padded loop divided by ``renorm``).  The
filter kernel gives the plain version's bits; the interp adds its T
products in tap order, where the plain sum may add them in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_lib

PIXELS = 64                     # interp: pixels (threads) a block (csrc:
                                # kPixels)
BLOCKS = 132 * 16               # interp: the blocks to aim for, sixteen on
                                # each of the H100's 132 SMs
TAPS = (1, 4, 8)                # the tap counts the interp kernel takes


def rebin_interp_ref(x: torch.Tensor, taps: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`rebin_interp`: gather each pixel's
    taps of ``x`` [..., nbins] and sum them weighted, [..., P]."""
    return (x[..., taps] * weights).sum(-1)


def rebin_gauss_ref(x: torch.Tensor, weights, renorm: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version of :func:`rebin_gauss`: the zero-padded
    convolution of ``x`` [..., P] with the K ``weights`` (floats), tap by
    tap from zero, divided by ``renorm`` [P]: exactly the reference's
    edge renormalization."""
    pad = (len(weights) - 1) // 2
    padded = torch.nn.functional.pad(x, (pad, pad))
    smoothed = torch.zeros_like(x)
    for j, w in enumerate(weights):
        smoothed = smoothed + padded[..., j:j + x.shape[-1]] * w
    return smoothed / renorm


def interp_bytes(rows: int, taps) -> int:
    """Device-memory bytes the interp needs to move through the tap table
    ``taps`` [P, T]: each bin some tap of a row reads, read once (at low
    frequencies neighbouring pixels share their taps), each output
    written once (the table read through L1 left out)."""
    return 4 * rows * (np.unique(np.asarray(taps)).size + len(taps))


def gauss_bytes(rows: int, pixels: int) -> int:
    """Device-memory bytes the filter moves: each row read and written
    once."""
    return 8 * rows * pixels


def _rows(x: torch.Tensor) -> tuple[int, int, int, int]:
    """``x`` [..., n] as ``(rows, inner, stride_a, stride_b)``: row ``a *
    inner + b`` at ``a * stride_a + b * stride_b``.  Leading dims merge
    where their strides allow; raises ValueError where more than two
    remain or a row's bins are not adjacent."""
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("rebin rows must be contiguous along their last "
                         f"dim, got strides {tuple(x.stride())}")
    dims = [(n, st) for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    merged: list[list[int]] = []
    for n, st in dims:
        if merged and merged[-1][1] == n * st:
            merged[-1] = [merged[-1][0] * n, st]
        else:
            merged.append([n, st])
    if len(merged) > 2:
        raise ValueError("rebin rows must form at most two strided dims, got "
                         f"shape {tuple(x.shape)} strides {tuple(x.stride())}")
    merged = [[1, 0]] * (2 - len(merged)) + merged
    (na, sa), (nb, sb) = merged
    return na * nb, nb, sa, sb


def rebin_interp(x: torch.Tensor, taps: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """``x`` [..., nbins] f32 through the tap tables ``taps`` [P, T] int32
    (each in [0, nbins)) and ``weights`` [P, T] f32, both contiguous, T in
    :data:`TAPS`: a new [..., P] tensor, each output the sum of its T
    products in tap order.  ``x``'s bins are adjacent; its leading dims
    may be strided (a channel slice of a state) if they merge into two.
    A CPU ``x`` runs :func:`rebin_interp_ref`; on CUDA anything else
    raises ValueError."""
    if taps.device != x.device or weights.device != x.device:
        raise ValueError("rebin_interp takes its rows and tables on one "
                         "device")
    if x.device.type == "cpu":
        return rebin_interp_ref(x, taps, weights)
    if x.device.type != "cuda":
        raise ValueError(f"rebin_interp runs on CUDA or the CPU, got "
                         f"{x.device}")
    if (taps.dim() != 2 or weights.shape != taps.shape
            or taps.shape[1] not in TAPS or taps.dtype != torch.int32
            or weights.dtype != torch.float32):
        raise ValueError(
            "rebin_interp takes [P, T] int32 taps and [P, T] float32 weights "
            f"with T in {TAPS}; got {taps.dtype} {tuple(taps.shape)}, "
            f"{weights.dtype} {tuple(weights.shape)}")
    if x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError(f"rebin_interp takes [..., nbins] float32 rows, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not (taps.is_contiguous() and weights.is_contiguous()):
        raise ValueError("rebin_interp's tables must be contiguous")
    rows, inner, sa, sb = _rows(x)
    P, T = taps.shape
    out = torch.empty(*x.shape[:-1], P, dtype=torch.float32, device=x.device)
    xb = math.ceil(P / PIXELS)
    per_block = min(8, max(1, math.ceil(rows * xb / BLOCKS)))
    dev = x.device
    with torch.cuda.device(dev):
        err = cuda_lib.build().wf_rebin_interp(
            x.data_ptr(), sa, sb, rows, inner, taps.data_ptr(),
            weights.data_ptr(), P, T, out.data_ptr(), per_block,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rebin_interp kernel launch failed: cudaError "
                           f"{err}")
    cuda_lib.launched("rebin")
    return out


def rebin_gauss(x: torch.Tensor, weights: torch.Tensor,
                renorm: torch.Tensor) -> torch.Tensor:
    """The Gaussian filter of ``x`` [..., P] f32, contiguous: a new tensor,
    bit for bit :func:`rebin_gauss_ref` with ``weights`` [K] f32 (K odd)
    and ``renorm`` [P] f32.  A CPU ``x`` runs the plain version; on CUDA
    anything else raises ValueError."""
    if weights.device != x.device or renorm.device != x.device:
        raise ValueError("rebin_gauss takes its rows and tables on one "
                         "device")
    if x.device.type == "cpu":
        return rebin_gauss_ref(x, [float(w) for w in weights], renorm)
    if x.device.type != "cuda":
        raise ValueError(f"rebin_gauss runs on CUDA or the CPU, got "
                         f"{x.device}")
    K = weights.shape[0] if weights.dim() == 1 else 0
    P = x.shape[-1] if x.dim() else 0
    if (x.dtype != torch.float32 or weights.dtype != torch.float32
            or renorm.dtype != torch.float32 or K % 2 == 0 or P == 0
            or tuple(renorm.shape) != (P,)):
        raise ValueError(
            "rebin_gauss takes [..., P] float32 rows, [K] float32 weights (K "
            f"odd) and [P] float32 renorm; got {x.dtype} {tuple(x.shape)}, "
            f"{weights.dtype} {tuple(weights.shape)}, {renorm.dtype} "
            f"{tuple(renorm.shape)}")
    if not (x.is_contiguous() and weights.is_contiguous()
            and renorm.is_contiguous()):
        raise ValueError("rebin_gauss takes contiguous rows and tables")
    out = torch.empty_like(x)
    dev = x.device
    with torch.cuda.device(dev):
        err = cuda_lib.build().wf_rebin_gauss(
            x.data_ptr(), weights.data_ptr(), K, renorm.data_ptr(),
            out.data_ptr(), x.numel() // P, P,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rebin_gauss kernel launch failed: cudaError "
                           f"{err}")
    cuda_lib.launched("rebin")
    return out
