"""Rebin: the render-time resampling of dB bins onto pixels or bars.

The PyTorch counterpart of ``waveform_tpu/rebin/apply.py``.  Per frame and
display channel: interp (Lanczos / Catmull-Rom / point) -> optional bar
band averaging -> optional Gaussian smoothing -> optional dB->pixel map ->
optional mirroring (reference src/source.cpp:1380-1424, 1505-1564).
The tables come from the numpy builders in ``rebin/interp.py`` and
``rebin/filter.py``; input bins are in natural order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.config import ResolvedConfig, check_config
from ..core.device import checked_device
from ..core.enums import DisplayMode, FilterMode
from ..kernels.rebin_cuda import (rebin_gauss, rebin_gauss_ref, rebin_interp,
                                  rebin_interp_ref)
from ..runtime import profiler
from .filter import build_gauss_tables
from .interp import build_interp_tables, mirror_indices


def _interp_matrix(taps: np.ndarray, weights: np.ndarray,
                   nbins: int) -> np.ndarray:
    """The interp stage as a dense [nbins, P] matrix: column p carries
    weight[p, t] at row taps[p, t] (duplicate taps from edge clamping
    accumulate, matching the gather+sum)."""
    P, T = taps.shape
    m = np.zeros((nbins, P), np.float32)
    np.add.at(m, (taps, np.broadcast_to(np.arange(P)[:, None], (P, T))),
              weights.astype(np.float32))
    return m


def _rows_mm(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[..., K] @ [K, P] as one 2-D GEMM over all leading rows (a batched
    matmul of a [S, D, K] view runs as S separate GEMVs on CUDA)."""
    out = torch.mm(x.reshape(-1, x.shape[-1]), m)
    return out.reshape(*x.shape[:-1], m.shape[-1])


def filters(cfg: ResolvedConfig) -> bool:
    """Whether the rebin of ``cfg`` runs the Gaussian filter (a meter mode
    never does)."""
    return cfg.filter_mode == FilterMode.GAUSS and not cfg.meter_mode


def check_full_f32_matmul(who: str = "the rebin") -> None:
    """Raise unless float32 matrix products run in full float32.

    The CPU's forced dense interp product needs every mantissa bit (a
    reduced-precision variant failed the 1e-4 dB gate), and so does the
    matmul FFT (``kernels/matfft.py``): TF32 or bf16 internal precision
    is refused here rather than switched off behind the caller's back.
    """
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{who} needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def make_rebin_fn(cfg: ResolvedConfig, *, apply_pixel_map: bool = True,
                  device: torch.device | str = "cuda",
                  dense: bool | None = None,
                  pixels: tuple[int, int] | None = None):
    """Build ``rebin(db [..., nbins]) -> [..., P]`` for the resolved config
    on ``device`` (the card unless the caller asks for the CPU; raises
    RuntimeError without one).

    ``top``/``bottom`` are the pixel-map endpoints (curve mode uses
    ``(0, cpos - channel_offset)``, bars ``(border_top, border_bottom)``);
    with ``apply_pixel_map=False`` the output stays in dBFS.

    On CUDA the interp and the Gaussian filter run as two hand-written
    kernels (``kernels/rebin_cuda.py``, one launch each, counted as
    ``LAUNCHES["rebin"]``), and nothing else: a forced form raises
    ValueError there.  On the CPU they run as the plain gather of the taps
    and a weighted sum, and the padded filter loop; ``dense=True`` forces
    one [nbins, P] f32 matmul in place of the gather, and with
    ``dense=None`` ``WAVEFORM_TPU_REBIN`` = ``dense`` or ``gather`` (read
    here, as the JAX package reads it) picks the form.  The dense form
    raises unless float32 matmuls run in full float32
    (:func:`check_full_f32_matmul`).

    ``pixels=(p0, p1)`` returns output columns ``[p0, p1)`` only: one
    block of a mesh's pixel axis (``parallel/sharded_serving.py``, the
    JAX package's ``pixel_constraint``).  Each output column of the interp
    stage reads only its own taps, so the block keeps columns ``[p0, p1)``
    of the dense matrix, or rows ``[p0, p1)`` of the taps and weights, and
    computes nothing else.  Bar bands, the Gaussian filter and mirroring
    mix columns, so under any of them the whole row is rebinned and the
    block cut from it.
    """
    check_config(cfg)
    device = checked_device(device, "make_rebin_fn")
    tables = build_interp_tables(cfg)
    nbins_in = (cfg.fft_size if cfg.display_mode == DisplayMode.WAVEFORM
                else cfg.num_bins)
    if dense is None:
        mode = os.environ.get("WAVEFORM_TPU_REBIN", "auto")
        if mode in ("dense", "gather"):
            dense = mode == "dense"
    kernels = device.type == "cuda"
    if kernels and dense is not None:
        raise ValueError(
            "make_rebin_fn: on CUDA the rebin runs its kernels; the forced "
            "dense and gather forms (dense=, WAVEFORM_TPU_REBIN) are the "
            "CPU's")
    interp, smooth = ((rebin_interp, rebin_gauss) if kernels
                      else (rebin_interp_ref, rebin_gauss_ref))
    n_out = tables.num_outputs
    use_gauss = filters(cfg)
    cols = slice(None)       # the interp columns computed
    cut = None               # the block cut from a whole rebinned row
    if pixels is not None:
        p0, p1 = pixels
        if not 0 <= p0 < p1 <= n_out:
            raise ValueError(f"pixels {pixels} outside [0, {n_out})")
        if (tables.band_matrix is None and not use_gauss
                and not cfg.mirror_freq_axis):
            cols = slice(p0, p1)
        else:
            cut = slice(p0, p1)
    if dense:
        check_full_f32_matmul()
        imat = torch.from_numpy(np.ascontiguousarray(_interp_matrix(
            tables.taps, tables.weights, nbins_in)[:, cols])).to(device)
    else:
        taps = torch.from_numpy(tables.taps[cols].astype(
            np.int32 if kernels else np.int64)).to(device)
        weights = torch.from_numpy(
            np.ascontiguousarray(tables.weights[cols])).to(device)  # [P, T]
    band = (None if tables.band_matrix is None
            else torch.from_numpy(tables.band_matrix).to(device))  # [B, P]
    if use_gauss:
        gt = build_gauss_tables(cfg.settings.filter_radius, n_out)
        gw = (torch.from_numpy(gt.weights).to(device) if kernels
              else [float(w) for w in gt.weights])
        grenorm = torch.from_numpy(gt.renorm).to(device)
    if cfg.mirror_freq_axis:
        mirror = torch.from_numpy(
            mirror_indices(n_out).astype(np.int64)).to(device)
    dbrange = float(cfg.ceiling - cfg.floor)

    def rebin(db: torch.Tensor, top: float = 0.0,
              bottom: float = 0.0) -> torch.Tensor:
        vals = _rows_mm(db, imat) if dense else interp(db, taps, weights)
        if band is not None:
            vals = _rows_mm(vals, band.T)
        if use_gauss:
            profiler.mark("tick.interp")
            vals = smooth(vals, gw, grenorm)
            profiler.mark("tick.filter")
        if apply_pixel_map:
            t = torch.clamp(cfg.ceiling - vals, 0.0, dbrange) / dbrange
            vals = top + (bottom - top) * t
        if cfg.mirror_freq_axis:
            vals = vals[..., mirror]
        if cut is not None:
            vals = vals[..., cut]
        return vals

    return rebin
