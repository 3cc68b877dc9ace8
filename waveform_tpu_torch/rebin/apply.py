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
from .filter import build_gauss_tables
from .interp import build_interp_tables, mirror_indices

DENSE_MAX_BINS = 8192


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


def check_full_f32_matmul() -> None:
    """Raise unless float32 matrix products run in full float32.

    The dense interp product needs every mantissa bit (a reduced-precision
    variant failed the 1e-4 dB gate), so TF32 or bf16 internal precision
    is refused here rather than switched off behind the caller's back.
    """
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the rebin needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def make_rebin_fn(cfg: ResolvedConfig, *, apply_pixel_map: bool = True,
                  device: torch.device | str = "cuda",
                  dense: bool | None = None):
    """Build ``rebin(db [..., nbins]) -> [..., P]`` for the resolved config
    on ``device`` (the card unless the caller asks for the CPU; raises
    RuntimeError without one).

    ``top``/``bottom`` are the pixel-map endpoints (curve mode uses
    ``(0, cpos - channel_offset)``, bars ``(border_top, border_bottom)``);
    with ``apply_pixel_map=False`` the output stays in dBFS.

    ``dense`` picks the interp form: one [nbins, P] f32 matmul, or a
    gather of the taps and a weighted sum.  With ``dense=None``,
    ``WAVEFORM_TPU_REBIN`` = ``dense`` or ``gather`` (read here, as the JAX
    package reads it) forces the form; otherwise it is dense on CUDA up to
    ``DENSE_MAX_BINS`` input bins (the matrix stays a few MB) and the
    gather elsewhere.  The dense form raises unless float32 matmuls run
    in full float32 (:func:`check_full_f32_matmul`).
    """
    check_config(cfg)
    device = checked_device(device, "make_rebin_fn")
    tables = build_interp_tables(cfg)
    nbins_in = (cfg.fft_size if cfg.display_mode == DisplayMode.WAVEFORM
                else cfg.num_bins)
    if dense is None:
        mode = os.environ.get("WAVEFORM_TPU_REBIN", "auto")
        dense = (mode == "dense" if mode in ("dense", "gather") else
                 device.type == "cuda" and nbins_in <= DENSE_MAX_BINS)
    if dense:
        check_full_f32_matmul()
        imat = torch.from_numpy(_interp_matrix(
            tables.taps, tables.weights, nbins_in)).to(device)
    else:
        taps = torch.from_numpy(tables.taps.astype(np.int64)).to(device)
        weights = torch.from_numpy(tables.weights).to(device)      # [P, T]
    band = (None if tables.band_matrix is None
            else torch.from_numpy(tables.band_matrix).to(device))  # [B, P]

    n_out = tables.num_outputs
    use_gauss = cfg.filter_mode == FilterMode.GAUSS and not cfg.meter_mode
    if use_gauss:
        gt = build_gauss_tables(cfg.settings.filter_radius, n_out)
        gw = [float(w) for w in gt.weights]
        grenorm = torch.from_numpy(gt.renorm).to(device)
        pad = (len(gw) - 1) // 2
    if cfg.mirror_freq_axis:
        mirror = torch.from_numpy(
            mirror_indices(n_out).astype(np.int64)).to(device)
    dbrange = float(cfg.ceiling - cfg.floor)

    def rebin(db: torch.Tensor, top: float = 0.0,
              bottom: float = 0.0) -> torch.Tensor:
        if dense:
            vals = _rows_mm(db, imat)
        else:
            gathered = db[..., taps]                       # [..., P, T]
            vals = (gathered * weights).sum(-1)
        if band is not None:
            vals = _rows_mm(vals, band.T)
        if use_gauss:
            # zero-padded conv divided by the per-pixel valid-weight sum is
            # exactly the reference's edge renormalization
            padded = torch.nn.functional.pad(vals, (pad, pad))
            smoothed = torch.zeros_like(vals)
            for j, w in enumerate(gw):
                smoothed = smoothed + padded[..., j:j + vals.shape[-1]] * w
            vals = smoothed / grenorm
        if apply_pixel_map:
            t = torch.clamp(cfg.ceiling - vals, 0.0, dbrange) / dbrange
            vals = top + (bottom - top) * t
        if cfg.mirror_freq_axis:
            vals = vals[..., mirror]
        return vals

    return rebin
