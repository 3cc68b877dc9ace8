"""Rasterizer: the reference's vertex+shader render path as tensor ops.

The PyTorch counterpart of ``waveform_tpu/render/raster.py`` (XLA code in
the JAX package, no Pallas kernel).  Where the reference builds triangle
strips on the CPU and lets the GPU shade them
(/root/reference/src/source.cpp:1360-1670 + data/gradient.effect), this
renderer computes per-pixel coverage and color directly on an [H, W]
grid — branch-free masks instead of geometry; the radial layout evaluates
the same masks at precomputed polar graph coordinates.  Every function
draws a batch of frames at once (the JAX package's ``jax.vmap`` over the
stream axis becomes a leading frame axis of every tensor).

Geometry parity:
* curve solid/line fills & polyline spans (render_curve, src:1360-1471)
* bars / stepped bars with bar_width/gap, step_width/gap, min_bar_height
  (render_bars, src:1473-1670; init_steps src:920-933)
* rounded caps as disc masks at bar ends (cap verts src:1292-1309)
* stereo split about cpos with channel_spacing (src:1372-1373,1486-1494)
* meter mode: one bar per channel through the bar path (src:1505-1509)
* radial: masks/colors evaluated directly at polar coordinates
  (gradient.effect:43-59 warps vertices and shades in polar space): the
  per-pixel graph coordinates are static per config, so the warp
  precomputes to constants and each frame costs the rectangular path's
  elementwise mask math plus two gathers from its [W] values.  Edges are
  analytically antialiased (coverage from signed distances, the angular
  edge width scaled by the local pixel footprint).

Input bins are in natural order (the JAX renderer's ``bin_perm``, the
TPU engine's block bin order, has no counterpart in the port).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import ResolvedConfig, check_config
from ..core.device import checked_device
from ..core.enums import DisplayMode, RenderMode
from ..rebin.apply import make_rebin_fn
from .colors import pixel_colors, pulse_color_value


def render_geometry(cfg: ResolvedConfig) -> dict:
    """The constants update()/render derive before drawing."""
    Hh = cfg.height
    center = Hh / 2.0
    bottom = float(Hh)
    cpos = center if cfg.stereo else bottom
    channel_offset = cfg.channel_spacing * 0.5
    cap_radius = cfg.settings.bar_width / 2.0 if cfg.rounded_caps else 0.0
    border_top = cap_radius
    border_bottom = (cpos - cap_radius
                     if cfg.rounded_caps and (not cfg.stereo
                                              or cfg.channel_spacing > 0)
                     else cpos)
    if cfg.channel_spacing > 0:
        border_bottom -= channel_offset
    if cfg.settings.min_bar_height > 0:
        border_bottom -= cfg.settings.min_bar_height
    border_bottom = min(max(border_bottom, border_top), cpos)
    return dict(height=Hh, width=cfg.width, cpos=cpos, bottom=bottom,
                channel_offset=channel_offset, cap_radius=cap_radius,
                border_top=border_top, border_bottom=border_bottom)


def _polar_fields(cfg: ResolvedConfig, g: dict, device) -> dict:
    """Static per-pixel graph coordinates for the radial layout.

    VSRadial (gradient.effect:43-59) maps graph (x, y) to polar canvas
    coordinates; inverting it per OUTPUT pixel depends only on config, so
    the graph-space y (YG), the fractional column (XQ, with its floor X0,
    ceiling X1 and fraction FX for value interpolation), the column
    footprint of one output pixel (XS, for angular-edge antialiasing) and
    the angular seam coverage (ACOV) precompute in numpy once per
    renderer, as the JAX renderer computes them."""
    Hh, Ww = g["height"], g["width"]
    dz = cfg.deadzone_px
    R = Hh + dz
    side = int(R * 2)
    py = np.arange(side, dtype=np.float64)[:, None] - R
    px = np.arange(side, dtype=np.float64)[None, :] - R
    rho = np.hypot(px, py)
    ang = np.arctan2(-px, py)
    ang = (ang - cfg.radial_rotation) % (2.0 * math.pi)
    arc = max(cfg.radial_arc, 1e-6) * 2.0 * math.pi
    xg = ang / arc * (Ww - 1)
    yg = rho - dz
    if cfg.invert:
        yg = Hh - yg
    rho_safe = np.maximum(rho, 1.0)
    # angular-seam coverage for partial arcs (edge width scales with rho,
    # the arc-length px per radian).  The radial rims need no coverage
    # term of their own: every mask's y-interval is clamped to the canvas
    # [0, Hh] before coverage, so the rim feather is computed once.
    if cfg.radial_arc < 1.0:
        acov = (np.clip((arc - ang) * rho_safe + 0.5, 0.0, 1.0)
                * np.clip(ang * rho_safe + 0.5, 0.0, 1.0))
    else:
        acov = np.ones_like(rho)
    x0 = np.clip(np.floor(xg), 0, Ww - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, Ww - 1).astype(np.int64)
    fx = np.clip(xg, 0, Ww - 1) - x0
    xscale = (Ww - 1) / (arc * rho_safe)   # graph columns per output px

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    f32 = np.float32
    return dict(side=side, YG=put(yg.astype(f32)), XQ=put(xg.astype(f32)),
                X0=put(x0), X1=put(x1), FX=put(fx.astype(f32)),
                XS=put(xscale.astype(f32)), ACOV=put(acov.astype(f32)))


def make_renderer(cfg: ResolvedConfig, batched: bool = False,
                  device: torch.device | str = "cuda"):
    """Build ``render(db [D, nbins]) -> RGBA image [outH, outW, 4] f32`` on
    ``device`` (the card unless the caller asks for the CPU; raises
    RuntimeError without one).  ``batched=True`` renders a leading frame
    axis: ``db [B, D, nbins] -> [B, outH, outW, 4]``.

    For meter mode pass the meter values as ``db [1, num_bars]`` (already
    dBFS).  Waveform mode passes its dB pixel buffer [D, width].  The
    render is two stages: the values on the output axis in pixel y (the
    rebin, or the meter's dB -> y map), then :func:`make_raster`'s
    coverage and colors.
    """
    check_config(cfg)
    device = checked_device(device, "make_renderer")
    g = render_geometry(cfg)
    if cfg.meter_mode:
        dbr = float(cfg.ceiling - cfg.floor)
        top, bot = g["border_top"], g["border_bottom"]

        def to_y(db):
            t = torch.clamp(cfg.ceiling - db, 0.0, dbr) / dbr
            return top + (bot - top) * t
    else:
        rebin = make_rebin_fn(cfg, apply_pixel_map=True, device=device)
        if cfg.display_mode in (DisplayMode.CURVE, DisplayMode.WAVEFORM):
            top, bot = 0.0, g["cpos"] - g["channel_offset"]
        else:
            top, bot = g["border_top"], g["border_bottom"]

        def to_y(db):
            return rebin(db, top, bot)

    draw = make_raster(cfg, device)
    if batched:
        return lambda db: draw(to_y(db))
    return lambda db: draw(to_y(db[None]))[0]


def make_raster(cfg: ResolvedConfig, device: torch.device | str = "cuda"):
    """Build ``draw(vals [B, D, n]) -> RGBA [B, outH, outW, 4] f32``: the
    renderer's second stage, from the frames' values on the output axis
    in pixel y (``n`` pixels for curves and waveforms, one value a bar
    for bars and meters) to coverage and color."""
    check_config(cfg)
    device = checked_device(device, "make_raster")
    g = render_geometry(cfg)
    Hh, Ww = g["height"], g["width"]
    cpos, bottom = g["cpos"], g["bottom"]
    channel_offset = g["channel_offset"]
    curve_like = cfg.display_mode in (DisplayMode.CURVE, DisplayMode.WAVEFORM)
    line_mode = cfg.render_mode == RenderMode.LINE and curve_like
    D = cfg.display_channels
    num_bars = 0 if curve_like else cfg.num_bars

    rows = torch.arange(Hh, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(Ww, dtype=torch.float32, device=device)[None, :]

    bar_stride = cfg.settings.bar_width + cfg.settings.bar_gap
    step_stride = cfg.settings.step_width + cfg.settings.step_gap
    stepped = cfg.display_mode in (DisplayMode.STEPPED_BAR,
                                   DisplayMode.STEPPED_METER)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def _channel_mask(vals_px, channel):
        """Coverage mask [B, H, W] for one display channel of the frames'
        values ``vals_px`` [B, n]."""
        if curve_like:
            ytop = vals_px if channel == 0 else bottom - vals_px   # [B, W]
            if line_mode:
                prev = torch.cat([ytop[:, :1], ytop[:, :-1]], dim=-1)
                lo = torch.minimum(ytop, prev)[:, None, :]
                hi = torch.maximum(ytop, prev)[:, None, :]
                return (rows >= lo - 0.5) & (rows <= hi + 0.5)
            bot_y = (cpos - channel_offset if channel == 0
                     else cpos + channel_offset)
            if channel == 0:
                return (rows >= ytop[:, None, :]) & (rows <= bot_y)
            return (rows <= ytop[:, None, :]) & (rows >= bot_y)

        # bars / stepped bars / meters
        bar_idx = torch.div(cols, bar_stride,
                            rounding_mode="floor").to(torch.int32)  # [1, W]
        in_bar = (((cols - bar_idx * bar_stride) < cfg.settings.bar_width)
                  & (bar_idx < num_bars))
        bar_idx_c = torch.clamp(bar_idx, 0, max(num_bars - 1, 0))
        val = vals_px[:, bar_idx_c[0].long()][:, None, :]     # [B, 1, W]

        if stepped:
            maxheight = cpos - val - channel_offset
            if channel == 0:
                d = cpos - channel_offset - rows              # [H, 1]
            else:
                d = rows - cpos - channel_offset
            j = torch.floor(d / step_stride)
            in_cell = (d - j * step_stride) <= cfg.settings.step_width
            lit = (j >= 0) & (j * step_stride < maxheight) & (d >= 0)
            return in_bar & in_cell & lit

        offset = g["cap_radius"] + channel_offset
        use_off = ((cfg.rounded_caps and not cfg.stereo)
                   or cfg.channel_spacing > 0)
        if channel == 0:
            bot_y = cpos - offset if use_off else cpos
            mask = (rows >= val) & (rows <= bot_y)
        else:
            topv = bottom - val
            bot_y = cpos + offset if use_off else cpos
            mask = (rows <= topv) & (rows >= bot_y)

        if cfg.rounded_caps:
            ccx = bar_idx_c * bar_stride + g["cap_radius"]   # [1, W]
            ccy = val if channel == 0 else bottom - val
            dist2 = (cols - ccx) ** 2 + (rows - ccy) ** 2
            mask = mask | (in_bar & (dist2 <= g["cap_radius"] ** 2))
            if use_off:
                ccy2 = cpos - offset if channel == 0 else cpos + offset
                dist2b = (cols - ccx) ** 2 + (rows - ccy2) ** 2
                mask = mask | (in_bar & (dist2b <= g["cap_radius"] ** 2))
        return mask & in_bar

    P = _polar_fields(cfg, g, device) if cfg.radial else None

    def _interval_cov(a, b, y, w=1.0):
        """Fractional coverage of interval [a, b] by a pixel of footprint
        ``w`` centered at ``y`` (analytic antialiasing)."""
        return torch.clamp((torch.minimum(f32(b), y + 0.5 * w)
                            - torch.maximum(f32(a), y - 0.5 * w)) / w,
                           0.0, 1.0)

    def _channel_cov_polar(vals_px, channel):
        """Polar analog of _channel_mask: fractional coverage [B, side,
        side] evaluated directly at the graph coordinates (YG, XQ).  Every
        y-interval is clamped to the canvas [0, Hh], so the radial rim
        feather is part of the same interval coverage."""
        YG, XQ, XS = P["YG"], P["XQ"], P["XS"]

        def ycov(a, b):
            return _interval_cov(torch.clamp_min(f32(a), 0.0),
                                 torch.clamp_max(f32(b), float(Hh)), YG)

        if curve_like:
            v0 = vals_px[:, P["X0"]]
            v1 = vals_px[:, P["X1"]]
            if channel != 0:
                v0, v1 = bottom - v0, bottom - v1
            if line_mode:
                lo = torch.minimum(v0, v1) - 0.5
                hi = torch.maximum(v0, v1) + 0.5
                return ycov(lo, hi)
            ytop = v0 * (1.0 - P["FX"]) + v1 * P["FX"]
            if channel == 0:
                return ycov(ytop, cpos - channel_offset)
            return ycov(cpos + channel_offset, ytop)

        # bars / stepped bars / meters
        bar_idx = torch.floor(XQ / bar_stride)
        in_bar_n = (bar_idx < num_bars).to(torch.float32)
        bar_idx_c = torch.clamp(bar_idx, 0, max(num_bars - 1, 0)).long()
        start = bar_idx_c.to(torch.float32) * bar_stride
        bw = float(cfg.settings.bar_width)
        covx = _interval_cov(start, start + bw, XQ, XS)
        val = vals_px[:, bar_idx_c]

        if stepped:
            maxheight = cpos - val - channel_offset
            if channel == 0:
                d = cpos - channel_offset - YG
            else:
                d = YG - cpos - channel_offset
            j = torch.floor(d / step_stride)
            dc = d - j * step_stride
            covc = _interval_cov(0.0, float(cfg.settings.step_width), dc)
            lit = ((j >= 0) & (j * step_stride < maxheight)).to(torch.float32)
            return covx * covc * lit * in_bar_n

        offset = g["cap_radius"] + channel_offset
        use_off = ((cfg.rounded_caps and not cfg.stereo)
                   or cfg.channel_spacing > 0)
        if channel == 0:
            bot_y = cpos - offset if use_off else cpos
            cov = ycov(val, bot_y)
        else:
            topv = bottom - val
            bot_y = cpos + offset if use_off else cpos
            cov = ycov(bot_y, topv)

        if cfg.rounded_caps:
            r = g["cap_radius"]

            def disc_cov(ccy):
                # graph-space disc; the edge width per output pixel blends
                # the angular (XS) and radial (1) footprints by direction
                dx = XQ - (start + r)
                dy = YG - ccy
                d2 = dx * dx + dy * dy
                dd = torch.sqrt(d2)
                w = (XS * dx * dx + dy * dy) / torch.clamp_min(d2, 1e-6)
                return torch.clamp((r - dd) / torch.clamp_min(w, 1e-6) + 0.5,
                                   0.0, 1.0)

            cov = torch.maximum(cov, disc_cov(val if channel == 0
                                              else bottom - val))
            if use_off:
                cov = torch.maximum(
                    cov, disc_cov(cpos - offset if channel == 0
                                  else cpos + offset))
        return cov * covx * in_bar_n

    def draw(vals: torch.Tensor) -> torch.Tensor:
        B = vals.shape[0]
        flat = vals.reshape(B, -1)
        mini = torch.argmin(flat, dim=-1)
        miny = flat.gather(-1, mini[:, None])[:, 0]                 # [B]
        minpos = (mini % vals.shape[-1]).to(torch.float32)

        # --- shader uniforms (src/source.cpp:1693-1743) ---
        if curve_like:
            bt, bb = 0.0, cpos - channel_offset
        else:
            bt, bb = g["border_top"], g["border_bottom"]
        if cfg.render_mode == RenderMode.GRADIENT:
            grad_height = ((cpos - miny - channel_offset)
                           * cfg.settings.grad_ratio)[:, None, None]
        else:  # RANGE (and unused otherwise)
            grad_height = cpos - channel_offset
        grad_center, grad_offset = cpos, channel_offset
        pulse = (pulse_color_value(cfg, miny, minpos, bt, bb,
                                   vals.shape[-1])[:, None, None, :]
                 if cfg.render_mode == RenderMode.PULSE else None)
        channels = range(D if not cfg.meter_mode else 1)

        if cfg.radial:
            # direct polar rasterization: colors at the graph-space y of
            # each output pixel (VSRadial passes UNWARPED coordinates to
            # the pixel shader, gradient.effect:51-57)
            colors = pixel_colors(cfg, P["YG"], grad_center, grad_height,
                                  grad_offset, pulse)
            img = torch.zeros((B, P["side"], P["side"], 4),
                              dtype=torch.float32, device=device)
            for ch in channels:
                v = vals[:, ch] if not cfg.meter_mode else vals[:, 0]
                cov = _channel_cov_polar(v, ch) * P["ACOV"]
                img = img + (colors - img) * cov[..., None]
            return img

        # per-row colors depend only on y
        ygrid = rows.expand(Hh, Ww)
        colors = pixel_colors(cfg, ygrid, grad_center, grad_height,
                              grad_offset, pulse)
        img = torch.zeros((B, Hh, Ww, 4), dtype=torch.float32, device=device)
        for ch in channels:
            v = vals[:, ch] if not cfg.meter_mode else vals[:, 0]
            img = torch.where(_channel_mask(v, ch)[..., None], colors, img)
        return img

    return draw


_SHARED: dict = {}


def shared_renderer(cfg: ResolvedConfig, batched: bool = False,
                    device: torch.device | str = "cuda"):
    """The process-wide renderer of a config, shared by every consumer of
    it — ``OutputBus``, ``MultiEngine`` and direct callers build ONE
    renderer (its rebin tables and polar fields) per (config, batched,
    device) instead of each keeping its own (the reference shares one
    effect shader across all sources, src/source.cpp:939-943; the JAX
    package's ``jitted_renderer``)."""
    key = (cfg, batched, torch.device(device))
    fn = _SHARED.get(key)
    if fn is None:
        fn = _SHARED[key] = make_renderer(cfg, batched=batched, device=device)
    return fn
