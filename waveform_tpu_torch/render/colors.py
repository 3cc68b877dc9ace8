"""Color pipeline: the effect shader's pixel math as tensor ops.

The PyTorch counterpart of ``waveform_tpu/render/colors.py``.  Re-states
the techniques of the reference's HLSL effect
(/root/reference/data/gradient.effect) in inverse-mapped raster form:

* Solid   — constant ``color_base`` (PSSolid, gradient.effect:61-64)
* Gradient— ``lerp(base, crest, saturate((|y-center|-offset)/height))``
            (PSGradient, :66-70)
* Range   — 3-color threshold on ``1-saturate(...)`` vs range_middle/crest
            (PSRange, :72-80)
* Pulse   — frame-uniform color lerped by peak magnitude or frequency,
            computed per frame (src/source.cpp:1695-1709)

Values that differ per frame (the gradient height, the pulse color) may
carry a leading frame axis shaped to broadcast against the raster's
``y``: the renderer draws a batch of frames at once.
"""

from __future__ import annotations

import torch

from ..core.config import RGBA, ResolvedConfig
from ..core.enums import PulseMode, RenderMode


def _vec(c: RGBA, device) -> torch.Tensor:
    return torch.tensor([c.r, c.g, c.b, c.a], dtype=torch.float32,
                        device=device)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def pixel_colors(cfg: ResolvedConfig, y: torch.Tensor, grad_center: float,
                 grad_height, grad_offset: float,
                 pulse_color: torch.Tensor | None = None) -> torch.Tensor:
    """Colors ``[..., 4]`` at the raster's row coordinates ``y``, in a
    shape that broadcasts against ``[..., *y.shape, 4]``.

    ``grad_height``/``grad_center``/``grad_offset`` follow set_shader_vars
    (src/source.cpp:1693-1743); ``grad_height`` is a tensor that
    broadcasts against ``y`` in the gradient mode (it follows the frame's
    peak) and a number in the range mode, ``pulse_color`` a ``[..., 4]``
    tensor whose leading axes broadcast against ``y``.
    """
    s = cfg.settings
    dev = y.device
    base, crest, middle = (_vec(c, dev) for c in (
        s.color_base, s.color_crest, s.color_middle))
    if cfg.render_mode == RenderMode.PULSE and pulse_color is not None:
        return pulse_color
    if cfg.render_mode == RenderMode.GRADIENT:
        t = saturate((torch.abs(y - grad_center) - grad_offset)
                     / torch.clamp_min(grad_height, 1e-9))
        return base + (crest - base) * t[..., None]
    if cfg.render_mode == RenderMode.RANGE:
        ratio = 1.0 - saturate((torch.abs(y - grad_center) - grad_offset)
                               / max(grad_height, 1e-9))
        # normalized thresholds (src/source.cpp:1738-1741)
        range_middle = (s.range_middle - cfg.ceiling) / cfg.floor
        range_crest = (s.range_crest - cfg.ceiling) / cfg.floor
        return torch.where((ratio > range_middle)[..., None], base,
                           torch.where((ratio < range_crest)[..., None],
                                       crest, middle))
    return base


def pulse_color_value(cfg: ResolvedConfig, miny: torch.Tensor,
                      minpos: torch.Tensor, border_top: float,
                      border_bottom: float,
                      num_positions: int) -> torch.Tensor:
    """Frame-uniform pulse color ``[..., 4]`` for the frames' ``miny`` and
    ``minpos`` ``[...]`` (src/source.cpp:1695-1709)."""
    s = cfg.settings
    base, crest = _vec(s.color_base, miny.device), _vec(s.color_crest,
                                                        miny.device)
    rng = border_bottom - border_top
    if cfg.pulse_mode == PulseMode.MAGNITUDE:
        t = saturate((border_bottom - miny) / (rng * s.grad_ratio))
    else:
        t = saturate(minpos / ((num_positions - 1) * s.grad_ratio))
    return base + (crest - base) * t[..., None]
