"""OBS-compatible settings serialization.

The reference persists its ~50 settings in OBS's scene-collection JSON via
the ``obs_data_t`` key/value store (reference src/settings.hpp key
names; defaults at src/source.cpp:119-174).  A user migrating from the
plugin can paste that JSON block here: :func:`settings_from_obs` consumes
the same keys (including packed ABGR color ints and the enum strings) and
:func:`settings_to_obs` round-trips back.

The port's own copy of ``waveform_tpu/core/settings_io.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import fields

from .config import RGBA, Settings
from .enums import (
    ChannelMode,
    DisplayMode,
    FFTWindow,
    FilterMode,
    InterpMode,
    PulseMode,
    RenderMode,
    TSmoothingMode,
)

_ENUM_FIELDS = {
    "display_mode": DisplayMode,
    "channel_mode": ChannelMode,
    "window": FFTWindow,
    "interp_mode": InterpMode,
    "filter_mode": FilterMode,
    "temporal_smoothing": TSmoothingMode,
    "render_mode": RenderMode,
    "pulse_mode": PulseMode,
}
_COLOR_FIELDS = ("color_base", "color_middle", "color_crest")


def _rgba_to_abgr_u32(c: RGBA) -> int:
    def q(v):
        return int(round(max(0.0, min(1.0, v)) * 255.0))
    return q(c.r) | (q(c.g) << 8) | (q(c.b) << 16) | (q(c.a) << 24)


def settings_from_obs(data: dict) -> Settings:
    """Build :class:`Settings` from an OBS scene-JSON settings dict.

    Unknown keys are ignored (OBS stores extra bookkeeping); missing keys
    take the reference defaults, exactly as ``obs_data_get_*`` would.
    """
    kwargs = {}
    valid = {f.name for f in fields(Settings)}
    for key, value in data.items():
        if key not in valid:
            continue
        if key in _ENUM_FIELDS:
            try:
                kwargs[key] = _ENUM_FIELDS[key](value)
            except ValueError:
                continue  # unknown enum string -> keep default, like p_equ
        elif key in _COLOR_FIELDS:
            kwargs[key] = RGBA.from_abgr_u32(int(value))
        else:
            kwargs[key] = value
    return Settings(**kwargs)


def settings_to_obs(s: Settings) -> dict:
    """Serialize to the reference's key/value representation."""
    out = {}
    for f in fields(Settings):
        v = getattr(s, f.name)
        if f.name in _ENUM_FIELDS:
            out[f.name] = v.value
        elif f.name in _COLOR_FIELDS:
            out[f.name] = _rgba_to_abgr_u32(v)
        else:
            out[f.name] = v
    return out


def load_settings(path: str) -> Settings:
    with open(path) as f:
        return settings_from_obs(json.load(f))


def save_settings(path: str, s: Settings) -> None:
    with open(path, "w") as f:
        json.dump(settings_to_obs(s), f, indent=2, sort_keys=True)
