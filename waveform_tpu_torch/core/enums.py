"""Enumerations for the Waveform-TPU configuration surface.

These mirror the mode enums of the reference plugin (see
reference src/source.hpp:32-93) so that a user of the reference finds
the same vocabulary here.  String values match the reference's settings keys
(reference src/settings.hpp) so serialized configs are interchangeable.

The port's own copy of ``waveform_tpu/core/enums.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum


class FFTWindow(str, enum.Enum):
    NONE = "none"
    HANN = "hann"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackman_harris"
    POWER_OF_SINE = "power_of_sine"


class InterpMode(str, enum.Enum):
    POINT = "point"
    LANCZOS = "lanczos"
    CATROM = "catmull_rom"


class FilterMode(str, enum.Enum):
    NONE = "none"
    GAUSS = "gauss"


class TSmoothingMode(str, enum.Enum):
    NONE = "none"
    EXPONENTIAL = "exp_moving_avg"
    TVEXPONENTIAL = "tv_exp_moving_avg"


class RenderMode(str, enum.Enum):
    LINE = "line"
    SOLID = "solid"
    GRADIENT = "gradient"
    PULSE = "pulse"
    RANGE = "range"


class PulseMode(str, enum.Enum):
    MAGNITUDE = "peak_magnitude"
    FREQUENCY = "peak_frequency"


class DisplayMode(str, enum.Enum):
    CURVE = "curve"
    BAR = "bars"
    STEPPED_BAR = "stepped_bars"
    METER = "level_meter"
    STEPPED_METER = "stepped_level_meter"
    WAVEFORM = "waveform"


class ChannelMode(str, enum.Enum):
    MONO = "mono"
    STEREO = "stereo"
    SINGLE = "single"
