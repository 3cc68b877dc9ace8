"""Property sheet: UI metadata + visibility rules for the settings surface.

The reference drives its OBS configuration dialog from a property list with
slider ranges, suffixes, and ~20 ``modified_callback`` visibility rules
(reference src/source.cpp:176-463) plus locale string tables
(data/locale/*.ini).  Front-ends embedding Waveform-TPU get the same
contract here: :data:`PROPERTIES` describes each key (kind, range, step,
suffix, choices) and :func:`visible_properties` evaluates the same
visibility logic against a :class:`Settings` instance.

The port's own copy of ``waveform_tpu/core/properties.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

from .config import Settings
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


@dataclass(frozen=True)
class Property:
    key: str
    kind: str                      # bool | int | float | enum | color | text
    label: str
    minimum: float | None = None
    maximum: float | None = None
    step: float | None = None
    suffix: str = ""
    choices: tuple = ()
    tooltip: str = ""


def _p(*args, **kw) -> Property:
    return Property(*args, **kw)


# Ranges mirror the reference sliders (src/source.cpp:176-463); tooltips
# cover the same 20 keys the reference attaches long descriptions to
# (src/source.cpp:197-441, data/locale/en-US.ini:114-133).
PROPERTIES: tuple[Property, ...] = (
    _p("audio_source", "text", "Audio source"),
    _p("audio_sync_offset", "int", "Audio sync offset", -1000, 1000, 10, " ms",
       tooltip="Positive values delay the visuals relative to the audio; "
               "negative values depend on the source buffering ahead."),
    _p("hide_on_silent", "bool", "Hide when silent"),
    _p("ignore_mute", "bool", "Ignore mute",
       tooltip="Keep analyzing audio while the source is muted."),
    _p("normalize_volume", "bool", "Normalize volume",
       tooltip="Rescale the graph on the fly to cancel out loudness "
               "changes in the input."),
    _p("volume_target", "int", "Normalization target", -60, 0, 1, " dBFS"),
    _p("max_gain", "int", "Maximum gain", 0, 45, 1, " dB"),
    _p("display_mode", "enum", "Display style", choices=tuple(DisplayMode)),
    _p("bar_width", "int", "Bar width", 1, 256, 1),
    _p("bar_gap", "int", "Bar spacing", 0, 256, 1),
    _p("step_width", "int", "Step height", 1, 256, 1),
    _p("step_gap", "int", "Step spacing", 0, 256, 1),
    _p("min_bar_height", "int", "Minimum bar height", 0, 1080, 1),
    _p("width", "int", "Width", 32, 3840, 1),
    _p("height", "int", "Height", 32, 2160, 1),
    _p("log_scale", "bool", "Logarithmic frequency axis"),
    _p("mirror_freq_axis", "bool", "Mirror frequency axis",
       tooltip="Reflect the graph horizontally about its center."),
    _p("radial_layout", "bool", "Radial layout"),
    _p("invert_direction", "bool", "Invert direction"),
    _p("deadzone", "float", "Dead zone", 0.0, 100.0, 0.1, "%",
       tooltip="How much empty space to keep at the center of the radial "
               "layout."),
    _p("radial_arc", "float", "Arc", 0.0, 360.0, 0.1, "°",
       tooltip="Angular span of the radial display, in degrees."),
    _p("radial_rotation", "float", "Rotation", 0.0, 360.0, 0.1, "°"),
    _p("rounded_caps", "bool", "Rounded caps",
       tooltip="Cap the top and bottom of each bar with a semicircle."),
    _p("rms_mode", "bool", "RMS metering"),
    _p("meter_buf", "int", "Audio buffer", 10, 600000, 10, " ms"),
    _p("channel_mode", "enum", "Channels", choices=tuple(ChannelMode),
       tooltip="Draw left/right separately, fold to a mono mix, or pick "
               "one capture channel."),
    _p("channel", "int", "Channel index", 0, 7, 1),
    _p("channel_spacing", "int", "Channel spacing", 0, 2160, 1),
    _p("auto_fft_size", "bool", "Automatic FFT size",
       tooltip="Derive the FFT size from the frame rate and sample rate. "
               "Kept only for old scenes - leave this off."),
    _p("enable_large_fft", "bool", "Allow large FFT sizes",
       tooltip="Unlock FFT sizes past 8192; expect noticeably higher "
               "latency and resource use."),
    _p("fft_size", "int", "FFT size", 128, 8192, 64,
       tooltip="Bigger transforms resolve finer frequency detail at the "
               "cost of compute and latency."),
    _p("window", "enum", "Window function", choices=tuple(FFTWindow),
       tooltip="Taper applied to each FFT frame."),
    _p("sine_exponent", "int", "Sine exponent", 1, 16, 1),
    _p("temporal_smoothing", "enum", "Temporal smoothing",
       choices=tuple(TSmoothingMode),
       tooltip="Average frequency bins over time to calm per-frame "
               "jitter."),
    _p("gravity", "float", "Gravity", 0.0, 1.0, 0.01,
       tooltip="How fast the graph tracks new input; higher values "
               "linger longer."),
    _p("fast_peaks", "bool", "Fast peak tracking",
       tooltip="Let bins jump immediately on rising magnitude - pairs "
               "well with a slow moving average."),
    _p("interp_mode", "enum", "Interpolation", choices=tuple(InterpMode),
       tooltip="How frequency bins are resampled onto display pixels."),
    _p("filter_mode", "enum", "Smoothing filter", choices=tuple(FilterMode),
       tooltip="Smooth the curve along the frequency axis."),
    _p("filter_radius", "float", "Filter radius", 0.0, 32.0, 0.01),
    _p("cutoff_low", "int", "Low cutoff", 0, 24000, 1, " Hz"),
    _p("cutoff_high", "int", "High cutoff", 0, 24000, 1, " Hz"),
    _p("floor", "int", "Floor", -120, 0, 1, " dBFS"),
    _p("ceiling", "int", "Ceiling", -120, 0, 1, " dBFS"),
    _p("slope", "float", "Slope", 0.0, 10.0, 0.01,
       tooltip="Tilt the spectrum upward so high frequencies read "
               "louder."),
    _p("rolloff_q", "float", "Roll-off band", 0.0, 10.0, 0.01,
       tooltip="Fade the graph edges starting this many octaves inside "
               "the cutoff points."),
    _p("rolloff_rate", "float", "Roll-off rate", 0.0, 65.0, 0.01,
       tooltip="Edge attenuation strength, in decibels per octave."),
    _p("render_mode", "enum", "Render style", choices=tuple(RenderMode)),
    _p("pulse_mode", "enum", "Pulse tracks", choices=tuple(PulseMode)),
    _p("color_base", "color", "Base color"),
    _p("color_middle", "color", "Middle color"),
    _p("color_crest", "color", "Crest color"),
    _p("grad_ratio", "float", "Gradient ratio", 0.0, 4.0, 0.01),
    _p("range_middle", "int", "Middle threshold", -120, 0, 1, " dBFS"),
    _p("range_crest", "int", "Crest threshold", -120, 0, 1, " dBFS"),
)

PROPERTY_MAP = {p.key: p for p in PROPERTIES}


def visible_properties(s: Settings) -> set[str]:
    """Which properties a dialog should show for the current settings.

    The union of the reference's modified_callback rules
    (src/source.cpp:184-460), flattened into one pure function.
    """
    vis = {p.key for p in PROPERTIES}
    d = s.display_mode
    meter = d in (DisplayMode.METER, DisplayMode.STEPPED_METER)
    step = d in (DisplayMode.STEPPED_BAR, DisplayMode.STEPPED_METER)
    bar = d in (DisplayMode.BAR, DisplayMode.METER)
    curve = d == DisplayMode.CURVE
    waveform = d == DisplayMode.WAVEFORM
    notmeter = not meter

    def drop(*keys):
        vis.difference_update(keys)

    if not (bar or step):
        drop("bar_width", "bar_gap", "min_bar_height")
    if not step:
        drop("step_width", "step_gap")
    if not bar:
        drop("rounded_caps")
    if meter or waveform:
        drop("slope", "rolloff_q", "rolloff_rate", "cutoff_low",
             "cutoff_high", "window", "sine_exponent", "auto_fft_size",
             "fft_size", "enable_large_fft", "log_scale", "mirror_freq_axis")
    if meter:
        drop("filter_mode", "filter_radius", "interp_mode", "channel_mode",
             "channel", "channel_spacing", "radial_layout", "deadzone",
             "radial_arc", "radial_rotation", "invert_direction", "width",
             "normalize_volume", "volume_target", "max_gain")
    else:
        drop("rms_mode")
        if not waveform:
            drop("meter_buf")
    if waveform:
        drop("temporal_smoothing", "gravity", "fast_peaks")
    elif s.temporal_smoothing == TSmoothingMode.NONE:
        drop("gravity", "fast_peaks")
    if notmeter:
        if s.channel_mode != ChannelMode.SINGLE:
            drop("channel")
        if s.channel_mode != ChannelMode.STEREO:
            drop("channel_spacing")
        if not s.radial_layout:
            drop("deadzone", "radial_arc", "radial_rotation",
                 "invert_direction")
    if "window" in vis and s.window != FFTWindow.POWER_OF_SINE:
        drop("sine_exponent")
    if "filter_mode" in vis and s.filter_mode == FilterMode.NONE:
        drop("filter_radius")
    if s.render_mode not in (RenderMode.GRADIENT, RenderMode.PULSE):
        drop("grad_ratio")
    if s.render_mode != RenderMode.RANGE:
        drop("range_middle", "range_crest")
    if s.render_mode != RenderMode.PULSE:
        drop("pulse_mode")
    if not (s.normalize_volume and "normalize_volume" in vis):
        drop("volume_target", "max_gain")
    if s.audio_source == "output_bus":
        drop("ignore_mute")
    return vis
