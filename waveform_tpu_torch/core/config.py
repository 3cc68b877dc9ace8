"""Configuration surface for Waveform-TPU.

Two layers, mirroring the reference plugin's split between the raw OBS
settings store and the derived state computed in ``WAVSource::update()``:

* :class:`Settings` — the ~50 user-facing keys with the same names, defaults
  (reference src/source.cpp:119-174) and slider ranges
  (reference src/source.cpp:176-463) as the reference property sheet.
* :class:`ResolvedConfig` — everything ``update()`` derives before the hot
  loop runs: clamped/aligned FFT size, per-mode fixups (meter/waveform reuse
  the FFT buffer for raw samples), channel counts, radial geometry, bar
  counts (reference src/source.cpp:1077-1322, 501-674).

The resolved config is a frozen dataclass: it is hashable and is used as the
static (compile-time) argument of the jitted pipeline, playing the role FFTW
"plans" and the precomputed member buffers play in the reference.

The port's own copy of ``waveform_tpu/core/config.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

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

# 20*log10(FLT_MIN): silence floor in dBFS (reference: src/source.cpp:43).
DB_MIN = 20.0 * math.log10(1.1754943508222875e-38)

# Audio capture is considered lost after 500 ms (reference: src/source.hpp:290).
CAPTURE_TIMEOUT_NS = 500 * 1_000_000
# Clamp for bogus audio timestamps, 16 s (reference: src/source.hpp:291).
MAX_TS_DELTA_NS = 16 * 1_000_000_000
# Seconds between audio-capture reattach attempts (reference: src/source.hpp:289).
RETRY_DELAY_S = 2.0


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


@dataclass(frozen=True)
class RGBA:
    """Color as float32 0..1 components (reference packs ABGR uint32)."""

    r: float = 1.0
    g: float = 1.0
    b: float = 1.0
    a: float = 1.0

    @classmethod
    def from_abgr_u32(cls, value: int) -> "RGBA":
        # reference: src/source.cpp:558-560 (byte order R | G<<8 | B<<16 | A<<24)
        return cls(
            (value & 0xFF) / 255.0,
            ((value >> 8) & 0xFF) / 255.0,
            ((value >> 16) & 0xFF) / 255.0,
            ((value >> 24) & 0xFF) / 255.0,
        )


@dataclass(frozen=True)
class Settings:
    """Raw user settings; names/defaults match the reference property sheet."""

    audio_source: str = "none"
    display_mode: DisplayMode = DisplayMode.CURVE
    width: int = 800
    height: int = 225
    log_scale: bool = True
    mirror_freq_axis: bool = False
    radial_layout: bool = False
    invert_direction: bool = False
    deadzone: float = 20.0          # percent, 0..100
    radial_arc: float = 360.0       # degrees
    radial_rotation: float = 0.0    # degrees
    rounded_caps: bool = False
    channel_mode: ChannelMode = ChannelMode.MONO
    channel: int = 0
    channel_spacing: int = 0
    fft_size: int = 4096
    auto_fft_size: bool = False
    enable_large_fft: bool = False
    window: FFTWindow = FFTWindow.HANN
    sine_exponent: int = 2
    interp_mode: InterpMode = InterpMode.CATROM
    filter_mode: FilterMode = FilterMode.NONE
    filter_radius: float = 1.5
    temporal_smoothing: TSmoothingMode = TSmoothingMode.EXPONENTIAL
    gravity: float = 0.65
    fast_peaks: bool = False
    cutoff_low: int = 30
    cutoff_high: int = 17500
    floor: int = -65
    ceiling: int = 0
    slope: float = 0.0
    rolloff_q: float = 0.0
    rolloff_rate: float = 0.0
    render_mode: RenderMode = RenderMode.SOLID
    pulse_mode: PulseMode = PulseMode.MAGNITUDE
    color_base: RGBA = RGBA()
    color_middle: RGBA = RGBA()
    color_crest: RGBA = RGBA()
    grad_ratio: float = 0.75
    range_middle: int = -20
    range_crest: int = -9
    bar_width: int = 24
    bar_gap: int = 6
    step_width: int = 8
    step_gap: int = 4
    min_bar_height: int = 0
    meter_buf: int = 150            # ms of audio for meter/waveform modes
    rms_mode: bool = True
    hide_on_silent: bool = False
    ignore_mute: bool = False
    normalize_volume: bool = False
    volume_target: int = -8         # dBFS
    max_gain: int = 30              # dB
    audio_sync_offset: int = 0      # ms, -1000..1000


@dataclass(frozen=True)
class AudioInfo:
    """Host audio configuration (reference: obs_audio_info)."""

    samples_per_sec: int = 44100
    channels: int = 2  # channels of the captured source's speaker layout


@dataclass(frozen=True)
class VideoInfo:
    """Host video configuration (reference: obs_video_info)."""

    fps: float = 60.0


@dataclass(frozen=True)
class ResolvedConfig:
    """Derived, validated configuration — the static half of the pipeline.

    Mirrors what ``WAVSource::update()`` + ``get_settings()`` leave in member
    state (reference: src/source.cpp:501-674, 1077-1322).
    """

    settings: Settings
    audio: AudioInfo
    video: VideoInfo

    # derived geometry
    width: int = 0
    height: int = 0
    deadzone_px: float = 0.0

    # derived DSP state
    display_mode: DisplayMode = DisplayMode.CURVE
    channel_mode: ChannelMode = ChannelMode.MONO
    stereo: bool = False
    meter_mode: bool = False
    fft_size: int = 0               # samples per frame (or ring size in meter/waveform mode)
    window: FFTWindow = FFTWindow.HANN
    sine_exponent: int = 2
    interp_mode: InterpMode = InterpMode.CATROM
    filter_mode: FilterMode = FilterMode.NONE
    tsmoothing: TSmoothingMode = TSmoothingMode.EXPONENTIAL
    gravity: float = 0.65
    fast_peaks: bool = False
    slope: float = 0.0
    mirror_freq_axis: bool = False
    log_scale: bool = True
    radial: bool = False
    rounded_caps: bool = False
    normalize_volume: bool = False
    pulse_mode: PulseMode = PulseMode.MAGNITUDE
    render_mode: RenderMode = RenderMode.SOLID
    cutoff_low: int = 30
    cutoff_high: int = 17500
    floor: int = -65
    ceiling: int = 0
    rolloff_q: float = 0.0
    rolloff_rate: float = 0.0
    channel_spacing: int = 0
    channel_base: int = 0
    capture_channels: int = 0       # input channels fed to the DSP (<=2)
    output_channels: int = 1        # FFT output channels (1 or 2)
    num_bars: int = 0
    waveform_samples: int = 0
    meter_ms: int = 150
    meter_rms: bool = True
    ts_offset_ns: int = 0
    volume_target: float = -8.0
    max_gain: float = 30.0
    input_rms_size: int = 0
    radial_arc: float = 1.0         # fraction of full circle
    radial_rotation: float = 0.0    # radians
    invert: bool = False
    fps: float = 60.0

    @property
    def spectrum_mode(self) -> bool:
        return not self.meter_mode and self.display_mode != DisplayMode.WAVEFORM

    @property
    def num_bins(self) -> int:
        """FFT output bins actually used (below Nyquist, reference keeps N/2)."""
        return self.fft_size // 2

    @property
    def display_channels(self) -> int:
        return 2 if self.stereo else 1


def align_down16(v: int) -> int:
    return v & ~15


def _clamp_to_property_ranges(s: Settings) -> Settings:
    """Clamp numeric settings to the property-sheet slider ranges
    (core/properties.py, mirroring src/source.cpp:176-463).

    The reference trusts its UI sliders to bound these values, but scene
    JSON arrives unbounded — a hand-edited file with width=-4 would feed
    negative geometry straight into the renderer.  The resolver enforces
    the same contract the dialog does.  fft_size keeps its bespoke rule
    (enable_large_fft unlocks sizes past the slider max,
    src/source.cpp:359-363); the cutoffs clamp to their 0–24000 sliders
    here and the inverted pair additionally RESETS in resolve()
    (:567-577).
    """
    from .properties import PROPERTIES
    skip = {"fft_size"}
    updates = {}
    for p in PROPERTIES:
        if p.kind not in ("int", "float") or p.key in skip:
            continue
        if p.minimum is None and p.maximum is None:
            continue
        v = getattr(s, p.key, None)
        if v is None:
            continue
        lo = -math.inf if p.minimum is None else p.minimum
        hi = math.inf if p.maximum is None else p.maximum
        c = min(max(v, lo), hi)
        if c != v:
            updates[p.key] = int(c) if p.kind == "int" else float(c)
    return dataclasses.replace(s, **updates) if updates else s


def resolve(settings: Settings, audio: AudioInfo | None = None,
            video: VideoInfo | None = None) -> ResolvedConfig:
    """Apply every validation/clamp/fixup rule of the reference ``update()``.

    Reference walkthrough: src/source.cpp:501-674 (get_settings clamps),
    1088-1167 (channel counts, meter/waveform fixups, auto FFT size),
    1269-1276 (bar count); numeric settings clamp to the property-sheet
    slider ranges first (see _clamp_to_property_ranges).
    """
    audio = audio or AudioInfo()
    video = video or VideoInfo()
    s = _clamp_to_property_ranges(settings)

    width = int(s.width)
    height = int(s.height)

    # --- fft size clamp/alignment (source.cpp:562-565) ---
    fft_size = int(s.fft_size)
    if fft_size < 128:
        fft_size = 128
    elif fft_size & 15:
        fft_size = align_down16(fft_size)
    max_fft = (1 << 16) if s.enable_large_fft else 8192
    fft_size = min(fft_size, max_fft)

    # --- cutoff / floor-ceiling sanity (source.cpp:567-577) ---
    cutoff_low, cutoff_high = int(s.cutoff_low), int(s.cutoff_high)
    if cutoff_high - cutoff_low < 0:
        cutoff_high, cutoff_low = 17500, 120
    floor, ceiling = int(s.floor), int(s.ceiling)
    if ceiling - floor < 1:
        ceiling, floor = 0, -120

    stereo = s.channel_mode == ChannelMode.STEREO
    channel_spacing = int(s.channel_spacing)
    if not stereo or (height - channel_spacing) < 1:
        channel_spacing = 0

    display_mode = s.display_mode
    meter_mode = display_mode in (DisplayMode.METER, DisplayMode.STEPPED_METER)

    rounded_caps = s.rounded_caps
    if display_mode not in (DisplayMode.BAR, DisplayMode.METER):
        rounded_caps = False

    radial = s.radial_layout and not meter_mode

    # --- channel config (source.cpp:1088-1103) ---
    max_channels = int(audio.channels)
    capture_channels = min(max_channels, 2)
    channel_base = int(s.channel)
    channel_mode = s.channel_mode
    if meter_mode and channel_mode == ChannelMode.SINGLE:
        channel_mode = ChannelMode.MONO
    if channel_mode == ChannelMode.SINGLE:
        if channel_base < 0 or channel_base >= max_channels:
            capture_channels = 0
            channel_base = 0
        else:
            capture_channels = min(capture_channels, 1)
    else:
        channel_base = 0
    stereo_resolved = not meter_mode and channel_mode == ChannelMode.STEREO

    # --- per-mode fixups (source.cpp:1106-1143) ---
    window = s.window
    interp_mode = s.interp_mode
    filter_mode = s.filter_mode
    pulse_mode = s.pulse_mode
    auto_fft_size = s.auto_fft_size
    slope = float(s.slope)
    mirror = s.mirror_freq_axis
    log_scale = s.log_scale
    normalize_volume = s.normalize_volume
    waveform_samples = 0

    if meter_mode:
        window = FFTWindow.NONE
        interp_mode = InterpMode.POINT
        filter_mode = FilterMode.NONE
        pulse_mode = PulseMode.MAGNITUDE
        auto_fft_size = False
        slope = 0.0
        stereo_resolved = False
        radial = False
        normalize_volume = False
        mirror = False
        fft_size = align_down16(int(audio.samples_per_sec * (s.meter_buf / 1000.0)))
    elif display_mode == DisplayMode.WAVEFORM:
        window = FFTWindow.NONE
        pulse_mode = PulseMode.MAGNITUDE
        auto_fft_size = False
        slope = 0.0
        mirror = False
        log_scale = False
        fft_size = width
        waveform_samples = int(audio.samples_per_sec * (s.meter_buf / 1000.0))

    # --- radial geometry (source.cpp:658-666) ---
    deadzone_px = 0.0
    if radial:
        height //= 2
        max_deadzone = float(height - 16)
        if rounded_caps:
            max_deadzone = max(max_deadzone - s.bar_width, 0.0)
        deadzone_px = min(math.floor(height * (s.deadzone / 100.0)), max_deadzone)
        height -= int(deadzone_px)

    # --- auto fft size from fps (source.cpp:1155-1167) ---
    fps = float(video.fps) if video.fps > 0 else 60.0
    if auto_fft_size:
        fft_size = align_down16(int(audio.samples_per_sec / fps))
        if fft_size < 128:
            fft_size = 128

    output_channels = 2 if (capture_channels > 1 or stereo_resolved) else 1

    # --- bar count (source.cpp:1269-1276) ---
    num_bars = 0
    if display_mode in (DisplayMode.BAR, DisplayMode.STEPPED_BAR):
        bar_stride = int(s.bar_width) + int(s.bar_gap)
        num_bars = width // bar_stride
        if (width - num_bars * bar_stride) >= s.bar_width:
            num_bars += 1
    elif meter_mode:
        num_bars = capture_channels

    input_rms_size = align_down16(int(audio.samples_per_sec)) if normalize_volume else 0

    return ResolvedConfig(
        settings=s,
        audio=audio,
        video=video,
        width=width,
        height=height,
        deadzone_px=deadzone_px,
        display_mode=display_mode,
        channel_mode=channel_mode,
        stereo=stereo_resolved,
        meter_mode=meter_mode,
        fft_size=fft_size,
        window=window,
        sine_exponent=_clamp(int(s.sine_exponent), 1, 16),
        interp_mode=interp_mode,
        filter_mode=filter_mode,
        tsmoothing=s.temporal_smoothing,
        gravity=float(s.gravity),
        fast_peaks=bool(s.fast_peaks),
        slope=slope,
        mirror_freq_axis=mirror,
        log_scale=log_scale,
        radial=radial,
        rounded_caps=rounded_caps,
        normalize_volume=normalize_volume,
        pulse_mode=pulse_mode,
        render_mode=s.render_mode,
        cutoff_low=cutoff_low,
        cutoff_high=cutoff_high,
        floor=floor,
        ceiling=ceiling,
        rolloff_q=float(s.rolloff_q),
        rolloff_rate=float(s.rolloff_rate),
        channel_spacing=channel_spacing,
        channel_base=channel_base,
        capture_channels=capture_channels,
        output_channels=output_channels,
        num_bars=num_bars,
        waveform_samples=waveform_samples,
        meter_ms=int(s.meter_buf),
        meter_rms=bool(s.rms_mode),
        ts_offset_ns=int(s.audio_sync_offset) * 1_000_000,
        volume_target=float(s.volume_target),
        max_gain=float(s.max_gain),
        input_rms_size=input_rms_size,
        radial_arc=float(s.radial_arc) / 360.0,
        radial_rotation=(float(s.radial_rotation) / 360.0) * (2.0 * math.pi),
        invert=bool(s.invert_direction),
        fps=fps,
    )


def check_config(cfg) -> ResolvedConfig:
    """Return ``cfg`` if it is this package's :class:`ResolvedConfig`, else
    raise TypeError.

    The port's entry points take only configs from this package's
    :func:`resolve`: one resolved by another package (the JAX package's
    ``resolve``) carries that package's enum classes, and the port's
    branches would compare members across two enum classes.
    """
    if not isinstance(cfg, ResolvedConfig):
        raise TypeError(
            "expected a ResolvedConfig from waveform_tpu_torch.resolve, got "
            f"{type(cfg).__module__}.{type(cfg).__qualname__}")
    return cfg
