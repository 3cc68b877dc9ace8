"""The port's renderer (``render/raster.py``, ``colors.py``, ``image.py``)
against the JAX renderer.

The cases mirror ``tests/test_render.py``: each package resolves the same
settings with its own ``resolve``, the same dB input (numpy) goes through
the JAX ``make_renderer`` (jitted) and the port's (``device="cpu"``), and the RGBA
frames must agree within 1e-6; the JAX case's own assertions then run on
the port's frame.  ``ServingEngine.render_frames`` is held to the JAX
engine's on the same packets (xla backend, as the other engine-mechanics
files run it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import _jax_cfg
from waveform_tpu.render import raster as jax_raster
from waveform_tpu.rebin.apply import make_rebin_fn as jax_rebin
from waveform_tpu.render.image import to_rgba8 as jax_to_rgba8
from waveform_tpu.runtime.engine import WaveformEngine as JaxWaveformEngine
from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
from waveform_tpu_torch import (
    RGBA,
    AudioInfo,
    ChannelMode,
    DisplayMode,
    InterpMode,
    PulseMode,
    RenderMode,
    Settings,
    resolve,
)
from waveform_tpu_torch.render import raster
from waveform_tpu_torch.render.image import to_rgba8, write_png
from waveform_tpu_torch.runtime.engine import WaveformEngine
from waveform_tpu_torch.runtime.serving import ServingEngine

NS, SR = 1_000_000_000, 48000
TOL = 1e-6
# The radial rounded cap's coverage divides the edge distance r - sqrt(d2)
# (two numbers near r) by the pixel's footprint: f32 rounds it ~5e-6 from
# float64 in both packages (XLA contracts its multiply-adds into FMAs on
# the CPU, torch does not), 1.2e-6 apart from each other at the worst
# pixel of the case below.
TOL_DISC = 4e-6


def cfg_for(**kw):
    audio = kw.pop("audio", AudioInfo(SR, 2))
    return resolve(Settings(**kw), audio)


def flat_db(cfg, level):
    nbins = cfg.fft_size // 2
    return np.full((cfg.display_channels, nbins), level, np.float32)


def _jax_vals(cfg, db):
    """The JAX renderer's first stage: ``db``'s values on the output axis
    in pixel y, from the JAX rebin (or the meter's dB -> y map)."""
    g = raster.render_geometry(cfg)
    if cfg.meter_mode:
        dbr = float(cfg.ceiling - cfg.floor)
        top, bot = g["border_top"], g["border_bottom"]
        return top + (bot - top) * (jnp.clip(cfg.ceiling - db, 0.0, dbr)
                                    / dbr)
    rebin = jax_rebin(_jax_cfg(cfg), apply_pixel_map=True)
    if cfg.display_mode in (DisplayMode.CURVE, DisplayMode.WAVEFORM):
        return rebin(db, 0.0, g["cpos"] - g["channel_offset"])
    return rebin(db, g["border_top"], g["border_bottom"])


def render_both(cfg, db, tol=TOL):
    """The port's frame of ``db`` (numpy).  Its raster stage, fed the JAX
    rebin's pixel values, gives the JAX frame within ``tol``: the JAX
    renderer runs op by op, as ``tests/test_render.py`` runs it, so no
    fusion rounds its values differently from the ones fed here.  The
    port's own rebin is held to the JAX rebin by ``test_torch_rebin.py``:
    the two sum in different orders, so a value on a pixel row's edge (the
    flat levels below put bar tops on exact rows) may round to either side
    of it; :func:`test_noise_spectrum_frames_batched` holds the two
    renderers whole on noise spectra."""
    want = np.asarray(jax_raster.make_renderer(_jax_cfg(cfg))(db))
    vals = np.array(_jax_vals(cfg, db), np.float32)
    got = raster.make_raster(cfg, device="cpu")(
        torch.from_numpy(vals)[None])[0].numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    return raster.make_renderer(cfg, device="cpu")(torch.from_numpy(db)).numpy()


def test_renderer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        raster.make_renderer(cfg_for(fft_size=256, width=64, height=48))


def test_curve_solid_fill():
    cfg = cfg_for(fft_size=256, width=100, height=100, floor=-100, ceiling=0,
                  interp_mode=InterpMode.POINT)
    img = render_both(cfg, flat_db(cfg, -50.0))
    assert img.shape == (100, 100, 4)
    col = img[:, 50, 3]
    assert (col[:49] == 0).all()
    assert (col[51:] > 0).all()


def test_curve_line_mode():
    cfg = cfg_for(fft_size=256, width=100, height=100, floor=-100, ceiling=0,
                  render_mode=RenderMode.LINE, interp_mode=InterpMode.POINT)
    img = render_both(cfg, flat_db(cfg, -50.0))
    filled = np.nonzero(img[:, 50, 3])[0]
    assert len(filled) <= 3 and 49 <= filled.mean() <= 51


def test_stereo_symmetry():
    cfg = cfg_for(fft_size=256, width=80, height=100,
                  channel_mode=ChannelMode.STEREO, floor=-100, ceiling=0,
                  interp_mode=InterpMode.POINT)
    a = render_both(cfg, flat_db(cfg, -50.0))[:, 40, 3]
    np.testing.assert_array_equal(a[1:50], a[51:100][::-1])
    assert a[25] > 0 and a[75] > 0 and a[5] == 0 and a[95] == 0


def test_bars_and_gaps():
    cfg = cfg_for(fft_size=512, width=90, height=100,
                  display_mode=DisplayMode.BAR, bar_width=20, bar_gap=10,
                  floor=-100, ceiling=0, interp_mode=InterpMode.POINT)
    assert cfg.num_bars == 3
    row = render_both(cfg, flat_db(cfg, -30.0))[80, :, 3]
    assert (row[0:20] > 0).all() and (row[20:30] == 0).all()
    assert (row[30:50] > 0).all() and (row[50:60] == 0).all()


def test_stepped_bars_quantized():
    cfg = cfg_for(fft_size=512, width=60, height=120,
                  display_mode=DisplayMode.STEPPED_BAR, bar_width=20,
                  bar_gap=10, step_width=8, step_gap=4, floor=-120, ceiling=0,
                  interp_mode=InterpMode.POINT)
    filled = np.nonzero(render_both(cfg, flat_db(cfg, -40.0))[:, 5, 3])[0]
    runs = np.split(filled, np.where(np.diff(filled) != 1)[0] + 1)
    assert max(len(r) for r in runs) <= 9 and min(len(r) for r in runs) >= 7


def test_gradient_colors_vary_with_y():
    cfg = cfg_for(fft_size=256, width=60, height=100, floor=-100, ceiling=0,
                  render_mode=RenderMode.GRADIENT,
                  color_base=RGBA(1, 0, 0, 1), color_crest=RGBA(0, 0, 1, 1),
                  interp_mode=InterpMode.POINT)
    col = render_both(cfg, flat_db(cfg, -20.0))[:, 30]
    assert col[25][2] > col[25][0] and col[95][0] > col[95][2]


def test_range_thresholds():
    cfg = cfg_for(fft_size=256, width=40, height=120, floor=-120, ceiling=0,
                  render_mode=RenderMode.RANGE,
                  color_base=RGBA(0, 1, 0, 1), color_middle=RGBA(1, 1, 0, 1),
                  color_crest=RGBA(1, 0, 0, 1), range_middle=-20,
                  range_crest=-9, interp_mode=InterpMode.POINT)
    col = render_both(cfg, flat_db(cfg, -2.0))[:, 20]
    assert col[5][0] > 0.9 and col[5][1] < 0.1
    assert col[15][0] > 0.9 and col[15][1] > 0.9
    assert col[60][1] > 0.9 and col[60][0] < 0.1


def test_pulse_uniform_color():
    cfg = cfg_for(fft_size=256, width=40, height=100, floor=-100, ceiling=0,
                  render_mode=RenderMode.PULSE,
                  color_base=RGBA(0, 0, 0, 1), color_crest=RGBA(1, 1, 1, 1),
                  interp_mode=InterpMode.POINT)
    img = render_both(cfg, flat_db(cfg, -10.0))
    on = img[img[..., 3] > 0]
    assert len(on) > 0 and np.allclose(on, on[0])


def test_pulse_frequency_mode():
    cfg = cfg_for(fft_size=256, width=100, height=100, floor=-100, ceiling=0,
                  render_mode=RenderMode.PULSE,
                  pulse_mode=PulseMode.FREQUENCY,
                  color_base=RGBA(0, 0, 1, 1), color_crest=RGBA(1, 0, 0, 1),
                  interp_mode=InterpMode.POINT, grad_ratio=1.0)
    lo = np.full((1, 128), -90.0, np.float32)
    lo[0, 2:5] = -5.0
    hi = np.full((1, 128), -90.0, np.float32)
    hi[0, 75:90] = -5.0
    img_lo, img_hi = render_both(cfg, lo), render_both(cfg, hi)
    c_lo = img_lo[img_lo[..., 3] > 0][0]
    c_hi = img_hi[img_hi[..., 3] > 0][0]
    assert c_lo[2] > c_lo[0] and c_hi[0] > c_lo[0]


def test_meter_render():
    cfg = cfg_for(display_mode=DisplayMode.METER, bar_width=24, bar_gap=6,
                  floor=-65, ceiling=0)
    img = render_both(cfg, np.array([[-6.0, -30.0]], np.float32))
    col0 = np.nonzero(img[:, 10, 3])[0]
    col1 = np.nonzero(img[:, 40, 3])[0]
    assert len(col0) > len(col1) > 0


def test_rounded_caps_extend_above_bar():
    cfg = cfg_for(fft_size=256, width=60, height=120,
                  display_mode=DisplayMode.BAR, bar_width=20, bar_gap=10,
                  rounded_caps=True, floor=-120, ceiling=0,
                  interp_mode=InterpMode.POINT)
    img = render_both(cfg, flat_db(cfg, -60.0))
    assert np.nonzero(img[:, 9, 3])[0].min() < np.nonzero(img[:, 1, 3])[0].min()


def test_mirror_bars():
    cfg = cfg_for(fft_size=512, width=300, display_mode=DisplayMode.BAR,
                  bar_width=20, bar_gap=5, mirror_freq_axis=True,
                  floor=-100, ceiling=0, interp_mode=InterpMode.POINT)
    img = render_both(cfg, np.linspace(-10, -90, 256, dtype=np.float32)[None])
    heights = []
    for b in range(cfg.num_bars):
        nz = np.nonzero(img[:, b * 25 + 5, 3])[0]
        heights.append(nz.min() if len(nz) else cfg.height)
    half = cfg.num_bars // 2
    for i in range(half + 1, cfg.num_bars):
        assert heights[i] == heights[half - (i - half)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(display_mode=DisplayMode.BAR, bar_width=12, bar_gap=4,
         rounded_caps=True),
    dict(display_mode=DisplayMode.STEPPED_BAR, bar_width=12, bar_gap=4,
         step_width=4, step_gap=2),
    dict(render_mode=RenderMode.LINE),
    dict(display_mode=DisplayMode.BAR, bar_width=12, bar_gap=4,
         channel_mode=ChannelMode.STEREO),
    dict(radial_arc=180.0, radial_rotation=90.0),
    dict(invert_direction=True, render_mode=RenderMode.GRADIENT),
])
def test_radial_modes_render(kw):
    """The direct polar rasterizer in every radial-capable mode (and a
    partial, rotated arc; an inverted gradient): right canvas, empty
    deadzone, lit ring, smooth (fractional) edges."""
    mode = kw.pop("display_mode", DisplayMode.CURVE)
    cfg = cfg_for(fft_size=256, width=120, height=150, radial_layout=True,
                  deadzone=12.0, floor=-100, ceiling=0, display_mode=mode,
                  interp_mode=InterpMode.POINT, **kw)
    img = render_both(cfg, flat_db(cfg, -20.0),
                      TOL_DISC if cfg.rounded_caps else TOL)
    side = int((cfg.height + cfg.deadzone_px) * 2)
    assert img.shape == (side, side, 4)
    c = side // 2
    assert img[c, c, 3] == 0
    assert (img[..., 3] > 0.5).sum() > 100
    assert ((img[..., 3] > 0.05) & (img[..., 3] < 0.95)).sum() > 50


def test_radial_meter_mode_disabled():
    cfg = cfg_for(display_mode=DisplayMode.METER, radial_layout=True,
                  width=60, height=90, bar_width=24, bar_gap=6)
    assert not cfg.radial
    img = render_both(cfg, np.array([[-6.0, -30.0]], np.float32))
    assert img.shape == (90, 60, 4)


def test_radial_waveform_render():
    cfg = cfg_for(display_mode=DisplayMode.WAVEFORM, width=120, height=150,
                  radial_layout=True, deadzone=12.0, floor=-100, ceiling=0)
    assert cfg.radial
    db = np.full((cfg.display_channels, cfg.width), -30.0, np.float32)
    img = render_both(cfg, db)
    c = img.shape[0] // 2
    assert img[c, c, 3] == 0 and (img[..., 3] > 0.5).sum() > 1000


@pytest.mark.parametrize("kw", [
    dict(interp_mode=InterpMode.LANCZOS),
    dict(display_mode=DisplayMode.BAR, bar_width=12, bar_gap=4,
         interp_mode=InterpMode.CATROM, channel_mode=ChannelMode.STEREO,
         channel_spacing=6),
    dict(render_mode=RenderMode.GRADIENT, channel_mode=ChannelMode.STEREO),
])
def test_noise_spectrum_frames_batched(kw):
    """Seeded noise spectra through the smoothing interpolators, a batch
    of three frames at once: the batched renderer gives the JAX
    renderer's frames, and each frame equals its unbatched render."""
    cfg = cfg_for(fft_size=512, width=120, height=80, floor=-90, ceiling=0,
                  **kw)
    rng = np.random.default_rng(7)
    db = rng.uniform(-85, -5, (3, cfg.display_channels, 256)).astype(
        np.float32)
    got = raster.make_renderer(cfg, batched=True, device="cpu")(
        torch.from_numpy(db)).numpy()
    one = raster.make_renderer(cfg, device="cpu")
    jax_render = jax.jit(jax_raster.make_renderer(_jax_cfg(cfg)))
    for b in range(3):
        want = np.asarray(jax_render(db[b]))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=TOL)
        np.testing.assert_array_equal(
            got[b], one(torch.from_numpy(db[b])).numpy())


def test_png_roundtrip(tmp_path):
    cfg = cfg_for(fft_size=256, width=64, height=64,
                  interp_mode=InterpMode.POINT)
    img = render_both(cfg, flat_db(cfg, -20.0))
    p = tmp_path / "frame.png"
    write_png(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IEND" in data
    np.testing.assert_array_equal(to_rgba8(img), jax_to_rgba8(img))


def test_shared_renderer_is_one_per_config():
    cfg = cfg_for(fft_size=256, width=64, height=48)
    a = raster.shared_renderer(cfg, device="cpu")
    assert raster.shared_renderer(cfg, device="cpu") is a
    assert raster.shared_renderer(cfg, batched=True, device="cpu") is not a


def test_single_channel_end_to_end():
    """Single-channel mode picks the configured channel only, in the
    port's WaveformEngine as in the JAX one."""
    cfg = cfg_for(fft_size=1024, channel_mode=ChannelMode.SINGLE, channel=1)
    assert cfg.capture_channels == 1 and cfg.channel_base == 1
    port = WaveformEngine(cfg, 1, device="cpu")
    ref = JaxWaveformEngine(_jax_cfg(cfg), 1, jit=False)
    rng = np.random.default_rng(3)
    now = NS
    for k in range(20):
        t = (np.arange(480) + k * 480) / SR
        x = (0.2 * rng.standard_normal((2, 480))
             + 0.5 * np.stack([np.sin(2 * np.pi * 3000 * t),
                               np.sin(2 * np.pi * 9000 * t)])
             ).astype(np.float32)
        port.feed(0, x, now, now_ns=now)
        ref.feed(0, x, now, now_ns=now)
        now += 480 * NS // SR
    db = port.tick(now_ns=now).numpy()
    want = np.asarray(ref.tick(now_ns=now))
    vis = want > -120
    np.testing.assert_allclose(db[vis], want[vis], rtol=0, atol=1e-4)
    pk = int(np.argmax(db[0, 0])) * SR / cfg.fft_size
    assert abs(pk - 9000) < 2 * SR / cfg.fft_size


@pytest.mark.parametrize("hide", [False, True])
def test_render_frames_batched(hide, monkeypatch):
    """``ServingEngine.render_frames`` renders every stream from the
    device state in one batched call, the JAX engine's frames on the same
    packets.  The unfed stream latches at DB_MIN, under the floor, so its
    frame is blank with and without hide_on_silent."""
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "xla")
    cfg = cfg_for(fft_size=1024, width=64, height=48, hide_on_silent=hide)
    port = ServingEngine(cfg, 2, use_native=False, device="cpu")
    ref = JaxEngine(_jax_cfg(cfg), 2, use_native=False)
    rng = np.random.default_rng(5)
    now = NS
    for _ in range(12):
        x = (0.3 * rng.standard_normal(800)).astype(np.float32)
        for eng in (port, ref):
            eng.feed(0, np.stack([x, x]), now, now_ns=now)
        now += 800 * NS // SR
        for eng in (port, ref):
            eng.tick(now_ns=now)
    imgs = port.render_frames().numpy()
    want = np.asarray(ref.render_frames())
    assert imgs.shape == (2, 48, 64, 4)
    np.testing.assert_allclose(imgs, want, rtol=0, atol=TOL)
    assert imgs[0].max() > 0.5
    assert imgs[1].max() == 0.0 and bool(port.last_silent[1])
