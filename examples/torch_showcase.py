"""Showcase on the PyTorch port: one audio clip through every display and
render mode, as one collage PNG:

    python examples/torch_showcase.py [--out showcase.png] [--device cpu]

The ``waveform_tpu_torch`` counterpart of ``examples/showcase.py``, with
the same panels and signal.  Rows: curve solid, curve gradient+gauss,
curve line, bars, bars range, bars caps+pulse, stepped stereo bars,
waveform, meters, radial gradient.  Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import waveform_tpu_torch as wt  # noqa: E402
from waveform_tpu_torch.render.image import write_png  # noqa: E402
from waveform_tpu_torch.render.raster import make_renderer  # noqa: E402
from waveform_tpu_torch.runtime.engine import WaveformEngine  # noqa: E402

NS, SR = 1_000_000_000, 48000


def music(n: int, t0: int) -> np.ndarray:
    """Harmonic stack + noise floor — music-like test signal."""
    t = (np.arange(n) + t0) / SR
    x = sum(a * np.sin(2 * np.pi * f * t) for f, a in
            [(110, 0.5), (220, 0.35), (440, 0.3), (880, 0.2),
             (1760, 0.12), (3520, 0.07), (7040, 0.04)])
    x += 0.002 * np.random.default_rng(t0 & 0xFFFF).standard_normal(n)
    return x.astype(np.float32)


PANELS = [
    ("curve solid", dict()),
    ("curve gradient+gauss", dict(
        render_mode=wt.RenderMode.GRADIENT, filter_mode=wt.FilterMode.GAUSS,
        color_base=wt.RGBA(0.1, 0.9, 0.3, 1), color_crest=wt.RGBA(1, 0.2, 0.1, 1))),
    ("curve line", dict(render_mode=wt.RenderMode.LINE,
                        color_base=wt.RGBA(0.3, 0.7, 1.0, 1))),
    ("bars", dict(display_mode=wt.DisplayMode.BAR,
                  color_base=wt.RGBA(0.9, 0.7, 0.1, 1))),
    ("bars range", dict(
        display_mode=wt.DisplayMode.BAR, render_mode=wt.RenderMode.RANGE,
        color_base=wt.RGBA(0, 0.8, 0, 1), color_middle=wt.RGBA(1, 1, 0, 1),
        color_crest=wt.RGBA(1, 0, 0, 1), range_middle=-30, range_crest=-15)),
    ("bars caps pulse", dict(
        display_mode=wt.DisplayMode.BAR, rounded_caps=True,
        render_mode=wt.RenderMode.PULSE,
        color_base=wt.RGBA(0.2, 0.2, 0.9, 1), color_crest=wt.RGBA(1, 0.5, 0, 1))),
    ("stepped stereo", dict(
        display_mode=wt.DisplayMode.STEPPED_BAR,
        channel_mode=wt.ChannelMode.STEREO, channel_spacing=6,
        color_base=wt.RGBA(0.8, 0.3, 0.9, 1))),
    ("waveform", dict(display_mode=wt.DisplayMode.WAVEFORM, meter_buf=150,
                      color_base=wt.RGBA(0.2, 0.9, 0.9, 1))),
    ("meter", dict(display_mode=wt.DisplayMode.METER, bar_width=40,
                   bar_gap=10, render_mode=wt.RenderMode.RANGE,
                   color_base=wt.RGBA(0, 0.8, 0, 1),
                   color_middle=wt.RGBA(1, 1, 0, 1),
                   color_crest=wt.RGBA(1, 0, 0, 1))),
    ("radial gradient", dict(
        radial_layout=True, deadzone=18.0, height=360,
        render_mode=wt.RenderMode.GRADIENT,
        color_base=wt.RGBA(0.1, 0.4, 1.0, 1), color_crest=wt.RGBA(1, 1, 1, 1))),
]


def render_panel(kw: dict, device="cuda") -> np.ndarray:
    """40 ticks of the signal through one stream of ``kw``'s settings, then
    the last frame rendered: RGBA [H, W, 4] f32 in [0, 1]."""
    cfg = wt.resolve(
        wt.Settings(fft_size=4096, width=760,
                    height=kw.pop("height", 150), **kw),
        wt.AudioInfo(SR, 2))
    eng = WaveformEngine(cfg, 1, device=device)
    now, ph = NS, 0
    out = None
    for k in range(40):
        x = music(800, ph)
        ph += 800
        eng.feed(0, np.stack([x, x * 0.85]), now, now_ns=now)
        now += 800 * NS // SR
        out = eng.tick(now_ns=now)
    render = make_renderer(cfg, device=device)
    return render(torch.as_tensor(out[0]).to(device)).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="showcase.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    imgs = []
    width = 800
    for name, kw in PANELS:
        img = render_panel(dict(kw), args.device)
        h, w = img.shape[:2]
        canvas = np.zeros((h + 10, width, 4), np.float32)
        canvas[5:5 + h, (width - w) // 2:(width - w) // 2 + w] = img
        # opaque dark background so every mode is visible
        bg = np.array([0.08, 0.08, 0.1, 1.0], np.float32)
        alpha = canvas[..., 3:4]
        canvas = canvas * alpha + bg * (1 - alpha)
        imgs.append(canvas)
        print(f"  rendered: {name}")
    collage = np.concatenate(imgs, axis=0)
    write_png(args.out, collage)
    print(f"wrote {args.out} ({collage.shape[1]}x{collage.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
