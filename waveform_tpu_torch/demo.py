"""Demo CLI: analyze a WAV file into rendered frames on the card.

The PyTorch counterpart of ``waveform_tpu/demo.py``, the file → frames
loop that stands in for OBS (audio from capture callbacks, frames to the
compositor):

    python -m waveform_tpu_torch.demo input.wav --out frames/ \
        --settings scene.json [--fps 60] [--max-frames N] [--every K]

Reads the WAV (stdlib ``wave``; 16/24/32-bit PCM), replays it through the
serving engine at the configured fps with real A/V-sync timestamps,
renders each written tick with the configured display and render modes,
and writes PNG frames; then prints the profiler summary (frames/s, p99,
MFLOPS).  It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np
import torch


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Load a WAV as planar float32 [channels, samples] + sample rate."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        # could be int32 or float32; WAVE_FORMAT tag isn't exposed by the
        # stdlib, so use the common convention: PCM int32
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x /= float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return x.reshape(-1, ch).T.copy(), sr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wav", help="input WAV file")
    ap.add_argument("--out", default="frames", help="output directory")
    ap.add_argument("--settings", default=None,
                    help="JSON settings (OBS scene block compatible)")
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stop after N frames (0 = whole file)")
    ap.add_argument("--every", type=int, default=1,
                    help="write every Nth frame as PNG")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from . import AudioInfo, Settings, VideoInfo, resolve
    from .core.device import checked_device
    from .core.settings_io import load_settings
    from .render.image import write_png
    from .render.raster import make_renderer
    from .runtime.engine import WaveformEngine
    from .runtime.profiler import FrameProfiler
    from .runtime.serving import ServingEngine
    from .utils.log import get_logger, log_startup_banner

    dev = checked_device(args.device, "demo")
    log = get_logger()
    log_startup_banner(dev)

    audio, sr = read_wav(args.wav)
    C, total = audio.shape
    log.info("WAV: %s — %d ch, %d Hz, %.2f s", args.wav, C, sr, total / sr)
    if C == 1:
        audio = np.vstack([audio, audio])

    settings = load_settings(args.settings) if args.settings else Settings()
    cfg = resolve(settings, AudioInfo(sr, min(audio.shape[0], 2)),
                  VideoInfo(args.fps))
    log.info("config: %s %s fft=%d %s", cfg.display_mode.value,
             cfg.window.value, cfg.fft_size, cfg.render_mode.value)

    # spectrum configs ride the device-resident serving path; meter and
    # oscilloscope configs ride the per-stream engine (same feed/tick)
    if cfg.spectrum_mode:
        engine = ServingEngine(cfg, num_streams=1, device=dev)
        read_values = engine.read_decibels
    else:
        engine = WaveformEngine(cfg, num_streams=1, device=dev)
        read_values = engine.render_values
    render = make_renderer(cfg, device=dev)
    prof = FrameProfiler(num_streams=1, fft_size=cfg.fft_size)
    os.makedirs(args.out, exist_ok=True)

    def tick(now: int) -> None:
        engine.tick(now_ns=now)
        if dev.type == "cuda":   # time the device's work, not the enqueue
            torch.cuda.synchronize(dev)

    NS = 1_000_000_000
    hop = int(sr / args.fps)
    n_frames = total // hop
    if args.max_frames:
        n_frames = min(n_frames, args.max_frames)
    now = NS
    written = 0
    for k in range(n_frames):
        chunk = audio[:2, k * hop:(k + 1) * hop]
        engine.feed(0, chunk, now, now_ns=now)
        now += hop * NS // sr
        if k == 0:
            tick(now)   # first tick builds and captures; keep stats clean
            continue
        with prof.tick():
            tick(now)
        if k % args.every == 0:
            if settings.hide_on_silent and bool(engine.last_silent[0]):
                continue  # render() early-return (src/source.cpp:1349-1350)
            vals = torch.from_numpy(np.ascontiguousarray(read_values()[0]))
            img = render(vals.to(dev)).cpu().numpy()
            write_png(os.path.join(args.out, f"frame_{k:06d}.png"), img)
            written += 1

    st = prof.stats()
    log.info("%d ticks, %d PNGs → %s", n_frames, written, args.out)
    if st:
        log.info("%.2f ms/tick (p99 %.2f ms), %.0f frames/s, %.0f MFLOPS",
                 st["ms_per_tick"], st["p99_ms"], st["frames_per_sec"],
                 st["fft_mflops"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
