"""Live real-time audio ingestion into the PyTorch port's OutputBus.

The ``waveform_tpu_torch`` counterpart of ``examples/live_ingest.py``: a
feeder thread pushes ~10 ms float32 packets into a shared
:class:`~waveform_tpu_torch.runtime.bus.OutputBus` with wall-clock
timestamps, and the main loop ticks at 60 fps.  Three looks (spectrum
curve, stereo bars, level meter) subscribe to the one bus: one device
ring, one upload and one captured graph a tick (runtime/bus.py).

Audio source, in order of preference:

* ``--ffmpeg PATH_OR_URL``: decode anything ffmpeg can read to 48 kHz
  stereo f32, streamed in real time (``-re``)
* ``--stdin``: raw interleaved float32 stereo 48 kHz on stdin, e.g.
  ``ffmpeg -i song.flac -f f32le -ac 2 -ar 48000 - | python
  torch_live_ingest.py --stdin``
* default: a built-in real-time synthesizer (gliding tone + noise), so
  the example runs with no media tooling at all

Usage:
    python examples/torch_live_ingest.py [--seconds 10] [--png-every 60]
        [--device cpu]
    python examples/torch_live_ingest.py --ffmpeg song.mp3
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import waveform_tpu_torch as wt  # noqa: E402
from waveform_tpu_torch.runtime.bus import OutputBus  # noqa: E402

SR = 48000
PACKET = 480            # 10 ms: the reference's typical audio-thread cadence
NS = 1_000_000_000


def synth_packets(stop: threading.Event):
    """Built-in real-time source: a gliding tone + noise."""
    rng = np.random.default_rng(0)
    phase = 0.0
    k = 0
    while not stop.is_set():
        f = 440.0 * 2.0 ** (2.0 * np.sin(2 * np.pi * k * PACKET / SR / 8.0))
        t = np.arange(PACKET) / SR
        tone = 0.4 * np.sin(2 * np.pi * f * t + phase)
        phase = (phase + 2 * np.pi * f * PACKET / SR) % (2 * np.pi)
        noise = 0.05 * rng.standard_normal(PACKET)
        left = (tone + noise).astype(np.float32)
        right = (0.7 * tone + noise).astype(np.float32)
        yield np.stack([left, right])
        k += 1
        # real-time pacing: the synth "arrives" like a capture callback
        time.sleep(PACKET / SR)


def pipe_packets(fh, stop: threading.Event):
    """Raw interleaved f32le stereo packets from a pipe/file object."""
    nbytes = PACKET * 2 * 4
    while not stop.is_set():
        buf = fh.read(nbytes)
        if not buf or len(buf) < nbytes:
            return
        x = np.frombuffer(buf, np.float32).reshape(PACKET, 2)
        yield np.ascontiguousarray(x.T)


def ffmpeg_packets(src: str, stop: threading.Event):
    """Spawn ffmpeg decoding ``src`` to realtime f32le stereo 48 kHz."""
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg not found on PATH; use --stdin or the "
                         "built-in synth instead")
    proc = subprocess.Popen(
        ["ffmpeg", "-re", "-i", src, "-f", "f32le", "-ac", "2",
         "-ar", str(SR), "-loglevel", "quiet", "-"],
        stdout=subprocess.PIPE)
    try:
        yield from pipe_packets(proc.stdout, stop)
    finally:
        proc.terminate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ffmpeg", metavar="SRC", default=None,
                    help="decode this file/URL with ffmpeg in real time")
    ap.add_argument("--stdin", action="store_true",
                    help="read raw f32le stereo 48 kHz from stdin")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--png-every", type=int, default=0,
                    help="write spectrum_NNNN.png every N video frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    audio = wt.AudioInfo(SR, 2)
    bus = OutputBus(audio, device=args.device)

    # three looks on one bus, the OBS scene analog (each OBS source would
    # be one subscription; the bus shares one ring and upload)
    curve = bus.subscribe(wt.resolve(wt.Settings(
        fft_size=4096, window=wt.FFTWindow.HANN,
        interp_mode=wt.InterpMode.LANCZOS), audio))
    bars = bus.subscribe(wt.resolve(wt.Settings(
        display_mode=wt.DisplayMode.BAR, bar_width=8, bar_gap=2,
        channel_mode=wt.ChannelMode.STEREO, fft_size=2048), audio))
    meter = bus.subscribe(wt.resolve(wt.Settings(
        display_mode=wt.DisplayMode.METER, meter_buf=100, rms_mode=True),
        audio))

    stop = threading.Event()
    if args.ffmpeg:
        packets = ffmpeg_packets(args.ffmpeg, stop)
    elif args.stdin:
        packets = pipe_packets(sys.stdin.buffer, stop)
    else:
        packets = synth_packets(stop)

    fed = [0]

    def feeder():
        """The audio thread: push packets with REAL arrival timestamps."""
        for pkt in packets:
            bus.feed(pkt, time.monotonic_ns())
            fed[0] += 1
            if stop.is_set():
                return
        stop.set()   # source drained: capture timeout decay takes over

    th = threading.Thread(target=feeder, daemon=True)
    th.start()

    # warm-up: the first tick builds the kernels and captures the bus's
    # graph; pay it before the real-time loop so frame pacing starts honest
    print("building and capturing the device tick...", flush=True)
    bus.tick(now_ns=time.monotonic_ns())

    frame_ns = NS // 60
    t_end = time.monotonic() + args.seconds
    frame = 0
    lat: list[float] = []
    try:
        while time.monotonic() < t_end:
            t0 = time.monotonic_ns()
            bus.tick(now_ns=t0)
            if args.png_every and frame % args.png_every == 0:
                from waveform_tpu_torch.render.image import write_png
                write_png(f"spectrum_{frame:04d}.png",
                          np.asarray(bus.render_frame(curve)))
            if frame % 60 == 0:
                db = bus.read_decibels(curve)
                lv = np.ravel(bus.read_decibels(meter))
                pk = int(np.argmax(db[0])) * SR / 4096
                print(f"t={frame / 60:5.1f}s packets={fed[0]:5d} "
                      f"peak={pk:7.1f} Hz {db[0].max():6.1f} dBFS "
                      f"meter L/R = {lv[0]:6.1f}/{lv[-1]:6.1f} dBFS",
                      flush=True)
            lat.append((time.monotonic_ns() - t0) / 1e6)
            frame += 1
            # sleep to the next 60 fps frame edge (real-time pacing)
            rest = (t0 + frame_ns - time.monotonic_ns()) / NS
            if rest > 0:
                time.sleep(rest)
    finally:
        stop.set()
        th.join(timeout=1.0)

    bars_px = bus.read_pixels(bars)
    print(f"done: {frame} frames, {fed[0]} packets ingested; "
          f"tick p50 {np.percentile(lat, 50):.1f} ms / "
          f"p99 {np.percentile(lat, 99):.1f} ms vs 16.7 ms budget; "
          f"bar frame shape {bars_px.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
