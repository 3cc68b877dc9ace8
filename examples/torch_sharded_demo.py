"""Multi-device serving demo on the PyTorch port.

Runs the mesh-sharded ShardedServingEngine (stream data-parallel x pixel
tensor-parallel) of ``waveform_tpu_torch`` over an 8-entry mesh:

    python examples/torch_sharded_demo.py [--device cuda|cpu]

With 8 CUDA devices each entry is a card; with fewer the first card
repeats 8 times (each entry still holds its own rows, ring, state and
captured tick); ``--device cpu`` runs the mesh as ``["cpu"] * 8`` on the
CPU.  100 streams of tones shard over 4 mesh rows (padded to 104) and
the rebin's pixels split 2 ways.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import waveform_tpu_torch as wt  # noqa: E402
from waveform_tpu_torch.dryrun import mesh_devices  # noqa: E402
from waveform_tpu_torch.parallel import (  # noqa: E402
    ShardedServingEngine,
    make_mesh,
)

SR, NS = 48000, 1_000_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device type of the mesh (default the card)")
    args = ap.parse_args(argv)

    devices = mesh_devices(8, args.device)
    print(f"devices: {len(devices)} x {devices[0]}")
    cfg = wt.resolve(wt.Settings(fft_size=1024, width=256),
                     wt.AudioInfo(SR, 2))
    eng = ShardedServingEngine(cfg, num_streams=100,
                               mesh=make_mesh(devices, pixel_parallel=2))

    now = NS
    phase = 0
    for _ in range(30):
        t = (np.arange(800) + phase) / SR
        for s in range(100):
            x = np.sin(2 * np.pi * (200.0 + 40.0 * s) * t,
                       dtype=np.float64).astype(np.float32)
            eng.feed(s, np.stack([x, x]), now, now_ns=now)
        phase += 800
        now += 800 * NS // SR
        tiles = eng.tick(now_ns=now)

    shape = eng.read_pixels().shape
    print(f"pixels {shape} in {len(tiles)} tiles on mesh "
          f"{eng.mesh.devices.shape[0]}x{eng.mesh.devices.shape[1]}")
    db = eng.read_decibels()
    for s in (0, 50, 99):
        pk = int(np.argmax(db[s, 0])) * SR / cfg.fft_size
        print(f"stream {s:3d}: peak {pk:7.1f} Hz "
              f"(fed {200.0 + 40.0 * s:7.1f} Hz)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
