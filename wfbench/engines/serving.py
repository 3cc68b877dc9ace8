"""The adapter of ``waveform_tpu_torch.runtime.serving.ServingEngine``:
spectrum looks served to many streams, one packed upload and one
captured graph a tick.

An engine adapter is found by a configuration's ``engine`` key.  It
builds the engine from the configuration's settings, feeds it one tick's
packets, ticks it, and works out from the reference what the ticks it
returned should hold.  It touches only the program's public surface.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from wfbench.reference import spectrum as reference


class Adapter:
    def __init__(self, deployment: dict, device: torch.device):
        import waveform_tpu_torch as wt
        from waveform_tpu_torch.core.settings_io import settings_from_obs
        from waveform_tpu_torch.runtime.serving import ServingEngine

        settings = deployment["settings"]
        unknown = set(settings) - {f.name for f in fields(wt.Settings)}
        if unknown:
            raise ValueError(f"unknown settings {sorted(unknown)}")
        audio = deployment["audio"]
        self.cfg = wt.resolve(
            settings_from_obs(settings),
            wt.AudioInfo(audio["samples_per_sec"], audio["channels"]),
            wt.VideoInfo(deployment["fps"]))
        self.look = reference.look_from_settings(settings, audio,
                                                 deployment["fps"])
        if self.cfg.fft_size != self.look.fft_size:
            raise ValueError(f"fft_size resolves to {self.cfg.fft_size}")
        self.S = deployment["streams"]
        self.C = max(self.cfg.capture_channels, 1)
        self.N = self.cfg.fft_size
        self.device = device
        self.engine = ServingEngine(self.cfg, self.S,
                                    hop_budget=deployment["hop_budget"],
                                    device=device)

    def feed(self, packets: list, now_ns: int) -> None:
        """Hand one tick's packets to the engine, oldest first."""
        eng = self.engine
        for s, data, ts in packets:
            if s is None:
                eng.feed_batch(data, ts, now_ns=now_ns)
            else:
                eng.feed(s, data, ts, now_ns=now_ns)

    def tick(self, now_ns: int) -> torch.Tensor:
        """One video frame; returns the pixels [S, D, width] (dBFS) as the
        engine hands them out, before the device has finished them."""
        return self.engine.tick(now_ns=now_ns)

    def close(self) -> None:
        """Free the engine: its rings, state and captured graphs."""
        self.engine = None

    def expected(self, traffic, ticks: list[int], history: int) -> np.ndarray:
        """What ticks ``ticks`` should have returned: [len(ticks), S, D,
        width] float64 from the reference."""
        return reference.expected_pixels(
            self.look, traffic.ends, traffic.frames, traffic.first_tick,
            ticks, history)
