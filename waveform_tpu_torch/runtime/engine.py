"""Batched multi-stream engine: S host stream-sources feeding one device step.

The PyTorch counterpart of ``waveform_tpu/runtime/engine.py``.  Where the
reference runs one ``WAVSource::tick`` per OBS source per video frame
(reference src/source.cpp:1324-1344), this engine assembles all streams'
frames on the host (``runtime/source.StreamSource``, one per stream) and
runs one device step over the ``[S, C, N]`` batch: the spectrum step
(exact |rFFT|, EMA, gating, dBFS) or the meter reduction.  Waveform mode
runs the host scrollers (``runtime/waveform_host.WaveformScroller``) as
the JAX engine does; ``runtime/waveform_device.DeviceWaveformEngine`` is
the device-resident waveform engine.

Each tick copies the host-assembled inputs into fixed device tensors (one
flat block: frames or meter windows, the (g, 1 − g) pair of ``dt``, the
per-stream flags) and runs the step on them.  With ``jit=True`` on a CUDA
device the step is a captured graph (``runtime/graphs.GraphTick``), the
counterpart of the JAX engine's ``jax.jit``; ``jit=False`` launches its
ops eagerly.  The state updates in place.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..core.config import ResolvedConfig, check_config
from ..core.device import checked_device
from ..core.enums import DisplayMode
from ..dsp.meter import MeterState, init_meter_state, make_meter_step
from ..dsp.spectrum import (
    SpectrumState,
    display_decibels,
    gravity_pair,
    init_state,
    make_spectrum_step,
)
from ..rebin.apply import make_rebin_fn
from .graphs import GraphTick
from .serving import assign
from .source import StreamSource
from .waveform_host import WaveformScroller


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, its own memory on any device (the step
    updates the state tensors in place)."""
    return t.to("cpu", copy=True).numpy()


class WaveformEngine:
    """S concurrent streams under one resolved config."""

    def __init__(self, cfg: ResolvedConfig, num_streams: int,
                 rfft_fn=None, jit: bool = True,
                 device: torch.device | str = "cuda"):
        check_config(cfg)
        if rfft_fn is not None:
            raise NotImplementedError(
                "WaveformEngine(rfft_fn=...): the rfft_fn override is not "
                "ported yet (ROADMAP A14)")
        self.device = checked_device(device, type(self).__name__)
        self.cfg = cfg
        self.S = num_streams
        self._jit = jit   # kept for resized()
        C = max(cfg.capture_channels, 1)
        self.C = C
        self.sources = [StreamSource(cfg) for _ in range(num_streams)]
        S, N, dev = num_streams, cfg.fft_size, self.device

        run = None
        if cfg.meter_mode:
            self.meter_state: MeterState = init_meter_state(cfg, S, dev)
            self._was_fresh = np.zeros(S, bool)
            step = make_meter_step(cfg)
            host, d = self._inputs(dict(window=(S, C, N), dt=(2,),
                                        fresh=(S,), show=(S,), run=(S,)))
            # the meter rings persist on the host between ticks
            self._meter_windows = host["window"]

            def run():
                assign(self.meter_state, step(
                    d["window"], self.meter_state, d["dt"], d["fresh"] > 0.5,
                    d["show"] > 0.5, d["run"] > 0.5))
                return self.meter_state.meter_val[:, None, :]
        elif cfg.display_mode == DisplayMode.WAVEFORM:
            self._scrollers = [WaveformScroller(cfg) for _ in range(S)]
        else:
            self.state: SpectrumState = init_state(cfg, S, dev)
            step = make_spectrum_step(cfg, dev)
            self._rebin = make_rebin_fn(cfg, apply_pixel_map=False,
                                        device=dev)
            host, d = self._inputs(dict(batch=(S, C, N), dt=(2,),
                                        active=(S,), rms=(S,), valid=(S, C),
                                        run=(S,)))

            def run():
                assign(self.state, step(
                    d["batch"], self.state, d["dt"], d["active"] > 0.5,
                    d["rms"], d["valid"] > 0.5, d["run"] > 0.5))
                return display_decibels(cfg, self.state)

        if run is not None:
            self._in = host
            self._device_tick = GraphTick(run, dev) if jit else run
        self._last_tick_ns: int | None = None

    def _inputs(self, shapes: dict):
        """One flat f32 input block, on the host and on the device, and
        ({name: host view}, {name: device view}) of the ``shapes`` in it
        (flags ride as 0.0 / 1.0)."""
        sizes = {k: math.prod(v) for k, v in shapes.items()}
        self._host_in = np.zeros(sum(sizes.values()), np.float32)
        self._dev_in = torch.zeros(self._host_in.size, dtype=torch.float32,
                                   device=self.device)
        host, dev, off = {}, {}, 0
        for k, shape in shapes.items():
            host[k] = self._host_in[off:off + sizes[k]].reshape(shape)
            dev[k] = self._dev_in[off:off + sizes[k]].view(shape)
            off += sizes[k]
        return host, dev

    def _run_device(self, dt: float) -> torch.Tensor:
        """Copy the assembled inputs (and the gravity pair of ``dt``) into
        the device block, run the step; returns its output as a tensor of
        its own."""
        self._in["dt"][:] = gravity_pair(self.cfg, dt)
        self._dev_in.copy_(torch.from_numpy(self._host_in))
        return self._device_tick().clone()

    # ------------------------------------------------------------------

    def feed(self, stream: int, data: np.ndarray | None, timestamp_ns: int,
             now_ns: int | None = None, muted: bool = False) -> bool:
        """Audio-callback entry for one stream ([channels, frames] planar)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        return self.sources[stream].capture_audio(data, timestamp_ns, now_ns,
                                                  muted)

    def set_show(self, stream: int, show: bool) -> None:
        """The reference's show()/hide() callbacks (source.hpp:314-346):
        a hidden source's graph decays like a capture timeout."""
        self.sources[stream].show = bool(show)

    # ------------------------------------------------------------------

    def tick(self, now_ns: int | None = None):
        """One video frame for all streams.

        Returns the display values: dBFS ``[S, D, nbins]`` on the device
        for spectrum mode before rebin (use :meth:`render_values` for the
        rebinned axis), the meter levels ``[S, 1, C]`` on the device, or
        the host waveform displays ``[S, D, W]``.
        """
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        if self._last_tick_ns is None:
            dt = 1.0 / self.cfg.fps
        else:
            dt = max((now_ns - self._last_tick_ns) / 1e9, 1e-9)
        self._last_tick_ns = now_ns

        if self.cfg.meter_mode:
            return self._tick_meter(now_ns, dt)
        if self.cfg.display_mode == DisplayMode.WAVEFORM:
            return self._tick_waveform(now_ns, dt)
        return self._tick_spectrum(now_ns, dt)

    def _tick_spectrum(self, now_ns: int, dt: float) -> torch.Tensor:
        h = self._in
        for i, src in enumerate(self.sources):
            t = src.prepare_spectrum_tick(now_ns, dt)
            h["batch"][i] = t.frame
            h["valid"][i] = t.valid
            h["active"][i] = t.active
            h["run"][i] = t.run
            h["rms"][i] = t.input_rms
        return self._run_device(dt)

    def _tick_meter(self, now_ns: int, dt: float) -> torch.Tensor:
        h = self._in
        for i, src in enumerate(self.sources):
            r, f = src.drain_meter_samples(now_ns, dt, self._meter_windows[i])
            h["run"][i], h["fresh"][i], h["show"][i] = r, f, src.show
            # timeout memset (src/source_generic.cpp:184-199): the host
            # zeroes the ring on the fresh→timeout edge.  The reference
            # keys the skip on the silence LATCH, not the edge; the two
            # differ only for a latched stream whose window still held
            # sub-floor NONZERO samples — there the reference preserves
            # those samples and this zeroes them (the JAX engine's
            # accepted divergence: tracking the edge on the host removes
            # a per-tick device latch readback).
            if r and not f and self._was_fresh[i]:
                self._meter_windows[i] = 0.0
            if r:
                self._was_fresh[i] = f
        return self._run_device(dt)

    def _tick_waveform(self, now_ns: int, dt: float) -> np.ndarray:
        outs = []
        for i, src in enumerate(self.sources):
            outs.append(self._scrollers[i].tick(src, now_ns, dt))
        return np.stack(outs)

    # ------------------------------------------------------------------

    def render_values(self) -> np.ndarray:
        """Rebinned dBFS on the output axis: [S, D, width|num_bars]."""
        if self.cfg.meter_mode:
            return _host(self.meter_state.meter_val)[:, None, :]
        if self.cfg.display_mode == DisplayMode.WAVEFORM:
            return np.stack([s.display for s in self._scrollers])
        db = display_decibels(self.cfg, self.state)
        return _host(self._rebin(db))

    @property
    def last_silent(self) -> np.ndarray:
        if self.cfg.meter_mode:
            return _host(self.meter_state.last_silent)
        if self.cfg.display_mode == DisplayMode.WAVEFORM:
            return np.array([s.last_silent for s in self._scrollers])
        return _host(self.state.last_silent)

    def resized(self, num_streams: int,
                keep: list[int] | None = None) -> "WaveformEngine":
        """A new engine with ``num_streams`` rows; row ``i`` adopts old row
        ``keep[i]``'s host source (its ring, sync and retry state move as
        objects — capture continues uninterrupted) plus its analysis state
        (EMA/meter/scroll buffers); extra rows start fresh.  The live-scene
        resize (the reference rebuilds everything in update(),
        src/source.cpp:1077-1322).
        """
        if keep is None:
            keep = list(range(min(self.S, num_streams)))
        if len(keep) > num_streams:
            raise ValueError(f"keep ({len(keep)} rows) exceeds "
                             f"num_streams={num_streams}")
        if any(not 0 <= j < self.S for j in keep):
            raise ValueError(f"keep indices out of range for S={self.S}: "
                             f"{keep}")
        eng = WaveformEngine(self.cfg, num_streams, jit=self._jit,
                             device=self.device)
        eng._last_tick_ns = self._last_tick_ns
        k = len(keep)
        if not k:
            return eng
        for i, j in enumerate(keep):
            eng.sources[i] = self.sources[j]
        nk = np.asarray(keep, np.int64)
        idx = torch.from_numpy(nk).to(self.device)

        def mig(new, old):
            # field by field, in place: a captured step reads these tensors
            for f in dataclasses.fields(new):
                getattr(new, f.name)[:k] = getattr(old, f.name)[idx]

        if self.cfg.meter_mode:
            mig(eng.meter_state, self.meter_state)
            eng._was_fresh[:k] = self._was_fresh[nk]
            eng._meter_windows[:k] = self._meter_windows[nk]
        elif self.cfg.display_mode == DisplayMode.WAVEFORM:
            for i, j in enumerate(keep):
                eng._scrollers[i] = self._scrollers[j]
        else:
            mig(eng.state, self.state)
        return eng
