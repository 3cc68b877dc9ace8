"""Serving engine: device-resident windows, one packed upload per tick.

The PyTorch counterpart of the single-tick path of
``waveform_tpu/runtime/serving.py``.  Audio packets queue on the host (the
C++ assembler in ``native/``, or the pure-Python assembly when no compiler is
available); each tick assembles ONE packed row per stream — the newly
synced samples, the raw RMS squares under volume normalization, then
(count, active, rms) — uploads it, and runs ring push -> exact |rFFT| ->
spectrum step -> rebin on the engine's device.  Pixels stay on the device;
callers read them back on their own cadence.

Host-side A/V sync follows the reference exactly: the window ends
``dtsamples`` behind the freshest audio when timestamps run ahead of the
clock (src/source.hpp:279-285), mute zero-fills (src/source.cpp:1878-1879),
bogus timestamps clamp to the wall clock at 16 s (src/source.cpp:1833-1837).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..core.config import (
    CAPTURE_TIMEOUT_NS,
    MAX_TS_DELTA_NS,
    ResolvedConfig,
    check_config,
)
from ..core.device import checked_device
from ..core.ring import audio_frames_to_ns, ns_to_audio_frames
from ..dsp.devring import init_ring, push
from ..dsp.spectrum import display_decibels, init_state, make_spectrum_step
from ..rebin.apply import make_rebin_fn


class _PendingStream:
    """Host bookkeeping for one stream: queued packets + sync timestamps."""

    __slots__ = ("chunks", "rms_chunks", "queued", "capture_ts",
                 "audio_ts", "show")

    def __init__(self):
        self.chunks: deque[np.ndarray] = deque()      # [C, n] arrays
        self.rms_chunks: deque[np.ndarray] = deque()  # [n] raw squares
        self.queued = 0
        self.capture_ts = 0
        self.audio_ts = 0
        self.show = True


class ServingEngine:
    """Batched spectrum serving for S streams on one device."""

    def __init__(self, cfg: ResolvedConfig, num_streams: int,
                 hop_budget: int | None = None,
                 use_native: bool | None = None,
                 device: torch.device | str = "cuda"):
        check_config(cfg)
        if not cfg.spectrum_mode:
            raise ValueError("ServingEngine handles spectrum mode only")
        self.device = checked_device(device, "ServingEngine")
        self.cfg = cfg
        self.S = num_streams
        self.C = max(cfg.capture_channels, 1)
        # hop budget: max new samples consumed per stream per tick; default
        # 2 video frames of audio so jitter doesn't stall the window
        self.H = hop_budget or (2 * int(cfg.audio.samples_per_sec / cfg.fps)
                                + 16)
        self._pending = [_PendingStream() for _ in range(num_streams)]
        self._normalize = cfg.normalize_volume
        self._batch_chunks: deque[np.ndarray] = deque()
        self._batch_queued = 0
        self._batch_mode = False

        # native C++ assembler: per-stream rings + sync + batched hop
        # assembly; the pure-Python assembly below serves without g++
        self._native = None
        if use_native or use_native is None:
            try:
                from ..native import NativeAssembler
                self._native = NativeAssembler(
                    num_streams, self.C, cfg.fft_size,
                    cfg.audio.samples_per_sec, cfg.ts_offset_ns,
                    prefill=False, rms=self._normalize)
            except (RuntimeError, OSError):
                if use_native:
                    raise
                self._native = None

        dev = self.device
        self.ring = init_ring(num_streams, self.C, cfg.fft_size, dev)
        self.rms_ring = (init_ring(num_streams, 1, cfg.input_rms_size, dev)
                         if self._normalize else None)
        self.state = init_state(cfg, num_streams, dev)
        self._step = make_spectrum_step(cfg, dev)
        self._rebin = make_rebin_fn(cfg, apply_pixel_map=False, device=dev)

        # One packed row per stream, double-buffered in (pinned, on CUDA)
        # host memory: the upload is asynchronous, so it reads the host
        # buffer after tick() returns; a tick rewrites a buffer only after
        # the event recorded behind its last upload has completed.
        pin = dev.type == "cuda"
        self._host = [torch.zeros((num_streams, self.packed_width),
                                  dtype=torch.float32, pin_memory=pin)
                      for _ in range(2)]
        self._events: list = [None, None]
        self._flip = 0
        self._dev_in = torch.empty((num_streams, self.packed_width),
                                   dtype=torch.float32, device=dev)
        self._bind_buf(0)
        self._last_pixels = None

    @property
    def packed_width(self) -> int:
        """Row width of the packed per-tick upload: C*H samples, the H
        RMS squares only under volume normalization, 3 meta columns."""
        return self.C * self.H + (self.H if self._normalize else 0) + 3

    def _bind_buf(self, i: int) -> None:
        """Point the assembly views at host buffer ``i``, first waiting for
        the upload that last read it."""
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
            self._events[i] = None
        view = self._host[i].numpy()
        CH, H = self.C * self.H, self.H
        R = H if self._normalize else 0
        self._in_buf = view
        self._push_buf = view[:, :CH].reshape(-1, self.C, H)
        self._rms_buf = view[:, CH:CH + R]
        self._meta_buf = view[:, CH + R:]

    # ------------------------------------------------------------------

    def feed(self, stream: int, data: np.ndarray | None, timestamp_ns: int,
             now_ns: int | None = None, muted: bool = False) -> None:
        """Queue one packet ([channels, frames] float32 planar)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        cfg = self.cfg
        frames = 0 if data is None else data.shape[-1]
        if frames == 0 or cfg.capture_channels == 0:
            return  # dead source (reference capture_audio early-returns)
        if self._native is not None:
            data = np.asarray(
                data[cfg.channel_base:cfg.channel_base + self.C], np.float32)
            self._native.feed(stream, data, timestamp_ns, now_ns,
                              muted and not cfg.settings.ignore_mute)
            return
        p = self._pending[stream]
        p.capture_ts = now_ns
        audio_len = audio_frames_to_ns(cfg.audio.samples_per_sec, frames)
        if abs(timestamp_ns - now_ns) > MAX_TS_DELTA_NS:
            p.audio_ts = now_ns
        else:
            p.audio_ts = timestamp_ns + audio_len

        raw = np.asarray(data[cfg.channel_base:cfg.channel_base + self.C],
                         np.float32)
        if raw.shape[0] < self.C:  # zero-fill missing channels
            raw = np.vstack([raw, np.zeros(
                (self.C - raw.shape[0], frames), np.float32)])
        if self._normalize:
            # raw (pre-mute) per-timepoint max-channel squares
            p.rms_chunks.append(
                np.max(np.abs(raw), axis=0).astype(np.float32) ** 2)
        if muted and not cfg.settings.ignore_mute:
            chunk = np.zeros((self.C, frames), np.float32)
        else:
            chunk = raw
        p.chunks.append(chunk)
        p.queued += frames
        # bound the queue: never hold more than sync reserve + one window +
        # one hop (the analog of the capture-side trim, src/source.cpp:1883-86)
        dtaudio = self._audio_sync(p, now_ns)
        dtsamples = (ns_to_audio_frames(cfg.audio.samples_per_sec, dtaudio)
                     if dtaudio > 0 else 0)
        max_q = dtsamples + cfg.fft_size + self.H
        while p.queued > max_q and p.chunks:
            drop = p.queued - max_q
            head = p.chunks[0]
            if head.shape[-1] <= drop:
                p.queued -= head.shape[-1]
                p.chunks.popleft()
                if p.rms_chunks:
                    p.rms_chunks.popleft()
            else:
                p.chunks[0] = head[:, drop:]
                if p.rms_chunks:
                    p.rms_chunks[0] = p.rms_chunks[0][drop:]
                p.queued -= drop
                break

    def _audio_sync(self, p: _PendingStream, ts: int) -> int:
        audio_ts = p.audio_ts + self.cfg.ts_offset_ns
        delta = min(abs(audio_ts - ts), MAX_TS_DELTA_NS)
        return -delta if audio_ts < ts else delta

    def feed_batch(self, data: np.ndarray, timestamp_ns: int,
                   now_ns: int | None = None) -> None:
        """Synchronized ingestion for all S streams at once.

        ``data`` is [S, channels, frames] float32 planar with one shared
        timestamp.  Streams fed this way share sync state; don't mix with
        per-stream ``feed`` on the same engine.
        """
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        cfg = self.cfg
        frames = data.shape[-1]
        if frames == 0 or cfg.capture_channels == 0:
            return
        batch = np.asarray(data[:, cfg.channel_base:cfg.channel_base + self.C],
                           np.float32)
        if self._native is not None:
            self._native.feed_batch(batch, timestamp_ns, now_ns)
            return
        p = self._pending[0]  # shared sync bookkeeping
        p.capture_ts = now_ns
        audio_len = audio_frames_to_ns(cfg.audio.samples_per_sec, frames)
        p.audio_ts = (now_ns if abs(timestamp_ns - now_ns) > MAX_TS_DELTA_NS
                      else timestamp_ns + audio_len)
        self._batch_mode = True
        self._batch_chunks.append(batch)
        self._batch_queued += frames
        dtaudio = self._audio_sync(p, now_ns)
        dtsamples = (ns_to_audio_frames(cfg.audio.samples_per_sec, dtaudio)
                     if dtaudio > 0 else 0)
        max_q = dtsamples + cfg.fft_size + self.H
        while self._batch_queued > max_q and self._batch_chunks:
            drop = self._batch_queued - max_q
            head = self._batch_chunks[0]
            if head.shape[-1] <= drop:
                self._batch_queued -= head.shape[-1]
                self._batch_chunks.popleft()
            else:
                self._batch_chunks[0] = head[..., drop:]
                self._batch_queued -= drop
                break

    def _assemble_batch(self, now_ns: int):
        """Vectorized push-buffer assembly for the feed_batch path."""
        p = self._pending[0]
        sr = self.cfg.audio.samples_per_sec
        dtaudio = self._audio_sync(p, now_ns)
        reserve = ns_to_audio_frames(sr, dtaudio) if dtaudio > 0 else 0
        take = min(max(self._batch_queued - reserve, 0), self.H)
        got = 0
        self._push_buf[:] = 0.0
        while got < take and self._batch_chunks:
            head = self._batch_chunks[0]
            n = head.shape[-1]
            use = min(n, take - got)
            self._push_buf[:, :, got:got + use] = head[..., :use]
            if use == n:
                self._batch_chunks.popleft()
            else:
                self._batch_chunks[0] = head[..., use:]
            self._batch_queued -= use
            got += use
        active = p.show and (now_ns - p.capture_ts) <= CAPTURE_TIMEOUT_NS
        return take, active

    def _assemble(self, now_ns: int) -> None:
        """Fill the bound packed buffer: samples, RMS squares, counts,
        active flags (the host half of the tick)."""
        sr = self.cfg.audio.samples_per_sec
        if self._native is not None:
            # C++ writes samples, RMS squares, counts and active directly
            # into the packed rows
            self._native.assemble_hop_packed(now_ns, self.H, self._in_buf,
                                             self._normalize)
        elif self._batch_mode:
            take, active = self._assemble_batch(now_ns)
            if self._normalize:
                np.square(np.max(np.abs(self._push_buf), axis=1),
                          out=self._rms_buf)
            self._meta_buf[:, 0] = take
            self._meta_buf[:, 1] = active
        else:
            self._push_buf[:] = 0.0
            self._rms_buf[:] = 0.0
            for i, p in enumerate(self._pending):
                fresh = (now_ns - p.capture_ts) <= CAPTURE_TIMEOUT_NS
                self._meta_buf[i, 1] = p.show and fresh
                # consume everything except the sync reserve, capped at the
                # hop budget (excess stays queued)
                dtaudio = self._audio_sync(p, now_ns)
                reserve = (ns_to_audio_frames(sr, dtaudio)
                           if dtaudio > 0 else 0)
                take = min(max(p.queued - reserve, 0), self.H)
                self._meta_buf[i, 0] = take
                got = 0
                while got < take and p.chunks:
                    head = p.chunks[0]
                    n = head.shape[-1]
                    use = min(n, take - got)
                    self._push_buf[i, :, got:got + use] = head[:, :use]
                    if self._normalize and p.rms_chunks:
                        self._rms_buf[i, got:got + use] = p.rms_chunks[0][:use]
                        if use == p.rms_chunks[0].shape[-1]:
                            p.rms_chunks.popleft()
                        else:
                            p.rms_chunks[0] = p.rms_chunks[0][use:]
                    if use == n:
                        p.chunks.popleft()
                    else:
                        p.chunks[0] = head[:, use:]
                    p.queued -= use
                    got += use

    def _uniform_count(self) -> tuple[bool, int]:
        """True when every stream advances by the same count this tick:
        the ring then shifts the whole batch by one host scalar."""
        counts_col = self._meta_buf[:, 0]
        c0 = counts_col[0]
        return bool((counts_col == c0).all()), int(c0)

    # ------------------------------------------------------------------

    def tick(self, now_ns: int | None = None, dt: float | None = None):
        """One batched frame.  Returns the device pixels [S, D, P] (dBFS
        on the log-frequency axis)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        dt_f = (1.0 / self.cfg.fps) if dt is None else float(dt)
        self._flip ^= 1
        self._bind_buf(self._flip)
        self._assemble(now_ns)
        uniform, c0 = self._uniform_count()

        flat = self._dev_in
        flat.copy_(self._host[self._flip], non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._events[self._flip] = ev

        C, H, S = self.C, self.H, self.S
        new = flat[:, :C * H].view(S, C, H)
        counts = c0 if uniform else flat[:, -3].to(torch.int64)
        active = flat[:, -2] > 0.5
        rms = flat[:, -1]
        push(self.ring, new, counts)
        if self.rms_ring is not None:
            # raw (pre-mute) per-timepoint max-channel squares: the
            # reference computes the normalization RMS before the mute
            # zero-fill (src/source.cpp:1843-1871)
            push(self.rms_ring, flat[:, C * H:C * H + H].view(S, 1, H), counts)
            rms = torch.sqrt(self.rms_ring.buf.sum(-1)[:, 0]
                             / self.cfg.input_rms_size)
        self.state = self._step(self.ring.buf, self.state, dt_f, active, rms)
        pixels = self._rebin(display_decibels(self.cfg, self.state))
        self._last_pixels = pixels
        return pixels

    def read_pixels(self) -> np.ndarray:
        """Host readback of the latest rebinned frame (synchronizes)."""
        return self._last_pixels.cpu().numpy()

    def read_decibels(self) -> np.ndarray:
        """Host readback of the display dB buffer, natural bin order."""
        return display_decibels(self.cfg, self.state).cpu().numpy()

    @property
    def last_silent(self) -> np.ndarray:
        """Per-stream silence latch."""
        return self.state.last_silent.cpu().numpy()

    def set_show(self, stream: int, show: bool) -> None:
        """The reference's show()/hide() callbacks (source.hpp:314-346): a
        hidden source decays exactly like a capture timeout."""
        self._pending[stream].show = bool(show)
        if self._native is not None:
            self._native.set_show(stream, bool(show))
