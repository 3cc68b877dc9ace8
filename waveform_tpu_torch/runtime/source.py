"""Per-stream host state machine: capture, A/V sync, retry, frame assembly.

The port's own copy of ``waveform_tpu/runtime/source.py`` (numpy and
``threading`` only), over the port's ``core/`` copies.

This is the host half of the reference's ``WAVSource`` — everything that
lives outside the DSP math: the audio-callback ring feeding
(reference src/source.cpp:1817-1888), timestamp bookkeeping with the
16 s bogus-timestamp clamp, the pop-to-sync-point + peek frame assembly
(src/source_generic.cpp:50-61), the 2 s capture-retry loop
(src/source.cpp:751-780), the volume-normalization RMS window
(src/source.cpp:810-835, 1843-1871), and the meter/waveform sample rings.

One :class:`StreamSource` = one audio stream.  The batched engine
(runtime/engine.py) owns S of these and assembles their frames into the
``[S, C, N]`` device batch each tick.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..core.config import (
    CAPTURE_TIMEOUT_NS,
    MAX_TS_DELTA_NS,
    RETRY_DELAY_S,
    ResolvedConfig,
)
from ..core.enums import DisplayMode
from ..core.ring import SampleRing, audio_frames_to_ns, ns_to_audio_frames


@dataclass
class SpectrumTickInput:
    """Host-assembled inputs for one stream's device step."""

    frame: np.ndarray          # [C, N] f32 (garbage where ~valid)
    valid: np.ndarray          # [C] bool — ring had enough data
    active: bool               # show && capture fresh (timeout gate)
    run: bool                  # tick should execute at all (capture attached)
    input_rms: float = 0.0


class StreamSource:
    """Host state for one audio stream."""

    def __init__(self, cfg: ResolvedConfig, capture_attached: bool = True):
        self.cfg = cfg
        C = max(cfg.capture_channels, 1)
        self.C = C
        self.rings = [SampleRing() for _ in range(C)]
        self.show = True
        self.muted = False
        # timestamps (ns)
        # capture_ts stays 0 until the first packet: a brand-new source
        # that is ticked before any audio reads as timed-out, where the
        # reference stamps m_capture_ts at update() and reads as
        # active-silent for its first 500 ms (source.cpp:1241-1248).
        # Both display the floor; the divergence is only the first ticks'
        # latch/freeze flavor, and keeping the stamp OUT preserves
        # host/device engine equivalence (every engine shares this rule).
        self.capture_ts = 0
        self.audio_ts = 0
        self.tick_ts = 0
        # capture attachment / retry (src/source.cpp:751-780)
        self.capture_attached = capture_attached
        self.next_retry = 0.0
        self.retries = 0
        self.on_retry = None  # callable -> bool: attempt re-attach
        # volume normalization (src/source.cpp:1145-1153)
        self.input_rms = 0.0
        self._rms_window = np.zeros(max(cfg.input_rms_size, 1), np.float32)
        self._rms_pos = 0
        self._rms_sync = SampleRing()
        # waveform mode scroll state (src/source.hpp:134-135)
        self.waveform_ts = 0
        # meter-mode ring write positions (src/source.hpp:126)
        self.meter_pos = np.zeros(C, np.int64)
        # audio-callback contention guard (the reference drops the packet if
        # the 10 ms try_lock fails, src/source.cpp:1822-1823)
        self._lock = threading.Lock()

        if not cfg.meter_mode:
            # prefill rings with silence to avoid startup lag
            # (src/source.cpp:1243-1248)
            for r in self.rings:
                r.push_back_zero(cfg.fft_size)

    # ------------------------------------------------------------------
    # audio thread side
    # ------------------------------------------------------------------

    def get_audio_sync(self, ts: int) -> int:
        """Signed ns between end of buffered audio (+user offset) and ts,
        clamped to ±16 s (src/source.hpp:279-285)."""
        audio_ts = self.audio_ts + self.cfg.ts_offset_ns
        delta = min(abs(audio_ts - ts), MAX_TS_DELTA_NS)
        return -delta if audio_ts < ts else delta

    def capture_audio(self, data: np.ndarray | None, timestamp_ns: int,
                      now_ns: int, muted: bool = False,
                      blocking: bool = True) -> bool:
        """Feed one audio packet; ``data`` is [channels, frames] float32
        planar.  ``data=None`` is a keep-alive: it stamps the capture
        timestamp (the source still exists) without pushing samples.
        Returns False if dropped on contention."""
        acquired = self._lock.acquire(blocking=blocking,
                                      timeout=0.010 if blocking else -1)
        if not acquired:
            return False  # drop the packet, as the audio callback does
        try:
            self._capture_locked(data, timestamp_ns, now_ns, muted)
            return True
        finally:
            self._lock.release()

    def _capture_locked(self, data, timestamp_ns, now_ns, muted):
        cfg = self.cfg
        if not self.capture_attached or cfg.capture_channels == 0:
            return
        frames = 0 if data is None else data.shape[-1]
        if frames == 0:
            if data is None:
                self.capture_ts = now_ns   # keep-alive heartbeat
            return

        # timestamp bookkeeping (src/source.cpp:1830-1837)
        self.capture_ts = now_ns
        audio_len = audio_frames_to_ns(cfg.audio.samples_per_sec, frames)
        if abs(timestamp_ns - self.capture_ts) > MAX_TS_DELTA_NS:
            self.audio_ts = self.capture_ts  # bogus timestamp (e.g. VLC)
        else:
            self.audio_ts = timestamp_ns + audio_len

        bufsz = (cfg.waveform_samples
                 if cfg.display_mode == DisplayMode.WAVEFORM else cfg.fft_size)
        dtaudio = self.get_audio_sync(self.capture_ts)
        dtsamples = (ns_to_audio_frames(cfg.audio.samples_per_sec, dtaudio)
                     if dtaudio > 0 else 0)

        # volume-normalization RMS feed (src/source.cpp:1843-1871):
        # per time point, square of the loudest channel's sample
        if cfg.normalize_volume:
            chans = data[cfg.channel_base:cfg.channel_base
                         + cfg.capture_channels]
            peak = (np.max(np.abs(chans), axis=0).astype(np.float32)
                    if chans.shape[0] else np.zeros(frames, np.float32))
            self._rms_sync.push_back(peak * peak)
            max_rms = dtsamples + cfg.input_rms_size
            excess = self._rms_sync.size - max_rms
            if excess > 0:
                self._rms_sync.pop_front(excess)

        silence = muted and not cfg.settings.ignore_mute
        for j in range(cfg.capture_channels):
            ch = cfg.channel_base + j
            if silence or ch >= data.shape[0]:
                self.rings[j].push_back_zero(frames)
            else:
                self.rings[j].push_back(data[ch])
            max_size = dtsamples + bufsz
            excess = self.rings[j].size - max_size
            if excess > 0:
                self.rings[j].pop_front(excess)

    # ------------------------------------------------------------------
    # tick side
    # ------------------------------------------------------------------

    def detach(self) -> None:
        """Audio source lost: release capture (src/source.cpp:722-749)."""
        self.capture_attached = False
        for r in self.rings:
            r.reset()
        self._rms_sync.reset()
        self.capture_ts = 0
        self.audio_ts = 0

    def check_audio_capture(self, seconds: float) -> bool:
        """2 s retry loop (src/source.cpp:751-780)."""
        if self.capture_attached:
            return True
        self.next_retry -= seconds
        if self.next_retry <= 0.0:
            self.next_retry = RETRY_DELAY_S
            self.retries += 1
            if self.on_retry is not None and self.on_retry():
                self.capture_attached = True
                return True
        return False

    def update_input_rms(self) -> None:
        """Drain the A/V-synced squared-peak ring into the 1 s window and
        recompute the RMS (src/source.cpp:810-835; source_generic.cpp:392-403)."""
        cfg = self.cfg
        if not cfg.normalize_volume:
            return
        # under the capture lock: the audio thread's push_back may
        # reallocate the ring mid-pop otherwise (the reference holds
        # m_mtx for the whole tick, source.cpp:1326-1331)
        with self._lock:
            dtaudio = self.get_audio_sync(self.tick_ts)
            dtsize = (ns_to_audio_frames(cfg.audio.samples_per_sec, dtaudio)
                      if dtaudio > 0 else 0)
            if self._rms_sync.size <= dtsize:
                return
            n = cfg.input_rms_size
            while self._rms_sync.size > dtsize:
                consume = self._rms_sync.size - dtsize
                room = n - self._rms_pos
                take = min(consume, room)
                self._rms_sync.pop_front(
                    take,
                    out=self._rms_window[self._rms_pos:self._rms_pos + take])
                self._rms_pos = (self._rms_pos + take) % n
            self.input_rms = float(np.sqrt(self._rms_window.sum() / n))

    def prepare_spectrum_tick(self, now_ns: int, dt: float) -> SpectrumTickInput:
        """Pop-to-sync-point and peek one FFT frame per channel
        (src/source_generic.cpp:50-61)."""
        cfg = self.cfg
        self.tick_ts = now_ns
        self.update_input_rms()

        run = self.check_audio_capture(dt) and cfg.capture_channels > 0
        C, N = self.C, cfg.fft_size
        frame = np.zeros((C, N), np.float32)
        valid = np.zeros(C, bool)
        active = self.show and (now_ns - self.capture_ts) <= CAPTURE_TIMEOUT_NS
        if not run:
            return SpectrumTickInput(frame, valid, active, False, self.input_rms)

        with self._lock:
            # sync point and trim must see the same audio_ts/ring state
            # (the reference computes dtsize under m_mtx,
            # source_generic.cpp:50-52)
            dtaudio = self.get_audio_sync(now_ns)
            dtsize = N + (ns_to_audio_frames(cfg.audio.samples_per_sec,
                                             dtaudio)
                          if dtaudio > 0 else 0)
            for c in range(cfg.capture_channels):
                ring = self.rings[c]
                if ring.size >= dtsize:
                    ring.pop_front(ring.size - dtsize)
                    ring.peek_front(N, out=frame[c])
                    valid[c] = True
        return SpectrumTickInput(frame, valid, active, True, self.input_rms)

    def drain_meter_samples(self, now_ns: int, dt: float, window: np.ndarray
                            ) -> tuple[bool, bool]:
        """Pop all synced audio into the meter ring ``window [C, M]``
        (src/source_generic.cpp:201-222). Returns (run, fresh)."""
        cfg = self.cfg
        self.tick_ts = now_ns
        run = self.check_audio_capture(dt) and cfg.capture_channels > 0
        fresh = (now_ns - self.capture_ts) <= CAPTURE_TIMEOUT_NS
        if not run:
            return False, fresh
        M = cfg.fft_size
        if fresh:
            with self._lock:
                dtaudio = self.get_audio_sync(now_ns)
                dtsize = (ns_to_audio_frames(cfg.audio.samples_per_sec,
                                             dtaudio)
                          if dtaudio > 0 else 0)
                for c in range(cfg.capture_channels):
                    ring = self.rings[c]
                    pos = int(self.meter_pos[c])
                    while ring.size > dtsize:
                        consume = ring.size - dtsize
                        room = M - pos
                        take = min(consume, room)
                        ring.pop_front(take, out=window[c, pos:pos + take])
                        pos = (pos + take) % M
                    self.meter_pos[c] = pos
        return True, fresh
