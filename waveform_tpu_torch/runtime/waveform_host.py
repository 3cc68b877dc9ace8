"""Waveform (time-domain oscilloscope) mode on the host.

The port's own copy of ``waveform_tpu/runtime/waveform_host.py`` (numpy
only): the host spec that ``runtime/waveform_device.py`` is held to.

Re-implements the reference's timestamp-driven resampler
(reference src/source_generic.cpp:271-390): each tick consumes the
ring up to the A/V-sync reserve, maps output pixels to sample timestamps at
``step_ns = meter_ms·1e6/width`` spacing, scrolls the display buffer left,
and dB-converts only the freshly appended region — the display accumulates
already-converted pixels as it scrolls.

This stage is inherently host-sequential (data-dependent consume/rotate), so
it runs in NumPy per stream; the per-pixel resample itself is vectorized.
"""

from __future__ import annotations

import numpy as np

from ..core.config import CAPTURE_TIMEOUT_NS, DB_MIN, ResolvedConfig
from ..core.ring import audio_frames_to_ns, ns_to_audio_frames
from .source import StreamSource


def _dbfs(x: np.ndarray) -> np.ndarray:
    out = np.full_like(x, DB_MIN, dtype=np.float32)
    pos = x > 0.0
    out[pos] = 20.0 * np.log10(x[pos])
    return out


class WaveformScroller:
    def __init__(self, cfg: ResolvedConfig):
        self.cfg = cfg
        O = max(cfg.output_channels, max(cfg.capture_channels, 1))
        self.buf = np.full((O, cfg.fft_size), DB_MIN, np.float32)
        self.last_silent = False

    @property
    def display(self) -> np.ndarray:
        return self.buf[:self.cfg.display_channels]

    def tick(self, src: StreamSource, now_ns: int, dt: float) -> np.ndarray:
        cfg = self.cfg
        src.tick_ts = now_ns
        src.update_input_rms()
        if not (src.check_audio_capture(dt) and cfg.capture_channels > 0):
            return self.display

        outsz = cfg.fft_size  # = width (src/source.cpp:1140)
        C = cfg.capture_channels
        sr = cfg.audio.samples_per_sec

        if (not src.show) or (now_ns - src.capture_ts) > CAPTURE_TIMEOUT_NS:
            if not self.last_silent:
                self.buf[:max(2 if cfg.stereo else 1, 1)] = DB_MIN
                self.last_silent = True
            return self.display

        # everything below trims/pops src.rings: hold the capture lock so
        # the audio thread's push (which may reallocate a ring) cannot
        # interleave — the reference holds m_mtx for the whole tick
        # (source.cpp:1326-1331)
        with src._lock:
            return self._tick_locked(src, now_ns)

    def _tick_locked(self, src: StreamSource, now_ns: int) -> np.ndarray:
        cfg = self.cfg
        outsz = cfg.fft_size
        C = cfg.capture_channels
        sr = cfg.audio.samples_per_sec
        dtaudio = src.get_audio_sync(now_ns)
        reserve = ns_to_audio_frames(sr, dtaudio) if dtaudio > 0 else 0
        max_size = cfg.waveform_samples + reserve
        for c in range(C):
            if src.rings[c].size <= reserve:
                return self.display  # not enough look-ahead yet

        step_ns = (cfg.meter_ms * 1_000_000) // outsz
        counts = np.zeros(2, np.int64)
        silent_channels = 0
        for c in range(C):
            ring = src.rings[c]
            if ring.size > max_size:
                ring.pop_front(ring.size - max_size)
            total = ring.size
            consume = total - reserve
            if total <= reserve:
                return self.display

            start_ts = src.audio_ts - audio_frames_to_ns(sr, total)
            stop_ts = src.audio_ts - audio_frames_to_ns(sr, reserve)
            if start_ts >= src.audio_ts or stop_ts > src.audio_ts:
                return self.display  # timestamp rollover, give up
            if src.waveform_ts < start_ts:
                src.waveform_ts = start_ts  # catch up if falling behind
            if (src.waveform_ts > stop_ts
                    and (src.waveform_ts - stop_ts) > step_ns):
                src.waveform_ts = start_ts  # fix desync

            temp = np.empty(total, np.float32)
            ring.peek_front(total, out=temp)
            ring.pop_front(consume)

            # vectorized pixel→sample resample (src loop :323-333)
            ts = src.waveform_ts + np.arange(outsz, dtype=np.int64) * step_ns
            ok = (ts < stop_ts) & (ts >= src.waveform_ts)
            n = int(np.argmin(ok)) if not ok.all() else outsz
            ts = ts[:n]
            idx = (ts_to_frames(sr, src.audio_ts - ts)
                   .clip(reserve + 1, total))
            new = temp[total - idx]
            counts[c] = n
            if n > 0:
                self.buf[c] = np.roll(self.buf[c], -n)
                self.buf[c, outsz - n:] = new

            if np.any(self.buf[c] != 0.0):
                self.last_silent = False
            else:
                silent_channels += 1

        src.waveform_ts += int(counts[0]) * step_ns
        if silent_channels >= C:
            self.last_silent = True

        if self.last_silent:
            self.buf[:2 if cfg.stereo else 1] = DB_MIN
            return self.display

        if cfg.output_channels > C:
            self.buf[1] = self.buf[0]

        # dB-convert only the fresh tail (src/source_generic.cpp:366-381)
        if cfg.stereo:
            for c in range(2):
                k = outsz - int(counts[c])
                self.buf[c, k:] = _dbfs(np.abs(self.buf[c, k:]))
        elif C > 1:
            k = outsz - int(counts[0])
            self.buf[0, k:] = _dbfs(
                (np.abs(self.buf[0, k:]) + np.abs(self.buf[1, k:])) * 0.5)
        else:
            k = outsz - int(counts[0])
            self.buf[0, k:] = _dbfs(np.abs(self.buf[0, k:]))

        if cfg.normalize_volume:
            comp = min(cfg.volume_target - float(_dbfs(
                np.array([src.input_rms], np.float32))[0]), cfg.max_gain)
            for c in range(2 if cfg.stereo else 1):
                k = outsz - int(counts[c if cfg.stereo else 0])
                self.buf[c, k:] += comp
        return self.display


def ts_to_frames(sr: int, ns: np.ndarray) -> np.ndarray:
    """Vectorized ns→frames (floor), matching ns_to_audio_frames."""
    return (ns.astype(np.int64) * sr) // 1_000_000_000


class BatchedWaveformScroller:
    """Vectorized oscilloscope for S streams sharing one sync state.

    The fan-out case (one timestamp source, S consumers — the analog of the
    reference's output-bus capture): consume/reserve/counts are identical
    across streams, so the resample, scroll, silence scan and fresh-tail dB
    conversion all vectorize over [S, C, ·] arrays.  Per-stream Python work
    drops from O(S) to O(1) per tick.

    Streams with independent sync states keep :class:`WaveformScroller`.
    """

    def __init__(self, cfg: ResolvedConfig, num_streams: int):
        self.cfg = cfg
        self.S = num_streams
        C = max(cfg.capture_channels, 1)
        self.C = C
        O = max(cfg.output_channels, C)
        self.buf = np.full((num_streams, O, cfg.fft_size), DB_MIN, np.float32)
        self.last_silent = np.zeros(num_streams, bool)
        self.waveform_ts = 0
        # shared pending queue [S, C, n] chunks + sync stamps;
        # startup silence prefill like the reference (src/source.cpp:1243-48)
        self._chunks: list[np.ndarray] = [
            np.zeros((num_streams, C, cfg.fft_size), np.float32)]
        self._queued = cfg.fft_size
        self.capture_ts = 0
        self.audio_ts = 0
        self.show = True
        self.input_rms = np.zeros(num_streams, np.float32)
        # volume normalization: vectorized update_input_rms — per-stream 1 s
        # windows of per-timepoint max-channel squares, drained in sync
        # (src/source.cpp:810-835), shared positions since sync is shared
        if cfg.normalize_volume:
            R = cfg.input_rms_size
            self._rms_win = np.zeros((num_streams, R), np.float32)
            self._rms_pos = 0
            self._rms_sum = np.zeros(num_streams, np.float64)
            self._rms_q: list[np.ndarray] = []
            self._rms_queued = 0

    # -- feeding (shared timestamps) -----------------------------------
    def feed_batch(self, data: np.ndarray, timestamp_ns: int,
                   now_ns: int, muted: bool = False) -> None:
        cfg = self.cfg
        frames = data.shape[-1]
        if frames == 0 or cfg.capture_channels == 0:
            return
        self.capture_ts = now_ns
        audio_len = audio_frames_to_ns(cfg.audio.samples_per_sec, frames)
        from ..core.config import MAX_TS_DELTA_NS
        self.audio_ts = (now_ns if abs(timestamp_ns - now_ns) > MAX_TS_DELTA_NS
                         else timestamp_ns + audio_len)
        cut = np.asarray(
            data[:, cfg.channel_base:cfg.channel_base + self.C], np.float32)
        if cut.shape[1] < self.C:
            # narrow packets zero-fill missing channels, like
            # StreamSource._capture_locked and DeviceWaveformEngine.feed —
            # otherwise tick()'s chunk concatenate raises on the mismatch
            cut = np.concatenate([cut, np.zeros(
                (cut.shape[0], self.C - cut.shape[1], frames),
                np.float32)], axis=1)
        # the RMS derives from raw PRE-mute samples (src/source.cpp:
        # 1843-1871 runs before the zero-fill)
        if cfg.normalize_volume:
            self._rms_q.append(
                np.max(np.abs(cut), axis=1).astype(np.float32) ** 2)
            self._rms_queued += frames
        if muted and not cfg.settings.ignore_mute:
            cut = np.zeros_like(cut)   # mute zero-fill (src:1878-1879)
        self._chunks.append(cut)
        self._queued += frames
        # bound the queue like capture_audio's trim (waveform bufsz)
        dtaudio = self._sync(now_ns)
        reserve = (ns_to_audio_frames(cfg.audio.samples_per_sec, dtaudio)
                   if dtaudio > 0 else 0)
        max_q = reserve + cfg.waveform_samples
        while self._queued > max_q and self._chunks:
            drop = self._queued - max_q
            head = self._chunks[0]
            if head.shape[-1] <= drop:
                self._queued -= head.shape[-1]
                self._chunks.pop(0)
            else:
                self._chunks[0] = head[..., drop:]
                self._queued -= drop
                break
        if cfg.normalize_volume:
            max_rq = reserve + cfg.input_rms_size
            while self._rms_queued > max_rq and self._rms_q:
                drop = self._rms_queued - max_rq
                head = self._rms_q[0]
                if head.shape[-1] <= drop:
                    self._rms_queued -= head.shape[-1]
                    self._rms_q.pop(0)
                else:
                    self._rms_q[0] = head[:, drop:]
                    self._rms_queued -= drop
                    break

    def _update_input_rms(self, now_ns: int) -> None:
        """Vectorized update_input_rms (runtime/source.py:180-200)."""
        cfg = self.cfg
        R = cfg.input_rms_size
        dtaudio = self._sync(now_ns)
        reserve = (ns_to_audio_frames(cfg.audio.samples_per_sec, dtaudio)
                   if dtaudio > 0 else 0)
        if self._rms_queued <= reserve:
            return
        consume = self._rms_queued - reserve
        parts, got = [], 0
        while got < consume and self._rms_q:
            head = self._rms_q[0]
            use = min(head.shape[-1], consume - got)
            parts.append(head[:, :use])
            if use == head.shape[-1]:
                self._rms_q.pop(0)
            else:
                self._rms_q[0] = head[:, use:]
            got += use
        self._rms_queued -= got
        newsq = np.concatenate(parts, axis=-1)
        k = newsq.shape[-1]
        if k >= R:
            self._rms_win[:] = newsq[:, -R:]
            self._rms_sum = self._rms_win.sum(-1, dtype=np.float64)
            self._rms_pos = 0
        else:
            pos = (self._rms_pos + np.arange(k)) % R
            self._rms_sum += (newsq.sum(-1, dtype=np.float64)
                              - self._rms_win[:, pos].sum(-1, dtype=np.float64))
            self._rms_win[:, pos] = newsq
            self._rms_pos = (self._rms_pos + k) % R
        self.input_rms = np.sqrt(
            np.maximum(self._rms_sum, 0.0) / R).astype(np.float32)

    def _sync(self, ts: int) -> int:
        from ..core.config import MAX_TS_DELTA_NS
        audio_ts = self.audio_ts + self.cfg.ts_offset_ns
        delta = min(abs(audio_ts - ts), MAX_TS_DELTA_NS)
        return -delta if audio_ts < ts else delta

    # -- tick -----------------------------------------------------------
    def tick(self, now_ns: int) -> np.ndarray:
        cfg = self.cfg
        outsz = cfg.fft_size
        C = self.C
        sr = cfg.audio.samples_per_sec
        if cfg.normalize_volume:
            self._update_input_rms(now_ns)

        if (not self.show) or (now_ns - self.capture_ts) > CAPTURE_TIMEOUT_NS:
            fresh = ~self.last_silent
            self.buf[fresh, :2 if cfg.stereo else 1] = DB_MIN
            self.last_silent[:] = True
            return self.display

        dtaudio = self._sync(now_ns)
        reserve = ns_to_audio_frames(sr, dtaudio) if dtaudio > 0 else 0
        if self._queued <= reserve:
            return self.display

        total = self._queued
        consume = total - reserve
        start_ts = self.audio_ts - audio_frames_to_ns(sr, total)
        stop_ts = self.audio_ts - audio_frames_to_ns(sr, reserve)
        if start_ts >= self.audio_ts or stop_ts > self.audio_ts:
            return self.display
        step_ns = (cfg.meter_ms * 1_000_000) // outsz
        if self.waveform_ts < start_ts:
            self.waveform_ts = start_ts
        if (self.waveform_ts > stop_ts
                and (self.waveform_ts - stop_ts) > step_ns):
            self.waveform_ts = start_ts

        temp = np.concatenate(self._chunks, axis=-1)       # [S, C, total]
        keep = temp[..., consume:]
        self._chunks = [keep] if keep.shape[-1] else []
        self._queued = reserve

        ts = self.waveform_ts + np.arange(outsz, dtype=np.int64) * step_ns
        ok = (ts < stop_ts) & (ts >= self.waveform_ts)
        n = int(np.argmin(ok)) if not ok.all() else outsz
        if n > 0:
            idx = (ts_to_frames(sr, self.audio_ts - ts[:n])
                   .clip(reserve + 1, total))
            new = temp[..., total - idx]                   # [S, C, n]
            self.buf[:, :C] = np.concatenate(
                [self.buf[:, :C, n:], new], axis=-1)
        self.waveform_ts += n * step_ns

        silent = ~(self.buf[:, :C] != 0.0).any(axis=(1, 2))
        self.last_silent = silent
        self.buf[silent, :2 if cfg.stereo else 1] = DB_MIN

        live = ~silent
        if live.any() and n > 0:
            k = outsz - n
            if cfg.output_channels > C:
                self.buf[live, 1] = self.buf[live, 0]
            # the reference converts channel ch over counts[ch] pixels,
            # and counts[ch] == 0 for ch >= capture_channels — so a
            # stereo display of MONO capture keeps channel 1's fresh
            # tail RAW (the pre-conversion memcpy of channel 0,
            # source_generic.cpp:363-371); only real capture channels
            # convert (and volume-compensate)
            D = min(2, C) if cfg.stereo else 1
            tails = self.buf[live][:, :, k:]               # copy
            if cfg.stereo:
                conv = _dbfs(np.abs(tails[:, :D]))
            elif C > 1:
                conv = _dbfs((np.abs(tails[:, 0])
                              + np.abs(tails[:, 1])) * 0.5)[:, None]
            else:
                conv = _dbfs(np.abs(tails[:, 0]))[:, None]
            if cfg.normalize_volume:
                comp = np.minimum(
                    cfg.volume_target - _dbfs(self.input_rms[live]),
                    cfg.max_gain)
                conv = conv + comp[:, None, None]
            # write back through one advanced-index assignment
            buf_live = self.buf[live]
            buf_live[:, :D, k:] = conv
            self.buf[live] = buf_live
        return self.display

    @property
    def display(self) -> np.ndarray:
        return self.buf[:, :self.cfg.display_channels]
