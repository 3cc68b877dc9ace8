"""Device-resident batched waveform (oscilloscope) engine.

The PyTorch counterpart of ``waveform_tpu/runtime/waveform_device.py``: S
streams with independent sync states, the host scroller's semantics
(``runtime/waveform_host.WaveformScroller``, the reference's
src/source_generic.cpp:271-390) as one batched device step.

* samples live in a device ring ``[S, C, L]`` (``dsp/devring.py``); the
  host pushes only new arrivals per tick (a count per stream),
* the per-pixel resample is one batched gather keyed on host-computed
  per-stream index rows (the timestamp math stays on the host in int64),
* the scroll is a per-stream slice of ``buf ++ gathered`` at the stream's
  own fresh-pixel count,
* the fresh-tail |x| -> dBFS conversion, mono fold, silence latch and
  volume normalization (a device ring of RMS squares, as in
  ``ServingEngine``) are masked elementwise ops.

The host half (feed queues, or the C++ assembler in ``native/``, and the
assembly of one packed row per stream) is the JAX engine's.  Every
per-tick value rides the packed upload and is read on the device, so on a
CUDA device a tick is one replay of a captured graph
(``runtime/graphs.py``), as in ``ServingEngine`` (the shared plumbing:
``serving.PackedTickEngine``, cohort mode for ``runtime/multi.py``
included); the ring, display buffer, latch and RMS ring update in place.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..core.config import (
    CAPTURE_TIMEOUT_NS,
    DB_MIN,
    MAX_TS_DELTA_NS,
    ResolvedConfig,
    check_config,
)
from ..core.device import checked_device
from ..core.enums import DisplayMode
from ..core.ring import audio_frames_to_ns
from ..dsp.devring import init_ring, push
from ..dsp.spectrum import dbfs
from .serving import PackedTickEngine


class _WfStream:
    __slots__ = ("chunks", "rms_chunks", "queued", "capture_ts", "audio_ts",
                 "waveform_ts", "total", "show")

    def __init__(self):
        self.chunks: deque[np.ndarray] = deque()
        self.rms_chunks: deque[np.ndarray] = deque()
        self.queued = 0
        self.capture_ts = 0
        self.audio_ts = 0
        self.waveform_ts = 0
        self.total = 0      # the reference ring's post-trim size
        self.show = True


def rms_window_sum(rows: torch.Tensor, reserve: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Each stream's sum of the ``size`` squares that end ``reserve``
    samples before the newest (the start clipped into the row, as the JAX
    step's ``dynamic_slice``): ``rows`` [S, Lr] f32, ``reserve`` [S]
    integer -> [S] f32.  The window is picked out of the sliding view of
    the row by its start, so no [S, size] index is built."""
    Lr = rows.shape[-1]
    start = (Lr - reserve.to(torch.int64) - size).clamp(0, Lr - size)
    streams = torch.arange(rows.shape[0], device=rows.device)
    return rows.unfold(-1, size, 1)[streams, start].sum(-1)


class DeviceWaveformEngine(PackedTickEngine):
    """Batched oscilloscope serving for S independently-synced streams."""

    def __init__(self, cfg: ResolvedConfig, num_streams: int,
                 hop_budget: int | None = None, max_lead_s: float = 0.25,
                 microbatch: int | str = 1,
                 use_native: bool | None = None,
                 device: torch.device | str = "cuda"):
        check_config(cfg)
        if cfg.display_mode != DisplayMode.WAVEFORM:
            raise ValueError("DeviceWaveformEngine needs waveform mode")
        self.device = checked_device(device, type(self).__name__)
        self.cfg = cfg
        self.S = num_streams
        self._max_lead_s = max_lead_s   # kept for resized()
        self._use_native_req = use_native
        C = max(cfg.capture_channels, 1)
        self.C = C
        self.W = cfg.fft_size  # display width in pixels (src/source.cpp:1140)
        sr = cfg.audio.samples_per_sec
        self.H = hop_budget or (2 * int(sr / cfg.fps) + 16)
        # Ring sizing: waveform window + the worst sync reserve the ring can
        # track + one hop of slack.  The reserve has two parts: the user ts
        # offset, and timestamps running ahead of the clock (a pre-buffering
        # player) — the host scroller's growable ring absorbs leads up to
        # MAX_TS_DELTA_NS (16 s); the static device ring budgets
        # ``max_lead_s`` of it (S·C·L·4 B) and CLAMPS larger leads at tick
        # time, so an extreme lead renders early instead of freezing.
        reserve_cap = max(cfg.ts_offset_ns, 0) * sr // 1_000_000_000
        lead_cap = int(max_lead_s * sr)
        self._reserve_limit = int(reserve_cap + lead_cap)
        self.L = int(cfg.waveform_samples + self._reserve_limit + self.H)
        self.step_ns = (cfg.meter_ms * 1_000_000) // self.W

        self._streams = [_WfStream() for _ in range(num_streams)]
        # vectorized-assembly scratch (see _assemble): per-stream int64
        # state snapshots + the per-pixel timestamp offsets
        self._pix = np.arange(self.W, dtype=np.int64) * self.step_ns
        self._v_hidden = np.zeros(num_streams, bool)
        self._v_take = np.zeros(num_streams, np.int64)
        self._v_left = np.zeros(num_streams, np.int64)
        self._v_audio = np.zeros(num_streams, np.int64)
        self._v_total0 = np.zeros(num_streams, np.int64)
        self._v_wts = np.zeros(num_streams, np.int64)
        self._normalize = cfg.normalize_volume
        # startup prefill: fft_size (= width) silent samples, exactly like
        # StreamSource (src/source.cpp:1243-1248; runtime/source.py)
        for p in self._streams:
            p.chunks.append(np.zeros((C, cfg.fft_size), np.float32))
            p.queued = cfg.fft_size
            if self._normalize:
                p.rms_chunks.append(np.zeros(cfg.fft_size, np.float32))

        self.O = max(cfg.output_channels, C)
        self._init_device_state()

        # native C++ assembler (native/): per-stream rings + sync + the
        # whole waveform host assembly (drain, int64 timestamp math,
        # gather-index rows) without per-stream Python work
        self._native = None
        if use_native or use_native is None:
            try:
                from ..native import NativeAssembler
                self._native = NativeAssembler(
                    num_streams, C, cfg.fft_size,
                    cfg.audio.samples_per_sec, cfg.ts_offset_ns,
                    prefill=True, rms=self._normalize)
                # waveform mode trims the feed queue to the device ring's
                # flat capacity (feed() NOTE below), not the spectrum rule
                self._native.set_trim_cap(self.L)
            except (RuntimeError, OSError):
                if use_native:
                    raise
                self._native = None

        # All host-side per-tick inputs ride ONE packed [S, packed_width]
        # upload — samples, RMS squares, the per-pixel gather rows and the
        # 5 meta columns (counts, n, run, timeout, reserve) — pinned and
        # double-buffered behind CUDA events (serving.PackedTickEngine).
        # microbatch k > 1: k assembled slots flush as ONE captured graph
        # of k packed ticks; "auto" decides k (AutoMicrobatchMixin)
        self._init_microbatch(microbatch)
        self._init_uploads()

    def _init_device_state(self) -> None:
        """Allocate the device-resident per-stream state (sample ring,
        display buffer, silence latch, RMS ring) and build the step over
        it."""
        cfg, dev, S = self.cfg, self.device, self.S
        self.ring = init_ring(S, self.C, self.L, dev)
        self.buf = torch.full((S, self.O, self.W), DB_MIN,
                              dtype=torch.float32, device=dev)
        self.latch = torch.zeros(S, dtype=torch.bool, device=dev)
        # slack beyond the 1 s window: sync-reserve squares park at the
        # tail and the windowed sum skips them (drained only once the
        # matching samples pass the reserve, like update_input_rms,
        # runtime/source.py)
        self.rms_ring = (init_ring(S, 1,
                                   cfg.input_rms_size + self._reserve_limit,
                                   dev)
                         if self._normalize else None)
        self._step = self._make_step()

    def _init_uploads(self) -> None:
        super()._init_uploads()
        # a tick between microbatch flushes returns the last flushed frame
        self._last_pixels = self.display.clone()

    # ------------------------------------------------------------------

    def _make_step(self):
        """The device step over the engine's state, in place: ring push,
        RMS window, resample gather, scroll, silence latch, fresh-tail dB,
        fills.  Returns the tick's display channels."""
        cfg = self.cfg
        C, O, W, L = self.C, self.O, self.W, self.L
        stereo = cfg.stereo
        D = 2 if stereo else 1
        DC = min(D, C) if stereo else 1
        Dd = cfg.display_channels
        normalize = self._normalize
        rms_size = cfg.input_rms_size
        pix = torch.arange(W, device=self.device)

        def step(new, counts, idx, n, run, timeout, rms_sq, reserve):
            ring, buf, latch = self.ring, self.buf, self.latch
            S = new.shape[0]
            push(ring, new, counts)
            input_rms = None
            if normalize:
                push(self.rms_ring, rms_sq, counts)
                # window the 1 s sum to end at the sync reserve: squares
                # for frames the display hasn't consumed yet sit in the
                # tail and must not lead the gain (host spec:
                # update_input_rms drains only past the reserve)
                input_rms = torch.sqrt(rms_window_sum(
                    self.rms_ring.buf[:, 0], reserve, rms_size) / rms_size)

            # batched resample gather: sample ``idx`` frames from the end
            gpos = (L - idx).clamp(0, L - 1)                      # [S, W]
            gathered = torch.gather(ring.buf, -1,
                                    gpos[:, None, :].expand(S, C, W))

            # scroll by n fresh pixels: (buf ++ new_pixels)[n : n+W]
            ext = torch.cat([buf[:, :C], gathered], dim=-1)     # [S, C, 2W]
            cols = n.clamp(0, W)[:, None] + pix                    # [S, W]
            scrolled = torch.gather(ext, -1, cols[:, None, :].expand(S, C, W))
            run_b = run[:, None, None]
            bufC = torch.where(run_b, scrolled, buf[:, :C])

            # silence latch on the post-scroll mixed raw/dB buffer — the
            # exact WaveformScroller semantics (waveform_host.py:104-115)
            silent = ~(bufC != 0.0).any(-1).any(-1)                # [S]
            new_latch = torch.where(run, silent, latch)

            out = buf.clone()
            out[:, :C] = bufC
            if O > C:
                out[:, 1] = torch.where(run_b[:, 0], bufC[:, 0], out[:, 1])

            # fresh-tail dB conversion with fold (src_generic.cpp:366-381).
            # Only REAL capture channels convert: the reference's per-
            # channel loop covers counts[ch] pixels and counts[ch] == 0
            # for ch >= capture_channels, so a stereo display of mono
            # capture keeps channel 1's fresh tail RAW (the pre-conversion
            # channel-0 copy, source_generic.cpp:363-371)
            fresh = ((pix >= (W - n)[:, None]) & run[:, None]
                     & ~new_latch[:, None])                        # [S, W]
            if stereo:
                conv = dbfs(out[:, :DC].abs())
            elif C > 1:
                conv = dbfs((out[:, 0].abs() + out[:, 1].abs()) * 0.5)[:, None]
            else:
                conv = dbfs(out[:, 0].abs())[:, None]
            if normalize:
                comp = torch.clamp_max(cfg.volume_target - dbfs(input_rms),
                                       cfg.max_gain)
                conv = conv + comp[:, None, None]
            out[:, :DC] = torch.where(fresh[:, None, :], conv, out[:, :DC])

            # silence fill + timeout fill (DB_MIN once unless latched)
            fill = (run & new_latch) | (timeout & ~latch)
            out[:, :D] = out[:, :D].masked_fill(fill[:, None, None], DB_MIN)
            buf.copy_(out)
            latch.copy_(new_latch | timeout)
            return out[:, :Dd]

        return step

    # -- packed upload (the ServingEngine contract) ----------------------

    @property
    def packed_width(self) -> int:
        """Row width of the packed per-tick upload: C*H samples, the H RMS
        squares only under volume normalization, the W per-pixel gather
        indices (exact in float32: they are < L < 2**24), and 5 meta
        columns (counts, n, run, timeout, reserve)."""
        R = self.H if self._normalize else 0
        return self.C * self.H + R + self.W + 5

    def _bind_external(self, view: np.ndarray) -> None:
        """Point the assembly views at one tick's upload ``view`` (flat
        float32, ``_stride`` long): the packed rows."""
        S, Wp = self.S, self.packed_width
        CH, H, W = self.C * self.H, self.H, self.W
        R = H if self._normalize else 0
        rows = view[:S * Wp].reshape(S, Wp)
        self._in_buf = rows
        self._push_buf = rows[:, :CH].reshape(-1, self.C, H)
        self._rms_buf = rows[:, CH:CH + R]
        self._idx_buf = rows[:, CH + R:CH + R + W]
        self._meta_buf = rows[:, CH + R + W:]

    def _packed(self, flat: torch.Tensor, uniform: bool):
        """The step on one tick's uploaded ``flat``: every value read from
        its rows on the device.  The ring always takes the per-stream
        push (``uniform`` is False)."""
        S, Wp = self.S, self.packed_width
        C, H, W = self.C, self.H, self.W
        rows = flat[:S * Wp].view(S, Wp)
        off = C * H
        rms_sq = None
        if self._normalize:
            rms_sq = rows[:, off:off + H][:, None, :]
            off += H
        idx = rows[:, off:off + W].to(torch.int64)
        meta = rows[:, off + W:]
        return self._step(rows[:, :C * H].view(S, C, H),
                          meta[:, 0].to(torch.int64),
                          idx, meta[:, 1].to(torch.int64), meta[:, 2] > 0.5,
                          meta[:, 3] > 0.5, rms_sq,
                          meta[:, 4].to(torch.int64))

    def _stage(self, now_ns: int, dt_f=None) -> bool:
        """Assemble the bound upload (the waveform tick has no scalars
        behind its rows).  Returns False: no uniform-count form."""
        self._assemble(now_ns)
        return False

    # ------------------------------------------------------------------

    def feed(self, stream: int, data: np.ndarray | None, timestamp_ns: int,
             now_ns: int | None = None, muted: bool = False) -> None:
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        cfg = self.cfg
        frames = 0 if data is None else data.shape[-1]
        if frames == 0 or cfg.capture_channels == 0:
            return
        if self._native is not None:
            if data is not None:
                data = np.asarray(
                    data[cfg.channel_base:cfg.channel_base + self.C],
                    np.float32)
            self._native.feed(stream, data, timestamp_ns, now_ns,
                              muted and not cfg.settings.ignore_mute)
            return
        p = self._streams[stream]
        p.capture_ts = now_ns
        audio_len = audio_frames_to_ns(cfg.audio.samples_per_sec, frames)
        if abs(timestamp_ns - now_ns) > MAX_TS_DELTA_NS:
            p.audio_ts = now_ns
        else:
            p.audio_ts = timestamp_ns + audio_len

        # data is non-None here (frames == 0 early-returns above)
        raw = np.asarray(
            data[cfg.channel_base:cfg.channel_base + self.C], np.float32)
        if raw.shape[0] < self.C:
            raw = np.vstack([raw, np.zeros(
                (self.C - raw.shape[0], frames), np.float32)])
        if self._normalize:
            # raw (pre-mute) squares, like the reference (src/source.cpp:1843)
            p.rms_chunks.append(
                np.max(np.abs(raw), axis=0).astype(np.float32) ** 2)
        chunk = (np.zeros((self.C, frames), np.float32)
                 if muted and not cfg.settings.ignore_mute else raw)
        p.chunks.append(chunk)
        p.queued += frames
        # NOTE: the reference's capture-side drop-oldest trim
        # (src/source.cpp:1883-1886) is implicit here — the device ring
        # keeps the newest L samples and the tick caps the gather depth
        # (``total``) at the reference's max ring size, so over-old samples
        # simply fall out of reach.  Dropping queued-but-unpushed samples
        # would instead punch a discontinuity into the device ring.  A
        # sanity bound protects against a runaway feeder:
        max_q = self.L
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

    def feed_batch(self, data: np.ndarray, timestamp_ns: int,
                   now_ns: int | None = None, muted: bool = False) -> None:
        """Synchronized ingestion for all S streams at once.

        ``data`` is [S, channels, frames] float32 planar with one shared
        timestamp: one native call (or one Python loop without the native
        assembler) instead of S per-stream calls."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        cfg = self.cfg
        frames = data.shape[-1]
        if frames == 0 or cfg.capture_channels == 0:
            return
        if self._native is not None:
            self._native.feed_batch(
                np.asarray(
                    data[:, cfg.channel_base:cfg.channel_base + self.C],
                    np.float32),
                timestamp_ns, now_ns, muted and not cfg.settings.ignore_mute)
            return
        for s in range(self.S):
            self.feed(s, data[s], timestamp_ns, now_ns=now_ns, muted=muted)

    def set_show(self, stream: int, show: bool) -> None:
        self._streams[stream].show = show
        if self._native is not None:
            self._native.set_show(stream, bool(show))

    # ------------------------------------------------------------------

    def _assemble(self, now_ns: int) -> None:
        """Fill the bound packed rows: samples, RMS squares, per-pixel
        gather rows and the 5 meta columns (the host half of the tick —
        all int64 timestamp math stays here).

        Vectorized over streams, as in the JAX engine: only the chunk drain
        (a data-dependent deque walk) stays per stream; every
        timestamp/reserve computation runs as [S]-shaped int64 array math
        with the scalar loop's semantics, and the per-pixel index math is
        bounded to the FRESH columns via the closed-form ni (see below)."""
        cfg = self.cfg
        W = self.W
        S = self.S
        sr = cfg.audio.samples_per_sec
        NSC = 1_000_000_000

        if self._native is not None:
            # C++ writes the whole row — drained samples, RMS squares,
            # gather indices and the 5 meta columns — with bit-identical
            # int64 semantics (tests pin display equality vs this path)
            self._native.assemble_waveform(
                now_ns, self.H, W, self.step_ns,
                int(cfg.waveform_samples), self.L, self._reserve_limit,
                self._in_buf, self._normalize)
            return

        meta = self._meta_buf
        self._push_buf[:] = 0.0
        if self._normalize:
            self._rms_buf[:] = 0.0
        self._idx_buf[:] = 1.0
        meta[:] = 0.0

        # --- phase 1: per-stream drain + state pickup (deque walk) ------
        # The drain runs UNCONDITIONALLY, hidden or not: the device ring
        # is the reference's capture ring, which fills on the audio thread
        # regardless of show — otherwise feed()'s queue trim punches a gap
        # and a resume gathers garbled stale samples across it.
        hidden = self._v_hidden
        take_a = self._v_take
        left_a = self._v_left
        audio_a = self._v_audio
        total0 = self._v_total0
        wts0 = self._v_wts
        for i, p in enumerate(self._streams):
            hidden[i] = ((not p.show)
                         or (now_ns - p.capture_ts) > CAPTURE_TIMEOUT_NS)
            # consume up to the hop budget; any backlog stays queued and
            # the effective "newest sample" timestamp excludes it, so the
            # gather only references samples really in the device ring
            take = min(p.queued, self.H)
            take_a[i] = take
            left_a[i] = p.queued - take
            audio_a[i] = p.audio_ts
            total0[i] = p.total
            wts0[i] = p.waveform_ts
            got = 0
            while got < take and p.chunks:
                head = p.chunks[0]
                m = head.shape[-1]
                use = min(m, take - got)
                self._push_buf[i, :, got:got + use] = head[:, :use]
                if self._normalize and p.rms_chunks:
                    self._rms_buf[i, got:got + use] = p.rms_chunks[0][:use]
                    if use == p.rms_chunks[0].shape[-1]:
                        p.rms_chunks.popleft()
                    else:
                        p.rms_chunks[0] = p.rms_chunks[0][use:]
                if use == m:
                    p.chunks.popleft()
                else:
                    p.chunks[0] = head[:, use:]
                p.queued -= use
                got += use

        # --- phase 2: vectorized timestamp / reserve / index math -------
        # Exact int64 floor-division equivalents of audio_frames_to_ns /
        # ns_to_audio_frames / ts_to_frames; every multiply operates on a
        # bounded DELTA (≤16 s or ≤L frames), so int64 never overflows
        # even for epoch-scale wall timestamps.
        audio_eff = audio_a - (left_a * NSC) // sr
        delta = audio_eff + cfg.ts_offset_ns - now_ns
        lag = np.minimum(np.abs(delta), MAX_TS_DELTA_NS)
        reserve = np.where(delta > 0, (lag * sr) // NSC, 0)
        # the static device ring budgets _reserve_limit of lead; an
        # extreme timestamp lead clamps (renders early) instead of
        # starving the gather forever (the host ring would grow)
        np.minimum(reserve, self._reserve_limit, out=reserve)
        # reference ring size this tick: last tick's reserve + arrivals,
        # trimmed (feed-side) to reserve + waveform window
        total = np.minimum(total0 + take_a,
                           np.minimum(cfg.waveform_samples + reserve,
                                      self.L))
        meta[:, 0] = take_a      # counts
        meta[:, 3] = hidden      # timeout (display blanks; drain ran)
        meta[:, 4] = reserve

        run = ~hidden & (total > reserve)
        start_ts = audio_eff - (total * NSC) // sr
        stop_ts = audio_eff - (reserve * NSC) // sr
        # timestamp rollover: give up on this tick's render
        run &= (start_ts < audio_eff) & (stop_ts <= audio_eff)
        wts = np.where(wts0 < start_ts, start_ts, wts0)
        wts = np.where((wts > stop_ts) & (wts - stop_ts > self.step_ns),
                       start_ts, wts)
        # fresh-pixel count in closed form: the scalar loop's ok-mask is
        # ok(p) = (wts + p·step < stop_ts) — monotone in p, so
        # #leading-Trues = ceil((stop−wts)/step), capped at W; it also
        # bounds the index math below to the FRESH columns
        span = stop_ts - wts
        ni = np.clip((span + self.step_ns - 1) // self.step_ns, 0, W)
        ni = np.where(run, ni, 0)
        meta[:, 1] = ni          # fresh pixels
        meta[:, 2] = run
        nmax = int(ni.max()) if S else 0
        if nmax:
            # gather indices < L < 2**24: exact as float32 row entries
            tsn = wts[:, None] + self._pix[None, :nmax]     # [S, nmax]
            frames = ((audio_eff[:, None] - tsn) * sr) // NSC
            idx = np.clip(frames, (reserve + 1)[:, None], total[:, None])
            colmask = (np.arange(nmax)[None, :] < ni[:, None]) \
                & run[:, None]
            np.copyto(self._idx_buf[:, :nmax], idx.astype(np.float32),
                      where=colmask)
        new_wts = np.where(run, wts + ni * self.step_ns, wts0)
        new_total = np.where(run, reserve, total)  # consumed to the reserve
        for i, p in enumerate(self._streams):
            p.waveform_ts = int(new_wts[i])
            p.total = int(new_total[i])

    def tick(self, now_ns: int | None = None) -> torch.Tensor:
        """One batched frame; returns the display [S, D, W] dBFS on the
        engine's device, a tensor of its own (a graph's output buffer is
        rewritten by the next replay).

        With ``microbatch=k`` the engine accumulates k assembled frames
        and runs them as ONE flush every k-th tick (frame-identical
        semantics); between flushes it returns the last flushed frame, up
        to k−1 frames behind (``last_batch_pixels`` holds all k)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        return self._tick(now_ns, None)

    @property
    def display(self) -> torch.Tensor:
        """The live display buffer's display channels [S, D, W] (a view)."""
        return self.buf[:, :self.cfg.display_channels]

    @property
    def last_silent(self) -> np.ndarray:
        return self.latch.to("cpu", copy=True).numpy()

    def render_values(self) -> np.ndarray:
        """Host copy of the display values [S, D, W] dBFS (the engine-
        family read renderers use)."""
        return self.display.to("cpu", copy=True).numpy()

    def resized(self, num_streams: int,
                keep: list[int] | None = None) -> "DeviceWaveformEngine":
        """Live-scene resize: row ``i`` of the new engine carries old row
        ``keep[i]``'s device state (sample ring, scroll buffer, silence
        latch, RMS window) and host sync object; rows beyond ``len(keep)``
        start fresh.  Same contract as ``ServingEngine.resized``; the new
        engine captures its own graphs."""
        if keep is None:
            keep = list(range(min(self.S, num_streams)))
        if len(keep) > num_streams:
            raise ValueError(f"keep ({len(keep)} rows) exceeds "
                             f"num_streams={num_streams}")
        if any(not 0 <= j < self.S for j in keep):
            raise ValueError(f"keep indices out of range for S={self.S}: "
                             f"{keep}")
        eng = DeviceWaveformEngine(self.cfg, num_streams,
                                   hop_budget=self.H,
                                   max_lead_s=self._max_lead_s,
                                   microbatch=(self._mb_req if self._mb_auto
                                               else self._mb),
                                   use_native=self._use_native_req,
                                   device=self.device)
        k = len(keep)
        if not k:
            return eng
        idx = torch.tensor(keep, dtype=torch.int64, device=self.device)
        eng.ring.buf[:k] = self.ring.buf[idx]
        eng.buf[:k] = self.buf[idx]
        eng.latch[:k] = self.latch[idx]
        if self.rms_ring is not None:
            eng.rms_ring.buf[:k] = self.rms_ring.buf[idx]
        eng._last_pixels = eng.display.clone()
        for i, j in enumerate(keep):
            eng._streams[i] = self._streams[j]
        self._migrate_native(eng, keep)
        return eng

    def _migrate_native(self, eng: "DeviceWaveformEngine",
                        keep: list[int]) -> None:
        """Carry native sync timestamps + visibility + waveform scroll
        state so surviving streams stay active (and keep their resample
        cursor) across a live resize; ring backlog stays behind by design
        (sub-hop gap), exactly like ``ServingEngine.resized``."""
        if self._native is None or eng._native is None:
            return
        for i, j in enumerate(keep):
            eng._native.set_sync(i, *self._native.get_sync(j))
            eng._native.set_wf_state(i, *self._native.get_wf_state(j))
