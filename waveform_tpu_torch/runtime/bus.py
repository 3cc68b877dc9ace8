"""Output-bus fan-out: one mixed audio stream, many heterogeneous consumers.

The PyTorch counterpart of ``waveform_tpu/runtime/bus.py``.  The
reference's ``output_bus`` capture mode taps OBS's mixed output and feeds
it to every waveform source configured against the bus — *any* source
type: spectrum, level meter, or oscilloscope, each keeping its own ring,
analysis state and smoothing even though they all see identical audio
(/root/reference/src/source.cpp:676-720: one ``audio_output_connect``
callback per source instance).

Consumers of one bus share ONE device ring sized to the largest requested
window, fed by ONE packed upload per tick; each *distinct config* runs one
step that reads its own window off the shared ring's tail, so memory and
host→device traffic are O(max window + #distinct configs), not
O(#consumers).  Subscribing 500 overlays with 12 distinct looks costs 12
analysis states and a single ring.

* **Spectrum** consumers run the full spectrum step + rebin on the ring's
  last N samples.
* **Meter** consumers reduce the ring tail to RMS/peak levels
  (dsp/meter.py); the reference's timeout ring-memset
  (src/source_generic.cpp:184-199) is emulated with a validity mask —
  the shared ring cannot be zeroed for one consumer, so samples that
  predate the last timeout are masked out of that consumer's window.
* **Waveform** consumers keep a device-resident scroll buffer; the host
  computes the per-tick fresh-pixel count and sample back-offsets
  (int64 timestamp math, src/source_generic.cpp:299-333) and the device
  scrolls, gathers, and dB-converts the fresh tail.

Every per-tick host value rides the one upload behind the pushed samples
(the push count, the active flag and the normalization RMS, then each
group's gravity pair of ``dt``, each meter group's valid count, each
waveform group's back-offsets and fresh count), and the device half of a
tick — the ring push and every group's step — reads them there: on a
CUDA device it is one captured graph (``runtime/graphs.py``), captured at
the first tick after the bus's groups or ring change.  Ring, states,
scroll buffers and latches update in place.

Per-consumer state (EMA trails, scroll position, silence latches) stays
private; the ring and the upload do not.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.config import (
    CAPTURE_TIMEOUT_NS,
    DB_MIN,
    MAX_TS_DELTA_NS,
    ResolvedConfig,
)
from ..core.device import checked_device
from ..core.ring import audio_frames_to_ns, ns_to_audio_frames
from ..dsp.devring import DeviceRing, init_ring, push
from ..dsp.meter import init_meter_state, make_meter_step
from ..dsp.spectrum import (
    dbfs,
    display_decibels,
    gravity_pair,
    init_state,
    make_spectrum_step,
)
from ..rebin.apply import make_rebin_fn
from .graphs import GraphTick
from .serving import assign, upload
from .waveform_host import ts_to_frames


class OutputBus:
    """One captured bus fanned out to consumers with heterogeneous configs."""

    def __init__(self, audio, channels: int = 2,
                 hop_budget: int | None = None, fps: float = 60.0,
                 device: torch.device | str = "cuda"):
        self.device = checked_device(device, "OutputBus")
        self.audio = audio
        self.C = channels
        self.fps = fps
        self.H = hop_budget or (2 * int(audio.samples_per_sec / fps) + 16)
        self._groups: dict[ResolvedConfig, dict] = {}
        self._handles: dict[int, ResolvedConfig] = {}
        self._next = 0
        self._built = False
        # shared host sync bookkeeping (the bus has ONE timestamp stream)
        self._chunks: list[np.ndarray] = []
        self._queued = 0
        self.capture_ts = 0
        self.audio_ts = 0
        self.ring = None
        self.L = 0
        self._synced = 0        # samples pushed to the device ring so far
        self._was_active = True
        self._graph = None      # the tick's device half (a GraphTick)

    # -- subscription --------------------------------------------------

    def subscribe(self, cfg: ResolvedConfig) -> int:
        """Register a consumer; returns its handle.  Consumers sharing a
        config share one step and one state (identical input ⇒ identical
        output).  Spectrum, meter and waveform configs all ride the same
        ring (the reference attaches any source type to the bus,
        src/source.cpp:685-704) — and like the reference, a consumer may
        attach to a LIVE bus at any time (:meth:`_attach_group`)."""
        if cfg.capture_channels > self.C:
            raise ValueError("config wants more channels than the bus has")
        h = self._next
        self._next += 1
        self._handles[h] = cfg
        is_new = cfg not in self._groups
        self._groups.setdefault(cfg, {})
        if self._built and is_new:
            self._attach_group(cfg)
        return h

    def unsubscribe(self, handle: int) -> None:
        """Detach a consumer.  The group's step and state drop with its
        last handle (the ring keeps its size — a later larger subscriber
        grows it; the reference likewise leaves the bus connection up
        while any consumer remains, src/source.cpp:676-720)."""
        cfg = self._handles.pop(handle)
        if not any(c == cfg for c in self._handles.values()):
            self._groups.pop(cfg, None)
            if self._built:
                self._layout()

    def _window_need(self, cfg: ResolvedConfig) -> int:
        if cfg.spectrum_mode or cfg.meter_mode:
            return cfg.fft_size        # meter mode repurposes fft_size as
        return cfg.waveform_samples    # the sample window (config.py)

    def _build_group(self, cfg, g):
        if cfg.spectrum_mode:
            self._build_spectrum_group(cfg, g)
        elif cfg.meter_mode:
            self._build_meter_group(cfg, g)
        else:
            self._build_waveform_group(cfg, g)

    def _attach_group(self, cfg) -> None:
        """Attach a new consumer config to a LIVE bus (the reference lets
        any source connect to the output bus at any time,
        src/source.cpp:685-704).  If the new window outgrows the shared
        ring, the ring grows with its history carried into the tail; every
        existing group's analysis state (EMA trails, meter levels, scroll
        buffers, latches) carries across untouched, and the next tick
        captures the bus's graph anew over the new ring and groups."""
        need = self._window_need(cfg) + self.H
        if need > self.L:
            grown = torch.zeros((1, self.C, need), dtype=torch.float32,
                                device=self.device)
            grown[..., need - self.L:] = self.ring.buf
            self.ring = DeviceRing(buf=grown)
            self.L = need
        if cfg.normalize_volume:
            R = cfg.input_rms_size
            if not self._need_rms or R > self._rms_R:
                # enable, or grow-and-rewarm: the reference's update()
                # resets its RMS sync buffer too (src/source.cpp:810-835)
                self._need_rms = True
                self._rms_win = np.zeros(R, np.float32)
                self._rms_pos = 0
                self._rms_sum = 0.0
                self._rms_R = R
        self._build_group(cfg, self._groups[cfg])
        self._layout()

    def _build(self):
        self.L = max(self._window_need(c) for c in self._groups) + self.H
        self.ring = init_ring(1, self.C, self.L, self.device)
        # shared volume-normalization RMS (1 s window of per-timepoint
        # max-channel squares over the synced pushes, src/source.cpp:810-835)
        self._need_rms = any(c.normalize_volume for c in self._groups)
        if self._need_rms:
            R = max(c.input_rms_size for c in self._groups
                    if c.normalize_volume)
            self._rms_win = np.zeros(R, np.float32)
            self._rms_pos = 0
            self._rms_sum = 0.0
            self._rms_R = R
        for cfg, g in self._groups.items():
            self._build_group(cfg, g)
        self._layout()
        self._built = True

    def _layout(self) -> None:
        """Lay out the packed upload for the current groups: H samples per
        channel, (count, active, input_rms), then each group's scalars at
        ``g["at"]``; allocate its double-buffered (pinned, on CUDA) host
        buffers and device buffer, and drop the captured graph (it reads
        the old buffers, ring and groups)."""
        at = self.C * self.H + 3
        for g in self._groups.values():
            g["at"] = at
            at += g["scalars"]
        pinned = self.device.type == "cuda"
        self._host = [torch.zeros(at, dtype=torch.float32, pin_memory=pinned)
                      for _ in range(2)]
        self._events = [None, None]
        self._flip = 0
        self._dev_in = torch.empty(at, dtype=torch.float32,
                                   device=self.device)
        self._graph = None

    def _device_tick(self) -> list:
        """The device half of a tick, on the uploaded ``_dev_in``: the
        packed push (the bus's one count shifts the whole ring), then
        every group's step off the ring's tail.  Returns each group's
        pixels, in group order."""
        flat, C, H = self._dev_in, self.C, self.H
        push(self.ring, flat[:C * H].view(1, C, H),
             flat[C * H].to(torch.int64))
        active = flat[C * H + 1:C * H + 2] > 0.5
        rms = flat[C * H + 2:C * H + 3]
        return [g["step"](self.ring.buf, flat[g["at"]:g["at"] + g["scalars"]],
                          active, rms) for g in self._groups.values()]

    def _build_spectrum_group(self, cfg, g):
        step = make_spectrum_step(cfg, device=self.device)
        rebin = make_rebin_fn(cfg, apply_pixel_map=False, device=self.device)
        n = cfg.fft_size
        cb = cfg.channel_base
        cc = max(cfg.capture_channels, 1)

        def group_step(buf, scalars, active, rms):
            # the ring's last n samples are a strided view of the longer
            # ring: the exact kernels read a contiguous [S, C, n] window
            window = buf[:, cb:cb + cc, -n:].contiguous()
            assign(g["state"], step(window, g["state"], scalars, active, rms))
            return rebin(display_decibels(cfg, g["state"]))

        g["mode"] = "spectrum"
        g["step"] = group_step
        g["scalars"] = 2            # the gravity pair of dt
        if "state" not in g:
            g["state"] = init_state(cfg, 1, self.device)
            g["pixels"] = None

    def _build_meter_group(self, cfg, g):
        mstep = make_meter_step(cfg)
        M = cfg.fft_size    # sample window (sr·meter_ms/1000, config.py)
        cb = cfg.channel_base
        cc = max(cfg.capture_channels, 1)
        pos = torch.arange(M, device=self.device)

        def group_step(buf, scalars, active, rms):
            # timeout-memset emulation (src/source_generic.cpp:184-199):
            # the shared ring can't be zeroed for one consumer, so samples
            # older than the consumer's last timeout mask to silence
            valid = scalars[2].to(torch.int64)
            window = buf[:, cb:cb + cc, -M:] * (pos >= M - valid)
            assign(g["state"], mstep(window, g["state"], scalars[:2], active,
                                     torch.ones_like(active)))
            return g["state"].meter_val

        g["mode"] = "meter"
        g["step"] = group_step
        g["scalars"] = 3            # the gravity pair, the valid count
        if "state" not in g:
            g["state"] = init_meter_state(cfg, 1, self.device)
            g["invalid_before"] = None   # synced count at last timeout edge
            g["pixels"] = None

    def _build_waveform_group(self, cfg, g):
        W = cfg.fft_size    # display width in pixels (src/source.cpp:1140)
        cb = cfg.channel_base
        C = max(cfg.capture_channels, 1)
        O = max(cfg.output_channels, C)
        D = 2 if cfg.stereo else 1
        normalize = cfg.normalize_volume
        vt, mg = cfg.volume_target, cfg.max_gain
        px = torch.arange(W, device=self.device)

        def group_step(buf, scalars, active, rms):
            """Scroll + gather + fresh-tail dB conversion, all on the device
            (src/source_generic.cpp:299-390; the host supplies ``back`` [W]
            sample back-offsets and ``n`` fresh pixels from its int64
            timestamp math).  The JAX step's rolls by ``n`` are gathers at
            (j + n) mod W, so nothing is read back to the host."""
            back = scalars[:W].to(torch.int64)
            n = scalars[W].to(torch.int64)
            active = active[0]
            latch = g["latch"]
            src = buf[0, cb:cb + C]                            # [C, L]
            gathered = src[:, buf.shape[-1] - 1 - back]        # [C, W]
            fresh = px >= W - n
            # align gathered col j -> pixel W-n+j (wrap lands in ~fresh),
            # and scroll the old display n pixels left: both roll j+n
            rot = (px + n) % W
            old = g["buf"][0]                                  # [O, W]
            work = torch.where(fresh, gathered[:, rot], old[:C][:, rot])
            # silence scan over the scrolled buffer — mixed-domain exactly
            # like the reference (old entries are dB values, fresh entries
            # raw samples; src/source_generic.cpp:336-344)
            silent = ~torch.any(work != 0.0)

            out = old.clone()
            out[:C] = work
            if O > C:   # duplicate mono capture before conversion
                out[1] = work[0]
            # fresh-tail dBFS (+ normalization gain) on display channels
            a = work.abs()
            live = out.clone()
            if cfg.stereo:
                # only real capture channels convert (the reference's
                # counts[ch] == 0 for ch >= C leaves a mono-capture stereo
                # display's channel 1 tail RAW, source_generic.cpp:363-371)
                DC = min(2, C)
                conv = dbfs(a[:DC])
            else:
                DC = 1
                conv = dbfs((a[0] + a[1]) * 0.5 if C > 1 else a[0])
            if normalize:
                conv = conv + torch.clamp_max(vt - dbfs(rms[0]), mg)
            live[:DC] = torch.where(fresh, conv, out[:DC])
            # silent ticks blank the display channels every tick
            # (src/source_generic.cpp:345-349 via last_silent)
            silent_out = out.clone()
            silent_out[:D] = DB_MIN
            live_out = torch.where(silent, silent_out, live)
            # capture timeout: blank once on the edge, then freeze
            blanked = old.clone()
            blanked[:D] = DB_MIN
            timeout_out = torch.where(latch, old, blanked)
            g["buf"][0] = torch.where(active, live_out, timeout_out)
            latch.copy_(silent | ~active)
            return g["buf"][:, :D]

        g["mode"] = "waveform"
        g["step"] = group_step
        g["scalars"] = W + 1        # back-offsets, the fresh count
        g["D"] = D
        if "buf" not in g:
            g["buf"] = torch.full((1, O, W), DB_MIN, dtype=torch.float32,
                                  device=self.device)
            g["latch"] = torch.zeros((), dtype=torch.bool,
                                     device=self.device)
            g["waveform_ts"] = 0
            g["pixels"] = None

    # -- feeding (one mixed stream) -------------------------------------

    def feed(self, data: np.ndarray, timestamp_ns: int,
             now_ns: int | None = None) -> None:
        """Queue one bus packet ([channels, frames] float32 planar)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        frames = 0 if data is None else data.shape[-1]
        if frames == 0:
            return
        self.capture_ts = now_ns
        audio_len = audio_frames_to_ns(self.audio.samples_per_sec, frames)
        self.audio_ts = (now_ns
                         if abs(timestamp_ns - now_ns) > MAX_TS_DELTA_NS
                         else timestamp_ns + audio_len)
        chunk = np.asarray(data[:self.C], np.float32)
        if chunk.shape[0] < self.C:
            chunk = np.vstack([chunk, np.zeros(
                (self.C - chunk.shape[0], frames), np.float32)])
        self._chunks.append(chunk)
        self._queued += frames
        max_q = (self.L or 65536) + self.H
        while self._queued > max_q and self._chunks:
            drop = self._queued - max_q
            head = self._chunks[0]
            if head.shape[-1] <= drop:
                self._queued -= head.shape[-1]
                self._chunks.pop(0)
            else:
                self._chunks[0] = head[:, drop:]
                self._queued -= drop
                break

    def _sync(self, ts: int) -> int:
        delta = min(abs(self.audio_ts - ts), MAX_TS_DELTA_NS)
        return -delta if self.audio_ts < ts else delta

    def _update_rms(self, pushed: np.ndarray) -> float:
        """Advance the shared 1 s RMS window with this tick's pushed
        samples ``pushed`` [C, take] (per-timepoint max-channel
        squares)."""
        take = pushed.shape[-1]
        if take > 0:
            sq = np.max(np.abs(pushed), axis=0).astype(np.float32) ** 2
            R = self._rms_R
            if take >= R:
                # a single push covering the whole window (hop_budget
                # longer than the RMS window, e.g. low fps): the window
                # IS the last R samples — positional updates would hit
                # duplicate slots and desync the running sum
                tail = sq[take - R:]
                self._rms_win[:] = tail
                self._rms_sum = float(tail.sum(dtype=np.float64))
                self._rms_pos = 0
            else:
                pos = (self._rms_pos + np.arange(take)) % R
                self._rms_sum += (float(sq.sum(dtype=np.float64))
                                  - float(self._rms_win[pos]
                                          .sum(dtype=np.float64)))
                self._rms_win[pos] = sq
                self._rms_pos = (self._rms_pos + take) % R
        return float(np.sqrt(max(self._rms_sum, 0.0) / self._rms_R))

    # -- ticking ---------------------------------------------------------

    def tick(self, now_ns: int | None = None, dt: float | None = None):
        """One video frame: push new bus samples once, run every distinct
        config's step off the shared ring — one upload and, on a CUDA
        device, one graph replay."""
        if not self._groups:
            return          # every consumer unsubscribed: nothing to run
        if not self._built:
            self._build()
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        dt = (1.0 / self.fps) if dt is None else dt
        sr = self.audio.samples_per_sec
        C, H = self.C, self.H

        # the host buffer the upload two ticks ago read: wait for it
        self._flip ^= 1
        ev = self._events[self._flip]
        if ev is not None:
            ev.synchronize()
            self._events[self._flip] = None
        host = self._host[self._flip]
        flat = host.numpy()
        push_buf = flat[:C * H].reshape(C, H)

        dtaudio = self._sync(now_ns)
        reserve = ns_to_audio_frames(sr, dtaudio) if dtaudio > 0 else 0
        take = min(max(self._queued - reserve, 0), H)
        push_buf[:] = 0.0
        got = 0
        while got < take and self._chunks:
            head = self._chunks[0]
            m = head.shape[-1]
            use = min(m, take - got)
            push_buf[:, got:got + use] = head[:, :use]
            if use == m:
                self._chunks.pop(0)
            else:
                self._chunks[0] = head[:, use:]
            self._queued -= use
            got += use
        active = (now_ns - self.capture_ts) <= CAPTURE_TIMEOUT_NS
        flat[C * H] = take
        flat[C * H + 1] = active
        flat[C * H + 2] = (self._update_rms(push_buf[:, :take])
                           if self._need_rms else 0.0)
        self._synced += take

        # per-consumer timeout bookkeeping (the fresh→timeout edge)
        if self._was_active and not active:
            for g in self._groups.values():
                if g["mode"] == "meter":
                    g["invalid_before"] = self._synced
        self._was_active = active

        for cfg, g in self._groups.items():
            at = g["at"]
            if g["mode"] != "waveform":
                flat[at:at + 2] = gravity_pair(cfg, dt)
            if g["mode"] == "meter":
                M = cfg.fft_size
                inv = g["invalid_before"]
                flat[at + 2] = M if inv is None else min(self._synced - inv,
                                                         M)
            elif g["mode"] == "waveform":
                W = cfg.fft_size
                flat[at:at + W], flat[at + W] = self._waveform_host(
                    cfg, g, reserve)

        upload(host, self._dev_in, self._events, self._flip)
        if self._graph is None:
            self._graph = GraphTick(self._device_tick, self.device)
        for g, px in zip(self._groups.values(), self._graph()):
            g["pixels"] = px

    def _waveform_host(self, cfg, g, reserve: int):
        """Host half of a waveform tick: fresh pixel count + per-pixel
        sample back-offsets (int64 ns math, src/source_generic.cpp:299-333;
        the device step takes them as float32, exact below 2**24)."""
        sr = self.audio.samples_per_sec
        W = cfg.fft_size
        step_ns = (cfg.meter_ms * 1_000_000) // W
        hist = min(self.L, self._synced)
        back = np.zeros(W, np.int32)
        stop_ts = self.audio_ts - audio_frames_to_ns(sr, reserve)
        start_ts = self.audio_ts - audio_frames_to_ns(sr, reserve + hist)
        if start_ts >= self.audio_ts or stop_ts > self.audio_ts:
            return back, 0     # timestamp rollover, give up (ref :311-313)
        wts = g["waveform_ts"]
        if wts < start_ts:
            wts = start_ts     # catch up if falling behind
        if wts > stop_ts and (wts - stop_ts) > step_ns:
            wts = start_ts     # fix desync (ref :314-321)
        ts = wts + np.arange(W, dtype=np.int64) * step_ns
        ok = (ts < stop_ts) & (ts >= wts)
        n = int(np.argmin(ok)) if not ok.all() else W
        if n > 0 and hist > 0:
            idx = (ts_to_frames(sr, self.audio_ts - ts[:n])
                   .clip(reserve + 1, reserve + hist))
            back[:n] = (idx - reserve - 1).astype(np.int32)
        else:
            n = 0
        g["waveform_ts"] = wts + n * step_ns
        return back, n

    # -- reads -----------------------------------------------------------

    def _group(self, handle: int) -> dict:
        g = self._groups[self._handles[handle]]
        if not self._built or g.get("pixels") is None:
            raise RuntimeError("tick() the bus before reading a consumer "
                               "(no frame has been produced yet)")
        return g

    def read_pixels(self, handle: int) -> np.ndarray:
        """Display output for any consumer mode: rebinned dB pixels
        [D, P] (spectrum), levels [C] (meter), or the scroll buffer
        [D, W] (waveform); a host copy."""
        return self._group(handle)["pixels"][0].to("cpu", copy=True).numpy()

    def read_decibels(self, handle: int) -> np.ndarray:
        cfg = self._handles[handle]
        g = self._group(handle)
        vals = (display_decibels(cfg, g["state"]) if g["mode"] == "spectrum"
                else g["pixels"])
        return vals[0].to("cpu", copy=True).numpy()

    def render_frame(self, handle: int) -> np.ndarray:
        """RGBA frame [H, W, 4] for one consumer's current tick.

        The renderer is built once per distinct config and shared by every
        consumer subscribed with that config (``render.raster.
        shared_renderer``) — like the bus analysis groups themselves.  All
        three consumer modes render: spectrum from device dB state, meters
        from their level values, waveforms from the device scroll buffer
        (the reference's render() per source, src/source.cpp:1346-1358).
        """
        cfg = self._handles[handle]
        g = self._group(handle)
        from ..render.raster import shared_renderer
        rend = shared_renderer(cfg, device=self.device)
        hidden = None
        if g["mode"] == "spectrum":
            vals = display_decibels(cfg, g["state"])[0]
            if cfg.settings.hide_on_silent:
                hidden = g["state"].last_silent[0]
        elif g["mode"] == "meter":
            vals = g["pixels"][0][None, :]
            if cfg.settings.hide_on_silent:
                # the reference latches meter silence when every channel
                # sits under floor−10 dB (source_generic.cpp:263-268)
                hidden = torch.all(vals < np.float32(cfg.floor - 10))
        else:
            # reference parity: tick_waveform never updates m_last_silent
            # (source_generic.cpp:271-390), so hide_on_silent cannot
            # blank a waveform consumer
            vals = g["pixels"][0]
        img = rend(vals)
        if hidden is not None:
            # hide_on_silent: the reference's render() early return
            # (src/source.cpp:1349-1350) — blank to transparent on device,
            # matching ServingEngine.render_frames
            img = img * (~hidden).to(img.dtype)
        return img.cpu().numpy()

    @property
    def num_groups(self) -> int:
        return len(self._groups)
