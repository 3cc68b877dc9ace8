"""Multi-config serving: heterogeneous stream groups on one device.

The PyTorch counterpart of ``waveform_tpu/runtime/multi.py``.  In OBS
every waveform source carries its own settings — one scene mixes a
4096-pt gradient curve, a stepped stereo bar graph, and a level meter.
The batched engines take one :class:`ResolvedConfig` per batch, so a
heterogeneous scene groups its streams by config: one engine per distinct
config, all sharing the device.

:class:`MultiEngine` is that grouping: add streams with any config, feed
and tick them through one object.  Spectrum configs ride
:class:`ServingEngine`, meter configs :class:`MeterServingEngine`,
waveform configs :class:`DeviceWaveformEngine` — all device-resident and
packed-upload, so groups whose packed rows share a width form an upload
**cohort**: every member's host assembly writes its segment of one
pinned block, one copy uploads the block, and each member's captured
tick (``serving.PackedTickEngine.bind_cohort``) reads its own segment.
"""

from __future__ import annotations

import time
from itertools import accumulate

import numpy as np
import torch

from ..core.config import ResolvedConfig
from ..core.device import checked_device
from .meter_serving import MeterServingEngine
from .serving import ServingEngine, upload
from .waveform_device import DeviceWaveformEngine


def _place(engs: list, prev: dict | None) -> list[int]:
    """Offsets of the cohort members ``engs`` in their block: a member of
    the previous cohort ``prev`` keeps its offset, every other one takes
    the first gap that holds its ``_stride`` floats (or the end), so a
    scene edit moves no member it does not replace."""
    kept = {}
    if prev is not None:
        kept = {id(e): off for e, off in zip(prev["engines"], prev["offs"])}
    taken = sorted((kept[id(e)], kept[id(e)] + e._stride)
                   for e in engs if id(e) in kept)
    offs = []
    for e in engs:
        if id(e) in kept:
            offs.append(kept[id(e)])
            continue
        pos = 0
        for a, b in taken:
            if a - pos >= e._stride:
                break
            pos = max(pos, b)
        offs.append(pos)
        taken = sorted(taken + [(pos, pos + e._stride)])
    return offs


class MultiEngine:
    """Streams with heterogeneous configs, grouped into batched engines.

    Groups whose packed upload rows share a width (same capture channel
    count and hop budget for spectrum and meter groups, and the same
    display width for waveform groups — the common case: one scene, one
    sample rate) form an upload cohort: their per-tick host inputs
    assemble into one shared pinned block, cross to the device as ONE
    copy, and each group's captured tick reads its own segment of the
    device block.  N heterogeneous looks then cost one upload + N graph
    replays instead of N uploads — the transfer analog of the OBS scene
    compositing all sources in one graphics pass
    (/root/reference/src/source.cpp:87-102, one instance per source).

    A cohort's block keeps room for as much again as its members need:
    a scene edit places the new or resized group in a free gap or at the
    end, every other member keeps its segment and its captured graph, and
    the block is reallocated (every member capturing anew) only when it
    runs out of room."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = checked_device(device, "MultiEngine")
        self._groups: dict[ResolvedConfig, list] = {}   # cfg -> stream ids
        self._engines: dict[ResolvedConfig, object] = {}
        self._streams: dict[int, tuple[ResolvedConfig, int]] = {}
        self._next_id = 0
        self._cohorts: list[dict] = []
        self._solo: list = []    # engines ticking through their own upload
        # stream id -> (engine, row), rebuilt with the cohorts: a feed then
        # looks nothing up by config (hashing a resolved config, a
        # dataclass of some fifty fields, on every feed slowed a large
        # scene's tick measurably, PERF.md)
        self._route: dict[int, tuple] = {}

    def _make_engine(self, cfg: ResolvedConfig, n: int):
        if cfg.spectrum_mode:
            return ServingEngine(cfg, n, device=self.device)
        if cfg.meter_mode:
            return MeterServingEngine(cfg, n, device=self.device)
        return DeviceWaveformEngine(cfg, n, device=self.device)

    def _set_engine(self, cfg: ResolvedConfig, eng) -> None:
        """Put ``eng`` in ``cfg``'s place (None: drop the group); the
        replaced engine's captured graphs go at once, with their memory."""
        old = self._engines.get(cfg)
        if old is not None:
            old._drop_graphs()
        if eng is None:
            del self._engines[cfg]
        else:
            self._engines[cfg] = eng

    def _attach_stream(self, sid: int, cfg: ResolvedConfig) -> None:
        members = self._groups.setdefault(cfg, [])
        self._streams[sid] = (cfg, len(members))
        members.append(sid)
        if self._engines:        # live scene: resize this group's engine
            eng = self._engines.get(cfg)
            self._set_engine(cfg, self._make_engine(cfg, 1) if eng is None
                             else eng.resized(len(members)))

    def _detach_stream(self, stream_id: int) -> None:
        cfg, idx = self._streams.pop(stream_id)
        members = self._groups[cfg]
        members.pop(idx)
        for later in members[idx:]:
            c2, i2 = self._streams[later]
            self._streams[later] = (c2, i2 - 1)
        if not members:
            del self._groups[cfg]
            if cfg in self._engines:
                self._set_engine(cfg, None)
            return
        if self._engines:
            keep = [i for i in range(len(members) + 1) if i != idx]
            self._set_engine(cfg, self._engines[cfg].resized(
                len(members), keep=keep))

    def add_stream(self, cfg: ResolvedConfig) -> int:
        """Register a stream; returns its handle.  Works at any time — on a
        live scene the group's engine resizes (state-migrating rebuild,
        :meth:`ServingEngine.resized`), exactly the operation OBS performs
        when a user drops a new waveform source into a running scene
        (/root/reference/src/source.cpp:87-102, 1077-1322; other sources
        are untouched — here other *groups* keep their state, their
        cohort segment and their captured graphs)."""
        sid = self._next_id
        self._next_id += 1
        self._attach_stream(sid, cfg)
        if self._engines:
            self._rebuild_cohorts()
        return sid

    def update_stream(self, stream_id: int, cfg: ResolvedConfig) -> None:
        """Re-configure one LIVE stream — the OBS ``update()`` analog.

        The reference tears down and rebuilds the source's entire state on
        ANY settings change (free_bufs + re-alloc + recapture,
        /root/reference/src/source.cpp:1077-1322), so moving the stream to
        its new config's group with fresh analysis state is exactly the
        reference's semantics.  The handle stays valid; other streams in
        both the old and new groups carry their state across the resizes
        (queued, unticked audio of the two resized groups does not, as in
        :meth:`ServingEngine.resized`).
        """
        old_cfg, _ = self._streams[stream_id]
        if old_cfg == cfg:
            return
        self._detach_stream(stream_id)
        self._attach_stream(stream_id, cfg)   # same handle, new group
        if self._engines:
            self._rebuild_cohorts()           # ONE rebuild for the edit

    def remove_stream(self, stream_id: int) -> None:
        """Drop a stream from a live scene; its group's engine shrinks with
        every other row's state carried over (the OBS remove-source
        analog: the removed WAVSource is destroyed, the rest never
        notice)."""
        self._detach_stream(stream_id)
        if self._engines:
            self._rebuild_cohorts()

    def _build(self):
        for cfg, members in self._groups.items():
            self._engines[cfg] = self._make_engine(cfg, len(members))
        self._rebuild_cohorts()

    def _rebuild_cohorts(self):
        # upload cohorts: groups sharing a packed row width.  Spectrum and
        # meter rows are (C*H samples, [rms], 3 meta) and waveform rows add
        # the W gather indices + 5 meta, so waveform groups typically
        # cohort with each other while spectrum+meter groups share one
        self._route = {sid: (self._engines[cfg], idx)
                       for sid, (cfg, idx) in self._streams.items()}
        by_width: dict[int, list] = {}
        for eng in self._engines.values():
            by_width.setdefault(eng.packed_width, []).append(eng)
        prev = {c["width"]: c for c in self._cohorts}
        self._solo, self._cohorts = [], []
        for width, engs in sorted(by_width.items()):
            if len(engs) < 2:     # a lone group gains nothing from fusion
                engs[0]._leave_cohort()
                self._solo.extend(engs)
                continue
            c = prev.get(width)
            offs = _place(engs, c)
            need = max(off + e._stride for e, off in zip(engs, offs))
            if c is None or need > c["dev"].numel():
                # a new block (room for as much again): pack the members
                # from 0; every one of them captures anew
                offs = list(accumulate((e._stride for e in engs[:-1]),
                                       initial=0))
                cap = 2 * sum(e._stride for e in engs)
                pinned = self.device.type == "cuda"
                c = {"width": width, "flip": 0, "events": [None, None],
                     "host": [torch.zeros(cap, dtype=torch.float32,
                                          pin_memory=pinned)
                              for _ in range(2)],
                     "dev": torch.empty(cap, dtype=torch.float32,
                                        device=self.device)}
            for e, off in zip(engs, offs):
                # rebind only engines whose placement actually changed: a
                # scene edit must not recapture the untouched groups
                if e._row0 != off or e._cohort_block is not c["dev"]:
                    e.bind_cohort(off, c["dev"])
            self._cohorts.append({
                **c, "engines": engs, "offs": offs,
                "used": max(off + e._stride for e, off in zip(engs, offs))})

    def feed(self, stream_id: int, data, timestamp_ns: int,
             now_ns: int | None = None, muted: bool = False) -> None:
        if not self._engines:
            self._build()
        eng, idx = self._route[stream_id]
        eng.feed(idx, data, timestamp_ns, now_ns=now_ns, muted=muted)

    def tick(self, now_ns: int | None = None) -> None:
        """One video frame.  Each cohort assembles every member's packed
        rows into its host block (double-buffered: a buffer is rewritten
        only after the copy that last read it), uploads the block with one
        copy and replays each member's graph over its segment; the solo
        groups tick through their own uploads."""
        if not self._engines:
            self._build()
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        for c in self._cohorts:
            c["flip"] ^= 1
            flip = c["flip"]
            ev = c["events"][flip]
            if ev is not None:
                ev.synchronize()
                c["events"][flip] = None
            host = c["host"][flip]
            view = host.numpy()
            uniform = []
            for eng, off in zip(c["engines"], c["offs"]):
                eng._bind_external(view[off:off + eng._stride])
                uniform.append(eng._stage(now_ns, 1.0 / eng.cfg.fps))
            used = c["used"]
            upload(host[:used], c["dev"][:used], c["events"], flip)
            for eng, u in zip(c["engines"], uniform):
                eng.tick_from_cohort(u)
        for eng in self._solo:
            eng.tick(now_ns=now_ns)

    def set_show(self, stream_id: int, show: bool) -> None:
        """Show/hide one stream of the scene (the reference's show()/hide()
        source callbacks; hidden graphs decay like a capture timeout)."""
        if not self._engines:
            self._build()
        eng, idx = self._route[stream_id]
        eng.set_show(idx, show)

    def read_decibels(self, stream_id: int) -> np.ndarray:
        if not self._engines:
            self._build()   # read-before-tick: the initial (floor) state
        eng, idx = self._route[stream_id]
        if isinstance(eng, ServingEngine):
            return eng.read_decibels()[idx]
        return eng.render_values()[idx]

    def render_frames(self) -> dict[int, np.ndarray]:
        """RGBA frames for EVERY stream in the scene: one batched render
        per distinct config (frame shapes differ across groups, so the
        result maps stream handle -> [H, W, 4] f32).

        The whole-scene analog of OBS compositing all sources per video
        frame (one render() callback per source,
        /root/reference/src/source.cpp:1346-1358): spectrum and meter
        groups render from device state (``ServingEngine.render_frames``),
        waveform groups from their display buffers; hide_on_silent blanks
        latched streams in both.  Every group's render is enqueued before
        the first is read back.
        """
        if not self._engines:
            self._build()
        from ..render.raster import shared_renderer
        pending = []
        for cfg, eng in self._engines.items():
            if isinstance(eng, ServingEngine):
                imgs = eng.render_frames()
            else:
                imgs = shared_renderer(cfg, batched=True,
                                       device=self.device)(eng.display)
                if cfg.settings.hide_on_silent:
                    imgs = imgs * (~eng.latch).to(imgs.dtype)[
                        :, None, None, None]
            pending.append((self._groups[cfg], imgs))
        out: dict[int, np.ndarray] = {}
        for ids, dimgs in pending:
            imgs = dimgs.cpu().numpy()
            for i, sid in enumerate(ids):
                out[sid] = imgs[i]
        return out

    def config_of(self, stream_id: int) -> ResolvedConfig:
        return self._streams[stream_id][0]

    @property
    def num_groups(self) -> int:
        return len(self._groups)
