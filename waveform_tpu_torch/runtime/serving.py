"""Serving engine: device-resident windows, one packed upload per tick.

The PyTorch counterpart of ``waveform_tpu/runtime/serving.py``.  Audio
packets queue on the host (the C++ assembler in ``native/``, or the
pure-Python assembly when no compiler is available); each tick assembles
ONE packed row per stream — the newly synced samples, the raw RMS squares
under volume normalization, then (count, active, rms) — followed by the
tick's scalars, uploads it, and runs ring push -> exact |rFFT| -> spectrum
step -> rebin on the engine's device.  Pixels stay on the device; callers
read them back on their own cadence.

On a CUDA device the device half of a tick is one captured CUDA graph
(``runtime/graphs.py``), the counterpart of the JAX engine's jitted tick:
one graph for each count form (every stream advancing alike, or a count
per stream), one for each microbatch (k, form) flush, one for each
``tick_many`` hop and form.  The ring, the state and the RMS ring are
updated in place (JAX's arrays are immutable and its programs donate
them; the port's tensors keep their addresses, which the graphs read).
Everything a graph reads that changes from tick to tick is device data
written before the replay: the packed rows and the scalars behind them,
(g, 1 − g) of the tick's ``dt`` and the uniform count.  The exact-FFT
routing variables are read when a graph is captured, at the first tick
of its form: changing them later needs a new engine.

Host-side A/V sync follows the reference exactly: the window ends
``dtsamples`` behind the freshest audio when timestamps run ahead of the
clock (src/source.hpp:279-285), mute zero-fills (src/source.cpp:1878-1879),
bogus timestamps clamp to the wall clock at 16 s (src/source.cpp:1833-1837).
"""

from __future__ import annotations

import dataclasses
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
from ..dsp.spectrum import (
    display_decibels,
    gravity_pair,
    init_state,
    make_spectrum_step,
)
from ..rebin.apply import make_rebin_fn
from .graphs import GraphTick


def link_rtt(device: torch.device | str = "cuda") -> float:
    """Median round trip of a minimal dispatch on ``device`` — the
    per-dispatch overhead microbatching amortizes.  On a CUDA device: the
    replay of a captured one-op graph plus ``synchronize``; on the CPU,
    the op itself."""
    dev = torch.device(device)
    x = torch.zeros((), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        tick = GraphTick(lambda: x + 1.0, dev)
        tick()                              # warm-up and capture

        def run():
            tick()
            torch.cuda.synchronize(dev)
    else:
        def run():
            return x + 1.0
    run()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def choose_microbatch(budget: float, rtt: float, tick: float,
                      mb_max: int = 8,
                      completion_factor: float = 3.0) -> int:
    """The auto-microbatch latency policy (the JAX package's, as it is):

    * one tick already meets the budget -> k=1 (lowest completion
      latency; nothing to amortize)
    * the non-RTT share fits the budget -> the smallest k whose
      amortized cost RTT/k + (tick−RTT) meets it
    * budget unreachable (transfer/compute alone exceed it) -> the
      smallest k whose next doubling would shave less than 10% of
      the non-RTT cost

    Either way a COMPLETION guard bounds k: a flush's first frame
    completes after ~k·(tick−rtt) + rtt, and k stops doubling once the
    next doubling would push that past ``completion_factor × tick``
    (the reference's analog is its hard real-time frame budget,
    reference src/source.cpp:1156-1167).  The engines ALSO validate the
    chosen k against measured flushes (:func:`validate_flush`).
    """
    rest = max(tick - rtt, 1e-6)
    if tick <= budget:
        return 1
    if rest < budget:
        need = rtt / (budget - rest)
    else:
        need = rtt / (0.2 * rest)   # RTT/(2k) <= 0.1*rest
    cap = max(completion_factor * tick, 2.0 * budget)
    k = 1
    while k < mb_max and k < need and 2 * k * rest + rtt <= cap:
        k *= 2
    return k


def validate_flush(flushes: list, k: int, probe_tick: float, budget: float,
                   completion_factor: float = 3.0) -> tuple[bool, int]:
    """Closed-loop check of a candidate microbatch k against MEASURED
    flush completions (batch-start -> flush-ready; ``flushes[0]`` carries
    the flush's capture and is dropped): accept only if the measured
    completion stays under the cap AND the amortized cost (flush/k)
    beats the measured k=1 tick.  Returns (accept, next_k): on reject,
    retry at k//2 (k=1 always accepts by construction)."""
    flush = float(np.median(flushes[1:]))
    cap = max(completion_factor * probe_tick, 2.0 * budget)
    if flush <= cap and flush / k < probe_tick:
        return True, k
    return False, k // 2


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


def assign(dst, src) -> None:
    """Copy every tensor of the state dataclass (or ring) ``src`` into the
    same field of ``dst``, in place."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class AutoMicrobatchMixin:
    """The closed-loop microbatch="auto" state machine (the JAX package's,
    as it is): probe k=1 ticks, pick a completion-capped candidate via
    :func:`choose_microbatch`, then VALIDATE it against measured flushes
    (:func:`validate_flush`) before locking — reject -> halve ->
    re-validate.  Engines supply two hooks (their plain tick and their
    microbatch flush tick) plus an optional extra-state reset."""

    _PROBE_TICKS = 4        # k=1 ticks timed before deciding (the first
                            # tick carries the capture and is discarded)
    _MB_MAX = 8             # worst-case completion grows one frame per k
    _VALIDATE_FLUSHES = 2   # measured flushes per candidate k (plus one
                            # dropped for the flush's capture)
    _COMPLETION_FACTOR = 3.0  # flush completion cap, x the k=1 tick

    # -- engine hooks ------------------------------------------------------

    def _mb_plain_tick(self, now_ns: int, dt_f):
        """One normal k=1 tick (self.tick with _mb_auto masked off)."""
        raise NotImplementedError

    def _mb_flush_tick(self, now_ns: int, dt_f):
        """One microbatch-accumulating tick (self._tick_microbatch)."""
        raise NotImplementedError

    def _reset_mb_extra(self) -> None:
        """Engine-specific k-shaped state beyond the shared fields."""

    def _block(self, out) -> None:
        """Wait until the device has computed ``out``."""
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)

    # ----------------------------------------------------------------------

    def _link_rtt(self) -> float:
        return link_rtt(self.device)

    def _choose_microbatch(self, budget: float, rtt: float,
                           tick: float) -> int:
        return choose_microbatch(budget, rtt, tick, self._MB_MAX)

    def _tick_probe(self, now_ns: int, dt_f=None):
        """Auto-mode startup: run normal k=1 ticks, timing completion;
        after _PROBE_TICKS pick a candidate k, then VALIDATE it against
        measured flushes before locking.  Frame semantics are identical to
        the chosen mode throughout."""
        if self._mb > 1:               # validation phase
            return self._tick_validate(now_ns, dt_f)
        t0 = time.perf_counter()
        self._mb_auto = False          # plain tick below
        try:
            out = self._mb_plain_tick(now_ns, dt_f)
        finally:
            self._mb_auto = True
        self._block(out)
        self._probe_ticks.append(time.perf_counter() - t0)
        if len(self._probe_ticks) > self._PROBE_TICKS:
            self._probe_tick = float(
                np.median(self._probe_ticks[1:]))            # drop capture
            k = self._choose_microbatch(1.0 / self.cfg.fps,
                                        self._link_rtt(), self._probe_tick)
            if k <= 1:
                self._mb_auto = False
                self._mb = 1
            else:
                self._mb = k           # candidate: validate before locking
                self._val_flushes: list[float] = []
        return out

    def _tick_validate(self, now_ns: int, dt_f=None):
        """Run the candidate k as real microbatch ticks, timing each
        batch-start -> flush-ready completion; after _VALIDATE_FLUSHES
        measured flushes (plus one dropped for the capture), accept or
        halve (:func:`validate_flush`)."""
        if self._mb_fill == 0:
            self._val_t0 = time.perf_counter()
        self._mb_auto = False
        try:
            out = self._mb_flush_tick(now_ns, dt_f)
        finally:
            self._mb_auto = True
        if self._mb_fill == 0:         # a flush just completed
            self._block(out)
            self._val_flushes.append(time.perf_counter() - self._val_t0)
            if len(self._val_flushes) > self._VALIDATE_FLUSHES:
                ok, nk = validate_flush(
                    self._val_flushes, self._mb, self._probe_tick,
                    1.0 / self.cfg.fps, self._COMPLETION_FACTOR)
                if ok:
                    self._mb_auto = False
                    self._mb_completion = float(
                        np.median(self._val_flushes[1:]))
                elif nk <= 1:
                    self._mb_auto = False
                    self._mb = 1
                    self._reset_mb_state()
                else:
                    self._mb = nk      # re-validate the halved candidate
                    self._val_flushes = []
                    self._reset_mb_state()
        return out

    def _reset_mb_state(self) -> None:
        """Drop k-shaped microbatch machinery so the next tick rebuilds
        it at the current ``self._mb`` (validation stepping k down)."""
        self._mb_bufs = None
        self._mb_events = [None, None]
        self._mb_fill = 0
        self._reset_mb_extra()

    @property
    def microbatch(self) -> int:
        """The active microbatch k (after "auto" resolves its probe)."""
        return self._mb

    @property
    def microbatch_completion(self) -> float | None:
        """Measured median batch-start->flush-ready completion (s) of the
        validated k, when "auto" resolved through validation."""
        return getattr(self, "_mb_completion", None)


class PackedTickEngine(AutoMicrobatchMixin):
    """The device-side plumbing of the packed-row engines
    (:class:`ServingEngine` and its meter subclass,
    ``runtime/waveform_device.DeviceWaveformEngine``): one packed upload a
    tick, double-buffered in (pinned, on CUDA) host memory and fenced by
    CUDA events; the device half of each tick kind a
    :class:`~.graphs.GraphTick`; the microbatch flush, k packed ticks in
    one graph.

    A subclass sets ``cfg``, ``S`` and ``device`` and provides
    ``packed_width``, ``_TAIL`` (floats of scalars behind the rows),
    ``_bind_external(view)`` (point its assembly views at one tick's
    upload), ``_stage(now_ns, dt_f)`` (assemble the bound upload; returns
    whether every stream advances alike) and ``_packed(flat, uniform)``
    (the device tick on one uploaded ``flat``; returns its output)."""

    _TAIL = 0

    def _init_microbatch(self, microbatch: int | str) -> None:
        """microbatch > 1: ticks accumulate k assembled frames and run them
        as ONE captured flush every k-th tick (see :meth:`_tick`); "auto"
        probes the device and chooses k (AutoMicrobatchMixin)."""
        self._mb_auto = microbatch == "auto"
        self._mb_req = microbatch
        self._probe_ticks: list[float] = []
        self._mb = 1 if self._mb_auto else max(int(microbatch), 1)
        self._mb_fill = 0
        self._mb_uniform: list[bool] = []
        self._mb_bufs = None
        self._mb_dev = None
        self._mb_events: list = [None, None]
        self._mb_flip = 0
        self._last_batch = None

    def _init_uploads(self) -> None:
        """One packed upload per tick, double-buffered in (pinned, on CUDA)
        host memory: the upload is asynchronous, so it reads the host
        buffer after tick() returns; a tick rewrites a buffer only after
        the event recorded behind its last upload has completed."""
        self._ticks: dict = {}       # (kind, ...) -> GraphTick
        self._host = [self._host_buffer(1) for _ in range(2)]
        self._events: list = [None, None]
        self._flip = 0
        self._dev_in = torch.empty(self._stride, dtype=torch.float32,
                                   device=self.device)
        self._bind_buf(0)
        self._last_pixels = None

    @property
    def _stride(self) -> int:
        """Floats of one tick's upload: the packed rows, then _TAIL."""
        return self.S * self.packed_width + self._TAIL

    def _host_buffer(self, k: int) -> torch.Tensor:
        """A zeroed host buffer for ``k`` ticks' uploads (pinned on CUDA,
        so the copy is asynchronous)."""
        return torch.zeros(k * self._stride, dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _bind_buf(self, i: int) -> None:
        """Point the assembly views at host buffer ``i``, first waiting for
        the upload that last read it."""
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
            self._events[i] = None
        self._bind_external(self._host[i].numpy())

    def _upload(self, host: torch.Tensor, dev: torch.Tensor,
                events: list, i: int) -> None:
        """Copy ``host`` into ``dev`` on the current stream; on CUDA record
        the event that frees ``host`` for reuse in ``events[i]``."""
        dev.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            events[i] = ev

    def _graph_fn(self, key):
        """The device function of one tick kind, over fixed tensors: a
        single tick ("tick", uniform) or a microbatch flush ("mb", k,
        uniform)."""
        kind, *rest = key
        if kind == "tick":
            (uniform,) = rest
            dev_in = self._dev_in
            return lambda: self._packed(dev_in, uniform)
        k, uniform = rest
        dev_in, R = self._mb_dev, self._stride
        return lambda: torch.stack([
            self._packed(dev_in[i * R:(i + 1) * R], uniform)
            for i in range(k)])

    def _call(self, key):
        """Run tick kind ``key``: replay its graph (capturing it at its
        first call, after an eager warm-up), or on the CPU run it eagerly.
        Returns the raw output (on CUDA the graph's own buffer)."""
        t = self._ticks.get(key)
        if t is None:
            t = self._ticks[key] = GraphTick(self._graph_fn(key), self.device)
        return t()

    def _fresh(self, out: torch.Tensor) -> torch.Tensor:
        """A tick's output as its own tensor: a graph's output buffer is
        rewritten by the next replay, the pixels handed out are not."""
        return out.clone() if self.device.type == "cuda" else out

    @property
    def kernels_per_replay(self) -> dict:
        """{tick kind: {exact_cuda counter: kernels one replay launches}}
        of every graph captured so far (empty on the CPU)."""
        return {key: dict(t.launches) for key, t in self._ticks.items()
                if t.graph is not None}

    # ------------------------------------------------------------------

    def _tick(self, now_ns: int, dt_f):
        """One frame: a probe or validation tick while "auto" decides, an
        accumulating tick under microbatch k > 1, else a single tick."""
        if self._mb_auto:   # probe (k=1) or validation (candidate k) phase
            return self._tick_probe(now_ns, dt_f)
        if self._mb > 1:
            return self._tick_microbatch(now_ns, dt_f)
        return self._tick_one(now_ns, dt_f)

    def _tick_one(self, now_ns: int, dt_f):
        """Assemble, upload and run one tick; returns its output, a tensor
        of its own."""
        self._flip ^= 1
        self._bind_buf(self._flip)
        uniform = self._stage(now_ns, dt_f)
        self._upload(self._host[self._flip], self._dev_in, self._events,
                     self._flip)
        pixels = self._fresh(self._call(("tick", uniform)))
        self._last_pixels = pixels
        return pixels

    def _tick_microbatch(self, now_ns: int, dt_f):
        """Accumulate one assembled frame; flush k frames as one graph.
        Each accumulated tick keeps its own slot (its rows and scalars),
        so the flush gives k single ticks' outputs exactly."""
        k = self._mb
        if self._mb_bufs is None:
            self._mb_bufs = [self._host_buffer(k) for _ in range(2)]
            self._mb_dev = torch.empty(k * self._stride, dtype=torch.float32,
                                       device=self.device)
        if self._mb_fill == 0:
            self._mb_flip ^= 1
            ev = self._mb_events[self._mb_flip]
            if ev is not None:
                ev.synchronize()
                self._mb_events[self._mb_flip] = None
            self._mb_uniform = []
        R = self._stride
        host = self._mb_bufs[self._mb_flip]
        self._bind_external(host.numpy()[self._mb_fill * R:
                                         (self._mb_fill + 1) * R])
        self._mb_uniform.append(self._stage(now_ns, dt_f))
        self._mb_fill += 1
        if self._mb_fill < k:
            return self._last_pixels
        self._mb_fill = 0
        self._upload(host, self._mb_dev, self._mb_events, self._mb_flip)
        pxs = self._fresh(self._call(("mb", k, all(self._mb_uniform))))
        self._last_batch = pxs
        self._last_pixels = pxs[-1]
        return self._last_pixels

    @property
    def last_batch_pixels(self):
        """Device outputs of the last microbatch flush: [k, ...]."""
        return self._last_batch

    # -- auto microbatch policy: shared machinery (AutoMicrobatchMixin) --

    def _mb_plain_tick(self, now_ns: int, dt_f):
        return self._tick_one(now_ns, dt_f)

    def _mb_flush_tick(self, now_ns: int, dt_f):
        return self._tick_microbatch(now_ns, dt_f)

    def _reset_mb_extra(self) -> None:
        self._mb_uniform = []
        self._mb_dev = None
        # the flush graphs read the dropped device buffer
        self._ticks = {key: t for key, t in self._ticks.items()
                       if key[0] != "mb"}


class ServingEngine(PackedTickEngine):
    """Batched device-resident spectrum serving for S streams."""

    # the scalars behind the packed rows of an upload: (g, 1 - g) of the
    # tick's dt (dsp/spectrum.gravity_pair), then the uniform count
    _TAIL = 3
    # the meter subclass (runtime/meter_serving.py) packs (counts, fresh,
    # show) meta columns instead of (counts, show&&fresh, rms)
    _split_meta = False
    # checkpoints store the sample ring flat [S*C, L], as the JAX spectrum
    # engine does (the JAX meter engine stores [S, C, L])
    _flat_ring_checkpoint = True

    def _check_mode(self, cfg: ResolvedConfig) -> None:
        if not cfg.spectrum_mode:
            raise ValueError("ServingEngine handles spectrum mode; use "
                             "MeterServingEngine for meter mode")

    def _wants_rms(self, cfg: ResolvedConfig) -> bool:
        """Whether the packed rows carry the raw RMS-squares block (volume
        normalization applies to spectrum output only, the reference's
        tick_spectrum gain add, src/source_generic.cpp:161-167)."""
        return cfg.normalize_volume

    def __init__(self, cfg: ResolvedConfig, num_streams: int,
                 hop_budget: int | None = None,
                 use_native: bool | None = None,
                 microbatch: int | str = 1,
                 device: torch.device | str = "cuda"):
        check_config(cfg)
        self._check_mode(cfg)
        self.device = checked_device(device, type(self).__name__)
        self.cfg = cfg
        self.S = num_streams
        self.C = max(cfg.capture_channels, 1)
        # kept for resized(): rebuild with identical construction choices
        self._use_native_req = use_native
        self._init_microbatch(microbatch)
        # hop budget: max new samples consumed per stream per tick; default
        # 2 video frames of audio so jitter doesn't stall the window
        self.H = hop_budget or (2 * int(cfg.audio.samples_per_sec / cfg.fps)
                                + 16)
        self._pending = [_PendingStream() for _ in range(num_streams)]
        self._normalize = self._wants_rms(cfg)
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

        self._init_device_state()
        self._build_device_programs()
        self._bulk: dict = {}        # tick_many hop -> its input buffers
        self._init_uploads()
        assert np.shares_memory(self._push_buf, self._in_buf)

    # -- mode hooks (runtime/meter_serving.py overrides them) --------------

    def _init_device_state(self) -> None:
        """Allocate the device-resident per-stream state: the sample ring
        [S, C, L], the spectrum state and, under volume normalization, the
        ring of raw RMS squares [S, 1, input_rms_size] (the reference's 1 s
        host ring of per-timepoint max-channel squares, src/source.cpp:
        1843-1871, 810-835, riding the device-ring mechanism)."""
        cfg, dev = self.cfg, self.device
        self.ring = init_ring(self.S, self.C, cfg.fft_size, dev)
        self.state = init_state(cfg, self.S, dev)
        self.rms_ring = (init_ring(self.S, 1, cfg.input_rms_size, dev)
                         if self._normalize else None)

    def _display_values(self, state):
        """State -> display output for one tick: the display dB channels
        here; meter levels in MeterServingEngine."""
        return display_decibels(self.cfg, state)

    def _build_device_programs(self) -> None:
        """Build the mode's packed tick and bulk tick (the functions the
        graphs capture).  MeterServingEngine swaps the spectrum step for
        the meter reduction, keeping every host-side path identical."""
        cfg, dev = self.cfg, self.device
        step = make_spectrum_step(cfg, dev)
        rebin = make_rebin_fn(cfg, apply_pixel_map=False, device=dev)
        normalize = self._normalize
        rms_size = cfg.input_rms_size
        C, H = self.C, self.H

        def fused_tick(new, counts, ring, state, scalars, active, rms,
                       rms_ring, rms_sq):
            push(ring, new, counts)
            if normalize and rms_ring is not None:
                # rms_sq holds raw (pre-mute) per-timepoint max-channel
                # squares: the reference computes the normalization RMS
                # before the mute zero-fill (src/source.cpp:1843-1871)
                push(rms_ring, rms_sq, counts)
                rms = torch.sqrt(rms_ring.buf.sum(-1)[:, 0] / rms_size)
            assign(state, step(ring.buf, state, scalars, active, rms))
            return rebin(self._display_values(state))

        def packed_tick(flat, ring, state, scalars, rms_ring=None,
                        ucount=None):
            """fused_tick on the packed rows ``flat`` [S, W]: ``scalars``
            is the [2] (g, 1 − g) pair; ``ucount`` (a 0-d integer tensor)
            replaces the per-stream counts column when every stream
            advanced alike, selecting the ring's batch shift instead of
            the per-stream gather (dsp/devring.py)."""
            s = flat.shape[0]
            new = flat[:, :C * H].view(s, C, H)
            rms_sq = (flat[:, C * H:C * H + H].view(s, 1, H) if normalize
                      else None)
            counts = flat[:, -3].to(torch.int64) if ucount is None else ucount
            return fused_tick(new, counts, ring, state, scalars,
                              flat[:, -2] > 0.5, flat[:, -1], rms_ring,
                              rms_sq)

        def bulk_tick(new, counts, ring, state, scalars, active, rms,
                      rms_ring=None):
            """One tick of ``tick_many`` (the JAX ``scan_ticks`` body): the
            pushed samples are raw — no mute path — so the RMS squares
            derive from them directly."""
            sq = None
            if normalize:
                m = new.abs().amax(dim=1, keepdim=True)
                sq = m * m
            return fused_tick(new, counts, ring, state, scalars, active, rms,
                              rms_ring, sq)

        self._packed_tick = packed_tick
        self._bulk_tick = bulk_tick

    # ------------------------------------------------------------------

    @property
    def packed_width(self) -> int:
        """Row width of the packed per-tick upload: C*H samples, the H
        RMS squares only under volume normalization, 3 meta columns."""
        return self.C * self.H + (self.H if self._normalize else 0) + 3

    def _bind_external(self, view: np.ndarray) -> None:
        """Point the assembly views at one tick's upload ``view`` (flat
        float32, ``_stride`` long): the packed rows, then the scalars."""
        S, W = self.S, self.packed_width
        CH, H = self.C * self.H, self.H
        R = H if self._normalize else 0
        rows = view[:S * W].reshape(S, W)
        self._in_buf = rows
        self._push_buf = rows[:, :CH].reshape(-1, self.C, H)
        self._rms_buf = rows[:, CH:CH + R]
        self._meta_buf = rows[:, CH + R:]
        self._tail = view[S * W:]

    def _packed(self, flat: torch.Tensor, uniform: bool):
        """The packed tick on one tick's uploaded ``flat``: its rows
        [S, W], its scalars [2] and, for the uniform form, its count as a
        0-d int64 tensor, all read on the device."""
        S, W = self.S, self.packed_width
        tail = flat[S * W:]
        return self._packed_tick(
            flat[:S * W].view(S, W), self.ring, self.state, tail[:2],
            self.rms_ring, tail[2].to(torch.int64) if uniform else None)

    def _graph_fn(self, key):
        """The base's tick kinds, and a tick_many step ("bulk", hop,
        uniform)."""
        kind, *rest = key
        if kind != "bulk":
            return super()._graph_fn(key)
        hop, uniform = rest
        b = self._bulk[hop]
        return lambda: self._bulk_tick(
            b["new"], b["ucount"] if uniform else b["counts"], self.ring,
            self.state, b["scalars"], b["active"], b["rms"], self.rms_ring)

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
        return take

    def _assemble(self, now_ns: int) -> None:
        """Fill the bound packed rows: samples, RMS squares, counts,
        active flags (the host half of the tick)."""
        sr = self.cfg.audio.samples_per_sec
        if self._native is not None:
            # C++ writes samples, RMS squares, counts and active directly
            # into the packed rows
            self._native.assemble_hop_packed(now_ns, self.H, self._in_buf,
                                             self._normalize,
                                             split_active=self._split_meta)
        elif self._batch_mode:
            take = self._assemble_batch(now_ns)
            if self._normalize:
                np.square(np.max(np.abs(self._push_buf), axis=1),
                          out=self._rms_buf)
            self._meta_buf[:, 0] = take
            p0 = self._pending[0]
            fresh = (now_ns - p0.capture_ts) <= CAPTURE_TIMEOUT_NS
            if self._split_meta:
                self._meta_buf[:, 1] = fresh
                self._meta_buf[:, 2] = p0.show
            else:
                self._meta_buf[:, 1] = p0.show and fresh
        else:
            self._push_buf[:] = 0.0
            self._rms_buf[:] = 0.0
            for i, p in enumerate(self._pending):
                fresh = (now_ns - p.capture_ts) <= CAPTURE_TIMEOUT_NS
                if self._split_meta:
                    self._meta_buf[i, 1] = fresh
                    self._meta_buf[i, 2] = p.show
                else:
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
        the ring then shifts the whole batch by one count."""
        counts_col = self._meta_buf[:, 0]
        c0 = counts_col[0]
        return bool((counts_col == c0).all()), int(c0)

    def _stage(self, now_ns: int, dt_f: float) -> bool:
        """Assemble the bound upload: packed rows, then the scalars (the
        gravity pair of ``dt_f`` and the uniform count).  Returns whether
        every stream advances alike."""
        self._assemble(now_ns)
        uniform, c0 = self._uniform_count()
        self._tail[:2] = gravity_pair(self.cfg, dt_f)
        self._tail[2] = c0
        return uniform

    # ------------------------------------------------------------------

    def tick(self, now_ns: int | None = None, dt: float | None = None):
        """One batched frame.  Returns the device pixels [S, D, P] (dBFS
        on the log-frequency axis), a tensor of their own.

        With ``microbatch=k`` the engine instead accumulates k assembled
        frames and runs them as ONE flush every k-th tick: per-frame
        semantics are identical, and the return value is the latest
        *flushed* frame (up to k−1 frames behind; ``last_batch_pixels``
        carries all k)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        dt_f = (1.0 / self.cfg.fps) if dt is None else float(dt)
        return self._tick(now_ns, dt_f)

    # ------------------------------------------------------------------

    def tick_many(self, new_samples, counts=None, active=None,
                  dt: float | None = None):
        """Bulk mode: process T video frames.

        ``new_samples`` is [T, S, C, hop] (numpy or a tensor) — each tick
        advances every stream's window by ``counts[t]`` (a [T] vector: one
        count for every stream) or ``counts[t, s]`` ([T, S]); default the
        full hop, alike — and runs the complete pipeline with ``active``
        [T, S] (default all True) and one ``dt``.  Returns pixels
        [T, S, D, P] on the device and updates ring/state.  The inputs go
        to the device at once; each tick copies its slice into the bulk
        tick's fixed buffers and replays its graph, and its pixels are
        copied out before the next replay."""
        dev = self.device
        new_T = torch.as_tensor(np.asarray(new_samples, np.float32)
                                if not isinstance(new_samples, torch.Tensor)
                                else new_samples).to(dev, torch.float32)
        T, hop = new_T.shape[0], new_T.shape[-1]
        counts_T = (torch.full((T,), hop, dtype=torch.int64) if counts is None
                    else torch.as_tensor(np.asarray(counts)).to(torch.int64))
        uniform = counts_T.dim() == 1
        active_T = (torch.ones((T, self.S), dtype=torch.bool) if active is None
                    else torch.as_tensor(np.asarray(active, bool)))
        counts_T, active_T = counts_T.to(dev), active_T.to(dev)
        b = self._bulk.get(hop)
        if b is None:
            S, C = self.S, self.C
            b = self._bulk[hop] = {
                "new": torch.zeros((S, C, hop), dtype=torch.float32,
                                   device=dev),
                "counts": torch.zeros(S, dtype=torch.int64, device=dev),
                "ucount": torch.zeros((), dtype=torch.int64, device=dev),
                "active": torch.ones(S, dtype=torch.bool, device=dev),
                "scalars": torch.zeros(2, dtype=torch.float32, device=dev),
                "rms": torch.zeros(S, dtype=torch.float32, device=dev)}
        dt = (1.0 / self.cfg.fps) if dt is None else dt
        b["scalars"].copy_(torch.from_numpy(gravity_pair(self.cfg, dt)))
        pxs = None
        for t in range(T):
            b["new"].copy_(new_T[t])
            b["ucount" if uniform else "counts"].copy_(counts_T[t])
            b["active"].copy_(active_T[t])
            px = self._call(("bulk", hop, uniform))
            if pxs is None:
                pxs = torch.empty((T, *px.shape), dtype=px.dtype, device=dev)
            pxs[t].copy_(px)
        self._last_pixels = pxs[-1]
        return pxs

    def read_pixels(self) -> np.ndarray:
        """Host readback of the latest rebinned frame (synchronizes)."""
        return self._last_pixels.cpu().numpy()

    def read_decibels(self) -> np.ndarray:
        """Host readback of the display values (dB buffer, natural bin
        order)."""
        return self._display_values(self.state).cpu().numpy()

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

    def resized(self, num_streams: int,
                keep: list[int] | None = None) -> "ServingEngine":
        """A new engine with ``num_streams`` rows; row ``i`` carries over
        old row ``keep[i]``'s analysis state (device window, EMA trail, dB
        buffer, silence latch, RMS window) and host sync bookkeeping; rows
        beyond ``len(keep)`` start fresh.  ``keep`` defaults to the first
        ``min(S, num_streams)`` rows.

        The live-scene resize (OBS adds/removes sources at any time).
        Queued-but-unticked audio does not migrate (the native assembler
        re-syncs from the next packet).  The new engine captures its own
        graphs at its first tick."""
        if keep is None:
            keep = list(range(min(self.S, num_streams)))
        if len(keep) > num_streams:
            raise ValueError(f"keep ({len(keep)} rows) exceeds "
                             f"num_streams={num_streams}")
        if any(not 0 <= j < self.S for j in keep):
            # an out-of-range index would migrate the WRONG stream's state
            raise ValueError(f"keep indices out of range for S={self.S}: "
                             f"{keep}")
        eng = type(self)(self.cfg, num_streams, hop_budget=self.H,
                         use_native=self._use_native_req,
                         microbatch=(self._mb_req if self._mb_auto
                                     else self._mb),
                         device=self.device)
        k = len(keep)
        if k:
            idx = torch.tensor(keep, dtype=torch.int64, device=self.device)
            for new, old in ((eng.ring, self.ring), (eng.state, self.state),
                             (eng.rms_ring, self.rms_ring)):
                if new is None or old is None:
                    continue
                for f in dataclasses.fields(new):
                    getattr(new, f.name)[:k] = getattr(old, f.name)[idx]
            for i, j in enumerate(keep):
                eng._pending[i] = self._pending[j]
            if self._native is not None and eng._native is not None:
                # carry sync timestamps + visibility so surviving streams
                # stay ACTIVE across the swap; the ring backlog stays behind
                for i, j in enumerate(keep):
                    eng._native.set_sync(i, *self._native.get_sync(j))
        return eng

    # ------------------------------------------------------------------

    def save_state(self, path: str) -> None:
        """Checkpoint device state (EMA trails, dB buffers, latches, ring)
        in the JAX engine's ``.npz`` leaf format, bins in natural order."""
        from ..utils.checkpoint import save_pytree
        save_pytree(path, (self.state, self.ring, self.rms_ring),
                    flat_rings=self._flat_ring_checkpoint)

    def load_state(self, path: str, keep: list[int] | None = None) -> None:
        """Resume a checkpoint into this engine (same config), in place
        (the captured graphs keep reading the same tensors).

        ``keep`` additionally migrates stream rows: checkpoint row
        ``keep[i]`` lands in this engine's row ``i`` and rows beyond
        ``len(keep)`` keep their current state."""
        from ..utils.checkpoint import load_pytree
        state, ring, rms_ring = load_pytree(
            path, (self.state, self.ring, self.rms_ring), keep=keep)
        assign(self.state, state)
        assign(self.ring, ring)
        if rms_ring is not None:
            assign(self.rms_ring, rms_ring)
