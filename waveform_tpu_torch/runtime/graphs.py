"""Captured ticks: the port's counterpart of ``jax.jit`` on the serving tick.

The JAX engine runs each tick as one compiled program (``_jit_tick_packed``
and ``_jit_tick_packed_u``, ``waveform_tpu/runtime/serving.py:594-600``);
the eager port launched every torch op of the tick from the host, and the
host's dispatch was the tick's first bottleneck.  On a CUDA device a
:class:`GraphTick` runs its function eagerly once, on a side stream, as
the warm-up (the kernels' constants upload, their one-time attributes are
set, the libraries make their handles and plans), then captures one
``torch.cuda.CUDAGraph`` of it and replays that graph from then on.  On
the CPU it calls the function eagerly every time.

A captured function reads only tensors whose addresses stay fixed (the
engine's device input buffer, its ring and state, which the tick updates
in place) and host values that the JAX program fixes at trace: the
config's constants and the exact-FFT routing variables, which are read
once, when the graph is captured (changing them later needs a new engine,
as it needs a new program in JAX).  What changes from tick to tick is
device data written before the replay.  A capture or replay that fails
raises, a capture with the reason (an op that synchronizes with the host,
in the step or in a caller's ``rfft_fn``); nothing falls back to eager
launches.

A capture runs with Python's garbage collector off (:func:`no_gc`): the
collector frees the graphs of dropped engines, and freeing a graph during
a capture invalidates it.

Launch counts: ``kernels/cuda_lib.LAUNCHES`` counts kernel launches by
kernel name (each exact FFT kernel's and the spectrum tail's).  A replay
launches the kernels that the capture recorded, so a :class:`GraphTick`
keeps what the table gained during the capture as :attr:`launches` (and
takes it back out: a capture launches nothing) and adds it to the table
at every replay.

Stage marks (``runtime/profiler.mark``): where the warm-up passed marks
that make a stage, a :class:`GraphTick` captures a second graph of the
same function right after the first, its **stamped twin**, in which each
mark records a timing event (an event-record node).  The twin shares the
plain graph's memory pool and has no warm-up of its own, so the state
advances exactly as it does without it.  While tracing is on a tick
replays the twin and the profiler reads its stages on the device clock;
off, it replays the plain graph.  On the CPU the marks record the host
clock while tracing is on.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from ..kernels import cuda_lib
from . import profiler

# the side stream of every warm-up and capture on a device: the libraries
# keep a workspace for each stream they run on (cuBLAS's lives as long as
# the process), so a new stream per capture would grow device memory with
# every graph a live scene captures
_SIDE: dict = {}


def _side_stream(dev: torch.device):
    side = _SIDE.get(dev)
    if side is None:
        side = _SIDE[dev] = torch.cuda.Stream(dev)
    return side


@contextlib.contextmanager
def no_gc():
    """Keep Python's garbage collector off for the block (a capture).  A
    dropped engine's graphs are freed when the collector finds their
    reference cycles, and freeing a CUDA graph is an operation a capture
    forbids: run by a collection that an allocation inside the capture
    set off, it invalidates the capture.  The garbage waits for the next
    collection after the block."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class GraphTick:
    """``fn()`` run eagerly on the CPU; on a CUDA device run eagerly once
    on a side stream (that call's output is returned), then captured and
    replayed.  A replay returns the graph's own output tensors, which the
    next replay overwrites: a caller that hands them out copies them.

    ``generators``: the ``torch.Generator`` objects that ``fn`` draws from,
    registered with the graph before its capture, so that each replay
    draws new numbers and advances them (an unregistered generator cannot
    be used in a capture).  ``kind`` names the tick in the profiler's
    ``graph.captures`` counter."""

    def __init__(self, fn, device: torch.device, generators=(),
                 kind="graph"):
        self._fn = fn
        self.device = device
        self._generators = tuple(generators)
        self.kind = kind
        self.graph = None
        self._out = None
        self.twin = None           # the stamped twin, where marks make stages
        self._twin_out = None
        self._stamps = None
        self.launches: dict = {}   # kernel name -> launches a replay

    def __call__(self):
        if self.device.type != "cuda":
            if profiler.on:
                return profiler.host_marks(self._fn)
            return self._fn()
        # the warm-up, the capture and each replay on the tick's own card
        # (a mesh ticks one graph on each of its devices in turn); the
        # device guard, a fixed host cost on every tick, only where another
        # card is current
        index = self.device.index
        if index is not None and index != torch.cuda.current_device():
            with torch.cuda.device(index):
                return self._run()
        return self._run()

    def _run(self):
        """The warm-up and capture at the first call, a replay after, on
        the current card."""
        if self.graph is None:
            return self._warm_and_capture()
        if profiler.on and self.twin is not None:
            self._stamps.replaying()
            self.twin.replay()
            out = self._twin_out
        else:
            self.graph.replay()
            out = self._out
        cuda_lib.LAUNCHES.update(self.launches)
        return out

    def _capture(self, graph, side, sink, **kw):
        """Capture ``fn`` into ``graph`` on ``side`` with its marks sent to
        ``sink``; returns its output.  The capture launches nothing, so
        what the launch table gained is taken back out, and returned
        beside the output."""
        for g in self._generators:
            graph.register_generator_state(g)
        before = cuda_lib.LAUNCHES.copy()
        try:
            with no_gc(), profiler.marking(sink), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="global", **kw):
                out = self._fn()
        finally:
            gained = cuda_lib.LAUNCHES - before
            cuda_lib.LAUNCHES.subtract(gained)
        return out, dict(gained)

    def _warm_and_capture(self):
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        profiler.captured(self.kind)
        with profiler.setup("graph.capture"):
            side.wait_stream(main)
            seen: list = []
            with torch.cuda.stream(side), profiler.marking(
                    lambda name: seen.append((name, None))):
                out = self._fn()                  # the warm-up: a real tick
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                self._out, self.launches = self._capture(graph, side, None)
            except RuntimeError as e:
                raise RuntimeError(
                    "the tick cannot be captured in a CUDA graph (does the "
                    "step, or a caller's rfft_fn, synchronize with the host, "
                    f"as .item() or a copy to the CPU does?): {e}") from e
            self.graph = graph
            if profiler.stages(seen):
                stamps = profiler.Stamps()
                twin = torch.cuda.CUDAGraph()
                self._twin_out, _ = self._capture(twin, side, stamps.stamp,
                                                  pool=graph.pool())
                self.twin, self._stamps = twin, stamps
        return out
