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
raises; nothing falls back to eager launches.

Launch counts: ``exact_cuda``'s counters count kernel launches.  A replay
launches the kernels that the capture recorded, so a :class:`GraphTick`
counts each wrapper call made during the capture (and takes those calls
back out of the counters: a capture launches nothing) and adds that count
to the counters at every replay.
"""

from __future__ import annotations

import torch

from ..kernels import exact_cuda

COUNTERS = ("launches_gen", "launches_gen_df", "launches3", "launches3_df",
            "launches_cfft")


def _counts() -> dict:
    return {c: getattr(exact_cuda, c) for c in COUNTERS}


def _add_counts(delta: dict) -> None:
    for c, n in delta.items():
        setattr(exact_cuda, c, getattr(exact_cuda, c) + n)


class GraphTick:
    """``fn()`` run eagerly on the CPU; on a CUDA device run eagerly once
    on a side stream (that call's output is returned), then captured and
    replayed.  A replay returns the graph's own output tensors, which the
    next replay overwrites: a caller that hands them out copies them."""

    def __init__(self, fn, device: torch.device):
        self._fn = fn
        self.device = device
        self.graph = None
        self._out = None
        self.launches: dict = {}   # exact_cuda counter -> kernels a replay

    def __call__(self):
        if self.device.type != "cuda":
            return self._fn()
        if self.graph is None:
            return self._warm_and_capture()
        self.graph.replay()
        _add_counts(self.launches)
        return self._out

    def _warm_and_capture(self):
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._fn()                  # the warm-up: a real tick
        main.wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="global"):
            self._out = self._fn()
        after = _counts()
        self.launches = {c: after[c] - before[c] for c in COUNTERS
                         if after[c] != before[c]}
        _add_counts({c: -n for c, n in self.launches.items()})
        self.graph = graph
        return out
