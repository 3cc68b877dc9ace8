"""Mesh-sharded serving: S streams over the entries of a device mesh.

The PyTorch counterpart of ``waveform_tpu/parallel/sharded_serving.py``.
The JAX engine places one global array across a ``jax.sharding.Mesh`` and
lets XLA partition the jitted tick; the port has no global array, so each
mesh entry this process owns gets a *shard*: the device half of an engine
of the family over the entry's stream rows ``[lo, hi)`` on the entry's
device — its own ring, state, RMS ring and captured tick graphs, and (for
the spectrum family) a rebin that computes only the entry's pixel block
(``rebin/apply.make_rebin_fn(pixels=...)``).

* **stream axis** — every per-stream stage runs on its shard's rows with
  no exchange between shards (FFTW-MPI's block distribution, the
  reference's deps/fftw-3.3.11/mpi/block.c), uneven counts rounded up to
  inert padding streams that are never fed, time out and sit at DB_MIN;
* **pixel axis** — the entries of one mesh row each run the spectrum
  stage on the same rows (the JAX mesh replicates it there too) and
  rebin their own pixel block; the exact-FFT launches a tick equal the
  mesh's entries.

The host half is the family's own, inherited unchanged over all padded
rows: packet queues, A/V sync, the native assembler and one pinned packed
block a tick.  Each shard's rows ``[lo, hi)`` of that block (and the
tick's scalars behind the rows) are copied ``non_blocking`` into the
shard's device buffer, fenced by one event a shard, and the shard replays
its graph (``PackedTickEngine.tick_rows``).  Cohort mode
(``bind_cohort``) does not serve here: a cohort member reads a segment of
one device block that one copy fills, and a shard needs its own copy on
its own device, of rows that the scalars do not follow.

The exact FFT routes in each shard as in the single engine: the pair
kernel (K1-gen / K2 and their df instances) where
``exact_cuda.kernel_would_run(n)``, else K3 or the lowering, by the same
variables.  Here the port departs from the JAX sharded engine, which
sends every route but the pair kernel to the lowering
(``waveform_tpu/parallel/sharded_serving.py:58-66``) because a
``pallas_call`` has no partitioning rule inside its sharded program.  A
shard is a program of its own on its own device, so that limit does not
arise, and K3 runs shard-local like the pair kernel.

Across processes (a ``torch.distributed`` group, gloo) every process
builds the same engine over the same mesh; it owns the entries of its
devices, uploads only their rows, and is fed only its
:attr:`local_streams`.  ``save_state`` and ``load_state`` are collective;
``resized`` refuses, as the JAX engine refuses (re-provision through the
checkpoint instead).  Outputs come as :class:`Tile`\\ s, the port's
addressable shards: ``tick`` returns this process's tiles and
``pixels_sharded`` holds them; ``read_pixels`` and the other host reads
assemble them in one process.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import ResolvedConfig
from ..core.device import process_count
from ..dsp.devring import DeviceRing, set_window, window
from ..runtime.meter_serving import MeterServingEngine
from ..runtime.serving import ServingEngine
from ..utils.checkpoint import load_pytree
from .mesh import (
    PIXEL_AXIS,
    Mesh,
    from_process_local,
    local_stream_rows,
    make_mesh,
    pad_stream_dim,
    padded_streams,
    pixel_block,
    row_block,
)


class Tile(NamedTuple):
    """One mesh entry's part of an output: ``data`` on the entry's device
    and ``index``, its slices of the global output (the JAX shard's
    ``.data`` and ``.index``)."""

    data: torch.Tensor
    index: tuple


@dataclasses.dataclass
class _Shard:
    eng: object            # the entry's device half, over rows [lo, hi)
    row: int               # its mesh row
    lo: int
    hi: int
    pixels: tuple | None   # the rebin's pixel block, None for all

    @property
    def index(self) -> tuple:
        return (slice(self.lo, self.hi), slice(None),
                slice(None) if self.pixels is None else slice(*self.pixels))


class _EventSet(list):
    """The events of one upload, one a shard (``_bind_buf`` waits on all)."""

    def synchronize(self) -> None:
        for ev in self:
            ev.synchronize()


class _DeviceHalf:
    """A shard: an engine of the family whose host half is never used (the
    sharded engine stages for it and hands it its rows, ``tick_rows``),
    so its upload buffers need not be pinned."""

    def _host_buffer(self, k: int) -> torch.Tensor:
        return torch.zeros(k * self._stride, dtype=torch.float32)


class _SpectrumShard(_DeviceHalf, ServingEngine):
    """A spectrum shard: the single engine over its rows, rebinning only
    its pixel block."""

    def __init__(self, cfg: ResolvedConfig, num_streams: int, pixels, **kw):
        self._pixels = pixels
        super().__init__(cfg, num_streams, **kw)

    def _rebin_kwargs(self) -> dict:
        return {} if self._pixels is None else {"pixels": self._pixels}


class _MeterShard(_DeviceHalf, MeterServingEngine):
    pass


def _windows(leaf) -> torch.Tensor:
    """A leaf as a tensor: a ``DeviceRing``'s windows in order."""
    return window(leaf) if isinstance(leaf, DeviceRing) else leaf


class ShardedMixin:
    """The placement shared by the sharded families: the shards, the
    scattered upload, the tiles and the row gathers.  A family sets
    ``_spread_pixels`` (each entry of a mesh row gets a pixel block; False:
    one shard a row block, the pixel axis replicated) and provides
    ``_make_shard(rows, device, pixels)`` and ``_leaf_getters()``."""

    _spread_pixels = False

    def _setup_mesh(self, mesh: Mesh | None, num_streams: int,
                    pixel_parallel: int = 1, **kw) -> tuple:
        """Set the mesh and the user's row count; returns (the padded row
        count, the device of this process's first entry)."""
        if "device" in kw:
            raise TypeError("a sharded engine is placed by its mesh, not by "
                            "device=")
        self.mesh = (make_mesh(pixel_parallel=pixel_parallel) if mesh is None
                     else mesh)
        self.user_streams = num_streams
        padded = padded_streams(self.mesh, num_streams)
        # which global stream rows this process's entries own (multi-
        # process feeders ingest only these; one process owns them all)
        self._local_rows = local_stream_rows(self.mesh, padded)
        entries = self.mesh.local_entries()
        if not entries:
            raise ValueError("this process owns no entry of the mesh")
        return padded, entries[0][2]

    def _num_pixels(self) -> int:
        from ..rebin.interp import build_interp_tables
        return build_interp_tables(self.cfg).num_outputs

    def _init_device_state(self) -> None:
        """One shard for each of this process's mesh entries (for each
        row block, without ``_spread_pixels``)."""
        spread = self._spread_pixels and self.mesh.shape[PIXEL_AXIS] > 1
        P = self._num_pixels() if spread else 0
        shards, rows = [], set()
        for i, j, dev in self.mesh.local_entries():
            if not spread and i in rows:
                continue
            rows.add(i)
            lo, hi = row_block(self.mesh, self.S, i)
            pixels = pixel_block(self.mesh, P, j) if spread else None
            shards.append(_Shard(self._make_shard(hi - lo, dev, pixels),
                                 i, lo, hi, pixels))
        self._shards = shards
        self._rotating = all(sh.eng._rotating for sh in shards)
        self._filtered = all(sh.eng._filtered for sh in shards)

    def _init_uploads(self) -> None:
        # the host blocks are the family's; the device buffers are the
        # shards'
        self._init_host_uploads()
        self._dev_in = None
        first = [sh.eng._last_pixels for sh in self._shards]
        self._last_pixels = (None if first[0] is None
                             else self._tiles(first))

    # -- the tick ---------------------------------------------------------

    def _tiles(self, outs, lead: int = 0) -> list:
        return [Tile(out, (slice(None),) * lead + sh.index)
                for out, sh in zip(outs, self._shards)]

    def _tick_shards(self, host: torch.Tensor, k: int, uniform: bool,
                     events: list, i: int) -> list:
        """Run each shard's tick (k = 1) or flush of k on its rows of the
        k staged slots of ``host`` (``tick_rows``, the family's own
        device half); keep the copies' events, one a shard, in
        ``events[i]``.  Returns the shards' outputs."""
        outs, evs = [], _EventSet()
        for sh in self._shards:
            out, ev = sh.eng.tick_rows(host, self.S, sh.lo, k, uniform)
            outs.append(out)
            if ev is not None:
                evs.append(ev)
        events[i] = evs
        return outs

    def _run_tick(self, uniform: bool):
        tiles = self._tiles(self._tick_shards(self._host[self._flip], 1,
                                              uniform, self._events,
                                              self._flip))
        self._last_pixels = tiles
        return tiles

    def _flush_microbatch(self, host: torch.Tensor, k: int,
                          uniform: bool) -> None:
        outs = self._tick_shards(host, k, uniform, self._mb_events,
                                 self._mb_flip)
        self._last_batch = self._tiles(outs, lead=1)
        self._last_pixels = self._tiles([o[-1] for o in outs])

    def _block(self, out) -> None:
        for sh in self._shards:
            if sh.eng.device.type == "cuda":
                torch.cuda.synchronize(sh.eng.device)

    def _drop_graphs(self, *kinds: str) -> None:
        super()._drop_graphs(*kinds)
        for sh in getattr(self, "_shards", ()):
            sh.eng._drop_graphs(*kinds)

    @property
    def kernels_per_replay(self) -> dict:
        """{tick kind: {kernel name (``cuda_lib.LAUNCHES``'s): launches of
        one replay of every shard's graph}}, the shards' counts summed
        (empty on the CPU)."""
        out: dict = {}
        for sh in self._shards:
            for key, d in sh.eng.kernels_per_replay.items():
                acc = out.setdefault(key, {})
                for c, n in d.items():
                    acc[c] = acc.get(c, 0) + n
        return out

    def bind_cohort(self, row0: int, block=None) -> None:
        raise NotImplementedError(
            "cohort fusion is a single-device MultiEngine optimization; a "
            "mesh-sharded engine owns its own packed upload")

    # -- rows across the shards -------------------------------------------

    def _row_reps(self) -> list:
        """One shard for each of this process's row blocks, in row order."""
        reps: dict = {}
        for sh in self._shards:
            reps.setdefault(sh.row, sh)
        return [reps[i] for i in sorted(reps)]

    def _one_process(self, what: str) -> None:
        if process_count() > 1:
            raise RuntimeError(
                f"{what} reads rows of every process: across processes use "
                "pixels_sharded, or to_host (utils/checkpoint.py) on the "
                "engine's state, which is collective")

    def _global_leaf(self, get):
        """The [S, ...] leaf ``get(shard engine)`` as this process's rows of
        it (a ``GlobalRows``, ``parallel/mesh.from_process_local``); a
        ``DeviceRing`` leaf gives its windows in order."""
        local = np.concatenate([_windows(get(sh.eng)).detach().cpu().numpy()
                                for sh in self._row_reps()])
        return from_process_local(self.mesh, local,
                                  (self.S,) + local.shape[1:])

    def _scatter_leaf(self, get, rows) -> None:
        """Write the ``GlobalRows`` ``rows`` into ``get(shard engine)`` of
        every shard, in place (the graphs read those tensors); into a
        ``DeviceRing`` leaf as its windows in order."""
        for sh in self._shards:
            dst = get(sh.eng)
            src = torch.from_numpy(np.ascontiguousarray(
                rows.local[sh.lo - rows.lo:sh.hi - rows.lo]))
            if isinstance(dst, DeviceRing):
                set_window(dst, src.to(dst.buf.device, dst.buf.dtype))
            else:
                dst.copy_(src.to(dst.device, dst.dtype))

    def _host_rows(self, read) -> np.ndarray:
        """``read(shard engine)`` (a host array) of the row blocks, stacked
        and trimmed to the user's rows (one process)."""
        return np.concatenate([read(sh.eng)
                               for sh in self._row_reps()])[:self.user_streams]

    def _migrate(self, eng, keep: list[int]) -> None:
        """Row ``i`` of ``eng`` takes this engine's row ``keep[i]`` of
        every device leaf (gather -> rebuild -> scatter, one process)."""
        idx = np.asarray(keep, np.int64)
        for get in self._leaf_getters():
            old = self._global_leaf(get).gather()
            new = eng._global_leaf(get)
            full = new.gather().copy()
            full[:len(keep)] = old[idx]
            eng._scatter_leaf(get, new.local_of(full))

    def _check_keep(self, num_streams: int, keep):
        if process_count() > 1:
            raise NotImplementedError(
                f"multi-process resize: construct a new {type(self).__name__}"
                " and carry state across with save_state / "
                "load_state(keep=...), collective on every process")
        if keep is None:
            keep = list(range(min(self.user_streams, num_streams)))
        if len(keep) > num_streams:
            raise ValueError(f"keep ({len(keep)} rows) exceeds "
                             f"num_streams={num_streams}")
        if any(not 0 <= j < self.user_streams for j in keep):
            raise ValueError("keep indices out of range for user_streams="
                             f"{self.user_streams}: {keep}")
        return keep

    # -- user-facing ------------------------------------------------------

    @property
    def local_streams(self) -> tuple[int, int]:
        """[start, stop) of the global stream rows this process feeds
        (every process feeds only its own; one process owns them all)."""
        return self._local_rows

    @property
    def pixels_sharded(self) -> list:
        """This process's tiles of the latest output (untrimmed)."""
        return self._last_pixels

    @property
    def last_batch_pixels(self):
        """Tiles of the last microbatch flush, each [k, ...]."""
        return self._last_batch

    def read_pixels(self) -> np.ndarray:
        """Host copy of the latest output, assembled from the tiles and
        trimmed to the user's rows (one process)."""
        self._one_process("read_pixels")
        tiles = self._last_pixels
        shape = [max(t.index[a].stop or t.data.shape[a] for t in tiles)
                 for a in range(tiles[0].data.dim())]
        out = np.empty(shape, np.float32)
        for t in tiles:
            out[t.index] = t.data.cpu().numpy()
        return out[:self.user_streams]


class ShardedServingEngine(ShardedMixin, ServingEngine):
    """ServingEngine over a device mesh (streams DP × rebin pixels).

    ``num_streams`` is the user-visible count; internally it rounds up to
    a multiple of the mesh's stream-axis size with inert padding streams.
    ``mesh`` defaults to ``make_mesh(pixel_parallel=pixel_parallel)`` over
    every CUDA device; ``**kw`` are ``ServingEngine``'s (not ``device``).
    Host reads trim back to ``num_streams`` rows.
    """

    _spread_pixels = True

    def __init__(self, cfg: ResolvedConfig, num_streams: int,
                 mesh: Mesh | None = None, pixel_parallel: int = 1, **kw):
        padded, dev = self._setup_mesh(mesh, num_streams, pixel_parallel,
                                       **kw)
        super().__init__(cfg, padded, device=dev, **kw)

    def _make_shard(self, rows: int, device, pixels):
        return _SpectrumShard(self.cfg, rows, pixels, hop_budget=self.H,
                              rfft_fn=self._rfft_fn, use_native=False,
                              device=device)

    def _build_device_programs(self) -> None:
        pass   # each shard builds its own

    def _leaf_getters(self) -> list:
        # the sample ring as it lies, read and written as its windows in
        # order (_global_leaf, _scatter_leaf)
        st = self._shards[0].eng
        gets = [lambda e: e._ring]
        gets += [lambda e, n=f.name: getattr(e.state, n)
                 for f in dataclasses.fields(st.state)]
        if st.rms_ring is not None:
            gets.append(lambda e: e.rms_ring.buf)
        return gets

    # -- the state as global leaves (JAX's global arrays) ------------------

    @property
    def state(self):
        """The state as ``GlobalRows`` leaves of this process's rows
        (``utils/checkpoint.to_host`` gathers a leaf, collectively)."""
        st = self._shards[0].eng.state
        return type(st)(**{
            f.name: self._global_leaf(lambda e, n=f.name: getattr(e.state, n))
            for f in dataclasses.fields(st)})

    @property
    def ring(self) -> DeviceRing:
        return DeviceRing(buf=self._global_leaf(lambda e: e._ring))

    @property
    def rms_ring(self):
        if self._shards[0].eng.rms_ring is None:
            return None
        return DeviceRing(buf=self._global_leaf(lambda e: e.rms_ring.buf))

    # -- user-facing padding/trimming -------------------------------------

    def feed_batch(self, data: np.ndarray, timestamp_ns: int,
                   now_ns: int | None = None) -> None:
        if data.shape[0] == self.user_streams and self.S != self.user_streams:
            data = pad_stream_dim(np.asarray(data, np.float32), self.S)
        super().feed_batch(data, timestamp_ns, now_ns)

    def tick_many(self, new_samples, counts=None, active=None,
                  dt: float | None = None) -> list:
        """Bulk mode over the mesh (``ServingEngine.tick_many`` on each
        shard's rows): returns this process's tiles, each [T, ...]; pads
        the user's rows as the JAX engine does (pad rows inactive)."""
        new_samples = np.asarray(new_samples, np.float32)
        T, pad = new_samples.shape[0], self.S - self.user_streams
        if new_samples.shape[1] == self.user_streams and pad:
            new_samples = np.concatenate(
                [new_samples, np.zeros((T, pad) + new_samples.shape[2:],
                                       np.float32)], axis=1)
            if counts is not None and np.ndim(counts) == 2:
                counts = np.concatenate(
                    [np.asarray(counts), np.zeros((T, pad), np.int32)], axis=1)
            active = np.concatenate(
                [np.ones((T, self.user_streams), bool) if active is None
                 else np.asarray(active, bool), np.zeros((T, pad), bool)],
                axis=1)
        outs = []
        for sh in self._shards:
            rows = slice(sh.lo, sh.hi)
            c = (counts[:, rows] if counts is not None and np.ndim(counts) == 2
                 else counts)
            a = None if active is None else np.asarray(active)[:, rows]
            outs.append(sh.eng.tick_many(new_samples[:, rows], c, a, dt))
        self._last_pixels = self._tiles([o[-1] for o in outs])
        return self._tiles(outs, lead=1)

    def read_decibels(self) -> np.ndarray:
        self._one_process("read_decibels")
        return self._host_rows(lambda e: e.read_decibels())

    @property
    def last_silent(self) -> np.ndarray:
        self._one_process("last_silent")
        return self._host_rows(lambda e: e.last_silent)

    def render_frames(self) -> torch.Tensor:
        """RGBA frames [num_streams, outH, outW, 4] on the first entry's
        device (one process)."""
        self._one_process("render_frames")
        return torch.cat([sh.eng.render_frames().to(self.device)
                          for sh in self._row_reps()])[:self.user_streams]

    def load_state(self, path: str, keep: list[int] | None = None) -> None:
        """Resume (optionally row-migrating, see ``ServingEngine.
        load_state``) and write each shard's rows in place.  Every process
        calls it (with ``keep`` it gathers the current rows, collectively,
        as the JAX engine's does), and the save that produced ``path`` is
        itself collective."""
        state, ring, rms_ring = load_pytree(
            path, (self.state, self.ring, self.rms_ring), keep=keep)
        leaves = [ring.buf] + [getattr(state, f.name)
                               for f in dataclasses.fields(state)]
        if rms_ring is not None:
            leaves.append(rms_ring.buf)
        for get, rows in zip(self._leaf_getters(), leaves):
            self._scatter_leaf(get, rows)

    def resized(self, num_streams: int, keep: list[int] | None = None,
                mesh: Mesh | None = None) -> "ShardedServingEngine":
        """Live resize across the mesh: gather -> rebuild (optionally on a
        NEW mesh shape) -> scatter.  ``keep`` indexes USER rows (padding
        rows never migrate); host sync bookkeeping moves as in
        ``ServingEngine.resized``.  One process only: across processes,
        build a new engine and carry state with save_state +
        load_state(keep=...)."""
        keep = self._check_keep(num_streams, keep)
        eng = type(self)(self.cfg, num_streams,
                         mesh=self.mesh if mesh is None else mesh,
                         hop_budget=self.H, rfft_fn=self._rfft_fn,
                         use_native=self._use_native_req,
                         microbatch=(self._mb_req if self._mb_auto
                                     else self._mb))
        if keep:
            self._migrate(eng, keep)
            for i, j in enumerate(keep):
                eng._pending[i] = self._pending[j]
            if self._native is not None and eng._native is not None:
                for i, j in enumerate(keep):
                    eng._native.set_sync(i, *self._native.get_sync(j))
        return eng


class ShardedMeterServingEngine(ShardedServingEngine, MeterServingEngine):
    """Mesh-sharded batched level-meter serving.

    ``MeterServingEngine`` contributes the mode (the meter reduction, the
    (counts, fresh, show) meta columns, the [S, C, L] ring checkpoint) and
    ``ShardedServingEngine`` the placement.  The meter has no pixel axis:
    a mesh with one replicates over it, and each row block has one shard.
    """

    _spread_pixels = False

    def _make_shard(self, rows: int, device, pixels):
        return _MeterShard(self.cfg, rows, hop_budget=self.H,
                           use_native=False, device=device)

    @property
    def meter_values(self) -> torch.Tensor:
        """Latest levels [num_streams, C] dBFS on the first entry's device
        (one process)."""
        self._one_process("meter_values")
        return torch.cat([sh.eng.meter_values.to(self.device)
                          for sh in self._row_reps()])[:self.user_streams]
