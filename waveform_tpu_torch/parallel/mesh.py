"""The (stream × pixel) device mesh of the sharded engines.

The PyTorch counterpart of ``waveform_tpu/parallel/mesh.py``:

* **stream axis (data parallel)** — concurrent audio streams split into
  contiguous row blocks, one block on each row of the mesh, with no
  exchange at all between the blocks (every stage is per stream);
* **pixel axis** — the entries of one mesh row hold the same stream block
  and each rebins its own block of output pixels (the spectrum stage is
  replicated along the axis, as the JAX mesh replicates it before the
  rebin's tensor-parallel split).

A :class:`Mesh` is a ``[stream, pixel]`` array of ``torch.device``\\ s,
each tagged with the ``torch.distributed`` rank of the process that owns
it.  A device may repeat: ``["cuda:0"] * 4`` is a 4-entry mesh on one
card, and ``["cpu"] * 8`` the CPU counterpart of the JAX tests' 8 forced
host devices.  Across processes :func:`make_mesh` exchanges each
process's devices in rank order (over gloo: the mesh's host exchanges,
the checkpoint's gather and its barrier are the only collectives — the
tick itself has none).

The JAX names ``stream_sharding``, ``replicated``, ``pixel_constraint`` and
``NamedSharding`` describe how XLA lays out one global array; the port
has no global array (each entry holds its rows as tensors of its own, and
a shard's rebin computes only its pixel block,
``rebin/apply.make_rebin_fn(pixels=...)``), so they have no counterpart.
``from_process_local`` keeps its job: it wraps the rows one process holds
as the checkpoint's :class:`~..utils.checkpoint.GlobalRows`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import checked_device, process_count, process_index
from ..utils.checkpoint import GlobalRows

STREAM_AXIS = "stream"
PIXEL_AXIS = "pixel"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` [stream, pixel] of ``torch.device``; ``process`` the
    owning rank of each entry; ``group`` the gloo group of the host
    exchanges (None: the default group, or no group in one process)."""

    devices: np.ndarray
    process: np.ndarray
    group: object = None

    axis_names = (STREAM_AXIS, PIXEL_AXIS)

    @property
    def shape(self) -> dict:
        s, p = self.devices.shape
        return {STREAM_AXIS: s, PIXEL_AXIS: p}

    @property
    def size(self) -> int:
        return self.devices.size

    def local_entries(self) -> list[tuple[int, int, torch.device]]:
        """(row, column, device) of every entry this process owns, in
        mesh order."""
        me = process_index()
        s, p = self.devices.shape
        return [(i, j, self.devices[i, j]) for i in range(s)
                for j in range(p) if self.process[i, j] == me]


def _gloo_group():
    """A gloo group over the default group's ranks (None when the default
    group is gloo already): the mesh's exchanges never need the card, and
    NCCL refuses two ranks on one card."""
    import torch.distributed as dist
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def make_mesh(devices=None, pixel_parallel: int = 1) -> Mesh:
    """Mesh over (stream, pixel): ``pixel_parallel`` entries cooperate on
    one stream block's rebin, the rest scale streams.

    ``devices`` are this process's devices (``torch.device`` or strings;
    repeats allowed); None takes every CUDA device and raises
    RuntimeError without one.  In a ``torch.distributed`` group of more
    than one process the call is collective: each process's devices join
    the mesh in rank order.  Raises ValueError when the device count does
    not divide by ``pixel_parallel``."""
    if devices is None:
        checked_device("cuda", "make_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [checked_device(d, "make_mesh") for d in devices]
    group = None
    if process_count() > 1:
        import torch.distributed as dist
        group = _gloo_group()
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, [str(d) for d in local], group=group)
        me = process_index()
        flat = [(local[k] if r == me else torch.device(d), r)
                for r, names in enumerate(parts)
                for k, d in enumerate(names)]
    else:
        flat = [(d, 0) for d in local]
    n = len(flat)
    if n == 0 or n % pixel_parallel != 0:
        raise ValueError(f"{n} devices not divisible by pixel_parallel="
                         f"{pixel_parallel}")
    shape = (n // pixel_parallel, pixel_parallel)
    devs = np.empty(n, object)
    devs[:] = [d for d, _ in flat]
    procs = np.array([r for _, r in flat], np.int64)
    return Mesh(devs.reshape(shape), procs.reshape(shape), group)


def stream_axis_size(mesh: Mesh) -> int:
    return mesh.shape[STREAM_AXIS]


def padded_streams(mesh: Mesh, num_streams: int) -> int:
    """Smallest stream count >= num_streams divisible across the mesh's
    stream axis: uneven user counts round up with inert padding streams
    (the JAX mesh's rule: FFTW-MPI's partial last block, the
    reference's deps/fftw-3.3.11/mpi/block.c)."""
    n = stream_axis_size(mesh)
    return -(-num_streams // n) * n


def pad_stream_dim(x: np.ndarray, total: int) -> np.ndarray:
    """Zero-pad a host [S, ...] array to ``total`` streams along axis 0."""
    if x.shape[0] == total:
        return x
    pad = [(0, total - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def row_block(mesh: Mesh, num_streams: int, i: int) -> tuple[int, int]:
    """[lo, hi) stream rows of mesh row ``i`` (``num_streams`` padded)."""
    b = num_streams // stream_axis_size(mesh)
    return i * b, (i + 1) * b


def pixel_block(mesh: Mesh, num_pixels: int, j: int) -> tuple[int, int]:
    """[p0, p1) output pixels of mesh column ``j``."""
    p = mesh.shape[PIXEL_AXIS]
    return j * num_pixels // p, (j + 1) * num_pixels // p


def local_stream_rows(mesh: Mesh, num_streams: int) -> tuple[int, int]:
    """The [start, stop) global stream rows this PROCESS owns: the rows of
    the mesh rows its entries sit on, which must form one contiguous run
    (raises ValueError when a device order interleaves processes, as the
    JAX function does; (0, 0) when the process owns no entry)."""
    spans = {row_block(mesh, num_streams, i)
             for i, _, _ in mesh.local_entries()}
    if not spans:
        return (0, 0)
    lo = min(a for a, _ in spans)
    end = lo
    for a, b in sorted(spans):
        if a > end:
            raise ValueError(
                "this process's devices own non-contiguous stream rows "
                f"{sorted(spans)}; order the mesh devices so each "
                "process's rows form one block (the FFTW-MPI 1-D block "
                "layout, mpi/block.c)")
        end = max(end, b)
    return (lo, end)


def from_process_local(mesh: Mesh, local: np.ndarray,
                       global_shape: tuple) -> GlobalRows:
    """The global [S, ...] leaf of which this process holds ``local``, its
    :func:`local_stream_rows` (the JAX function's job: each process
    contributes only its rows; in one process, the whole leaf)."""
    lo, hi = local_stream_rows(mesh, global_shape[0])
    if len(local) != hi - lo:
        raise ValueError(f"{len(local)} local rows for this process's "
                         f"[{lo}, {hi})")
    return GlobalRows(np.ascontiguousarray(local), lo, tuple(global_shape),
                      mesh.group)


def shard_state(mesh: Mesh, state, num_streams: int | None = None) -> dict:
    """The rows of a state dataclass, ring or tensor (a tree of [S, ...]
    leaves, S padded to the mesh) placed on this process's mesh entries:
    ``{(row, column): the tree of rows [lo, hi) on that entry's
    device}``."""
    def rows(x, lo, hi, dev):
        if x is None:
            return None
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: rows(getattr(x, f.name), lo, hi, dev)
                              for f in dataclasses.fields(x)})
        return torch.as_tensor(x[lo:hi]).to(dev)

    S = num_streams
    if S is None:
        leaf = state
        while dataclasses.is_dataclass(leaf):
            leaf = getattr(leaf, dataclasses.fields(leaf)[0].name)
        S = leaf.shape[0]
    return {(i, j): rows(state, *row_block(mesh, S, i), dev)
            for i, j, dev in mesh.local_entries()}
