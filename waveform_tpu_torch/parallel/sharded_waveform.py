"""Mesh-sharded batched waveform (oscilloscope) serving.

The PyTorch counterpart of ``waveform_tpu/parallel/sharded_waveform.py``,
completing the engine-family trio: spectrum and meter
(``parallel/sharded_serving.py``) and the time-domain waveform mode
(the reference's src/source_generic.cpp:271-390).

The waveform step is purely per-stream — the resample gather keys on each
stream's own index row, the scroll is a per-stream slice, and the dB and
latch tail is elementwise — so each mesh row's shard runs its stream block
with no exchange at all.  There is no pixel-axis split: the gather needs
each stream's whole ring, so a mesh with a pixel axis replicates over it
(one shard a row block).

The host half (per-stream chunk queues, int64 timestamp math, the packed
single-upload assembly, microbatch) is ``DeviceWaveformEngine``'s,
inherited unchanged over all padded rows; the placement is
``sharded_serving.ShardedMixin``'s.
"""

from __future__ import annotations

import numpy as np

from ..core.config import ResolvedConfig
from ..runtime.waveform_device import DeviceWaveformEngine
from .mesh import Mesh
from .sharded_serving import ShardedMixin, _DeviceHalf


class _WaveformShard(_DeviceHalf, DeviceWaveformEngine):
    pass


class ShardedWaveformEngine(ShardedMixin, DeviceWaveformEngine):
    """DeviceWaveformEngine over a device mesh (streams data-parallel).

    ``num_streams`` is the user-visible count; internally it rounds up to
    a multiple of the mesh's stream-axis size with inert padding streams
    (never fed -> capture timeout -> frozen at DB_MIN).  Host reads
    (:meth:`render_values`, :attr:`last_silent`) trim back to
    ``num_streams`` rows; :attr:`display` is this process's tiles of the
    live display, padded.  ``**kw`` are ``DeviceWaveformEngine``'s (not
    ``device``).
    """

    def __init__(self, cfg: ResolvedConfig, num_streams: int,
                 mesh: Mesh | None = None, **kw):
        padded, dev = self._setup_mesh(mesh, num_streams, **kw)
        super().__init__(cfg, padded, device=dev, **kw)

    def _make_shard(self, rows: int, device, pixels):
        return _WaveformShard(self.cfg, rows, hop_budget=self.H,
                              max_lead_s=self._max_lead_s, use_native=False,
                              device=device)

    def _leaf_getters(self) -> list:
        gets = [lambda e: e.ring.buf, lambda e: e.buf, lambda e: e.latch]
        if self._normalize:
            gets.append(lambda e: e.rms_ring.buf)
        return gets

    # -- user-facing padding/trimming -------------------------------------

    @property
    def display(self) -> list:
        """This process's tiles of the live display buffer (views)."""
        return self._tiles([sh.eng.display for sh in self._shards])

    def render_values(self) -> np.ndarray:
        self._one_process("render_values")
        return self._host_rows(lambda e: e.render_values())

    @property
    def last_silent(self) -> np.ndarray:
        self._one_process("last_silent")
        return self._host_rows(lambda e: e.last_silent)

    # -- live mesh resize -------------------------------------------------

    def resized(self, num_streams: int, keep: list[int] | None = None,
                mesh: Mesh | None = None) -> "ShardedWaveformEngine":
        """Live resize across the mesh: gather -> rebuild (optionally on a
        NEW mesh shape) -> scatter; host sync objects move with their rows.
        ``keep`` indexes USER rows.  One process only, like
        ``ShardedServingEngine.resized`` (across processes: a new engine,
        re-fed — waveform state is a rolling display window)."""
        keep = self._check_keep(num_streams, keep)
        eng = type(self)(self.cfg, num_streams,
                         mesh=self.mesh if mesh is None else mesh,
                         hop_budget=self.H, max_lead_s=self._max_lead_s,
                         use_native=self._use_native_req,
                         microbatch=(self._mb_req if self._mb_auto
                                     else self._mb))
        if keep:
            self._migrate(eng, keep)
            eng._last_pixels = eng._tiles([sh.eng.display.clone()
                                           for sh in eng._shards])
            for i, j in enumerate(keep):
                eng._streams[i] = self._streams[j]
            self._migrate_native(eng, keep)
        return eng
