"""Multi-device serving: the (stream × pixel) mesh and the sharded engines.

The names of ``waveform_tpu.parallel`` that have a torch counterpart.
``stream_sharding``, ``replicated`` and ``pixel_constraint`` build JAX
shardings of one global array, which the port does not have (each mesh
entry holds its own rows, and a shard's rebin computes only its pixel
block): they are left out (see ``parallel/mesh.py``).
"""

from .mesh import (
    PIXEL_AXIS,
    STREAM_AXIS,
    make_mesh,
    pad_stream_dim,
    padded_streams,
    shard_state,
    stream_axis_size,
)
from .sharded_serving import (
    ShardedMeterServingEngine,
    ShardedServingEngine,
)
from .sharded_waveform import ShardedWaveformEngine

__all__ = [
    "PIXEL_AXIS",
    "STREAM_AXIS",
    "ShardedMeterServingEngine",
    "ShardedServingEngine",
    "ShardedWaveformEngine",
    "make_mesh",
    "pad_stream_dim",
    "padded_streams",
    "shard_state",
    "stream_axis_size",
]
