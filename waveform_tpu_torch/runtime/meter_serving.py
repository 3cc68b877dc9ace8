"""Device-resident batched level-meter serving.

The PyTorch counterpart of ``waveform_tpu/runtime/meter_serving.py``: the
meter analog of :class:`~.serving.ServingEngine`, S meter streams a tick.
The meter windows live on the device as the same ``[S, C, M]`` ring the
spectrum engine uses — RMS and peak are permutation-invariant, so the
ring push IS the meter window update — and the reduce -> asymmetric EMA ->
dBFS -> gate pipeline is one step (``dsp/meter.py``
``make_meter_serving_step``).

Everything host-side — packet queues, A/V sync, the native C++ assembler,
the packed single upload, the captured graph tick, microbatching,
``tick_many``, ``resized`` and checkpoints — is inherited through the mode
hooks.  The only differences:

* packed meta columns are (counts, fresh, show) instead of
  (counts, show&&fresh, rms): the reference gates timeout and hide
  DIFFERENTLY (timeout zeroes the sample ring, hide only the levels,
  src/source_generic.cpp:184-232), so the step needs both bits
* no RMS-squares block (volume normalization is a spectrum-only gain)
* output per tick is the meter levels ``[S, 1, C]`` dBFS, not pixels
"""

from __future__ import annotations

import torch

from ..core.config import ResolvedConfig
from ..dsp.devring import init_ring, push
from ..dsp.meter import init_meter_state, make_meter_serving_step
from .serving import ServingEngine, assign


class MeterServingEngine(ServingEngine):
    """Batched device-resident meter serving for S streams."""

    _split_meta = True
    # the JAX meter engine stores its ring [S, C, L] (not flat)
    _flat_ring_checkpoint = False

    def _check_mode(self, cfg: ResolvedConfig) -> None:
        if not cfg.meter_mode:
            raise ValueError("MeterServingEngine handles meter mode; use "
                             "ServingEngine for spectrum mode")

    def _wants_rms(self, cfg: ResolvedConfig) -> bool:
        return False   # normalization gain never applies to meter output

    def _init_device_state(self) -> None:
        # the meter window ring: fft_size is repurposed as the meter
        # length in samples (sr*meter_ms/1000, src/source.cpp:1121)
        self._ring = init_ring(self.S, self.C, self.cfg.fft_size, self.device)
        self.state = init_meter_state(self.cfg, self.S, self.device)
        self.rms_ring = None

    def _display_values(self, state):
        return state.meter_val[:, None, :]

    def _build_device_programs(self) -> None:
        step = make_meter_serving_step(self.cfg)
        C, H = self.C, self.H

        def meter_tick(new, counts, ring, state, scalars, fresh, show):
            push(ring, new, counts)
            _, st = step(ring, state, scalars, fresh, show)
            assign(state, st)
            return self._display_values(state).clone()

        def packed_tick(flat, ring, state, scalars, rms_ring=None,
                        ucount=None):
            """One meter tick on the packed rows: push the new samples into
            the device window ring, then reduce + gate on the device.
            ``ucount`` selects the ring's batch shift exactly as in the
            spectrum engine."""
            s = flat.shape[0]
            counts = flat[:, -3].to(torch.int64) if ucount is None else ucount
            return meter_tick(flat[:, :C * H].view(s, C, H), counts, ring,
                              state, scalars, flat[:, -2] > 0.5,
                              flat[:, -1] > 0.5)

        def bulk_tick(new, counts, ring, state, scalars, active, rms,
                      rms_ring=None):
            """One ``tick_many`` meter tick.  The combined ``active`` gate
            stands in for both fresh and show — bulk callers have no live
            capture clock, so an inactive bulk tick behaves as a timeout
            (ring zeroed once, then latched)."""
            return meter_tick(new, counts, ring, state, scalars, active,
                              torch.ones_like(active))

        self._packed_tick = packed_tick
        self._bulk_tick = bulk_tick

    @property
    def meter_values(self) -> torch.Tensor:
        """Latest device meter levels [S, C] dBFS."""
        return self.state.meter_val
