"""Batched level-meter mode.

The PyTorch counterpart of ``waveform_tpu/dsp/meter.py``.  The reference
repurposes ``m_decibels`` as a raw sample ring of ``sr·meter_ms/1000``
samples and reduces it to one RMS or peak level per channel with
asymmetric EMA smoothing (reference src/source_generic.cpp:182-269).
Here the per-stream sample windows live in one ``[S, C, M]`` tensor and
the whole reduction, smoothing and dBFS run as one batched step.

``dt`` is seconds (a Python float) or the [2] f32 :func:`~.spectrum.
gravity_pair` tensor on the device, as in the spectrum step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.config import DB_MIN, ResolvedConfig, check_config
from ..core.device import checked_device
from ..core.enums import TSmoothingMode
from .devring import DeviceRing
from .spectrum import dbfs, gravity_terms


@dataclass
class MeterState:
    """Per-stream carried meter state."""

    meter_buf: torch.Tensor    # [S, C] f32 — EMA accumulator (linear)
    meter_val: torch.Tensor    # [S, C] f32 — output level (dBFS)
    last_silent: torch.Tensor  # [S] bool


def init_meter_state(cfg: ResolvedConfig, num_streams: int,
                     device: torch.device | str = "cuda") -> MeterState:
    """A fresh meter state on ``device`` (the card unless the caller asks
    for the CPU; raises RuntimeError without one)."""
    check_config(cfg)
    device = checked_device(device, "init_meter_state")
    C = max(cfg.capture_channels, 1)
    return MeterState(
        # the EMA accumulator is LINEAR and starts at zero
        # (src/source.hpp:128 `m_meter_buf[2] = {0.0f, 0.0f}`); only the
        # dBFS output starts at the floor
        meter_buf=torch.zeros((num_streams, C), dtype=torch.float32,
                              device=device),
        meter_val=torch.full((num_streams, C), DB_MIN, dtype=torch.float32,
                             device=device),
        last_silent=torch.zeros(num_streams, dtype=torch.bool, device=device),
    )


def _level(cfg: ResolvedConfig, window: torch.Tensor, state: MeterState,
           dt) -> torch.Tensor:
    """RMS or peak of ``window`` [S, C, M] per channel, through the
    asymmetric-fast-peak EMA (src/source_generic.cpp:240-262)."""
    M = cfg.fft_size  # ring length in samples (repurposed, src/source.cpp:1121)
    if cfg.meter_rms:
        out = torch.sqrt(torch.sum(window * window, dim=-1) / M)
    else:
        out = torch.amax(torch.abs(window), dim=-1)
    if cfg.tsmoothing != TSmoothingMode.NONE:
        g, g2 = gravity_terms(cfg, dt)
        blended = g * state.meter_buf + g2 * out
        if cfg.fast_peaks:
            # rising values bypass the EMA (src/source_generic.cpp:256-257)
            out = torch.where(out > state.meter_buf, out, blended)
        else:
            out = blended
    return out


def make_meter_step(cfg: ResolvedConfig):
    """Build ``step(window, state, dt, fresh, show, run=None) ->
    MeterState``.

    * ``window`` [S, C, M] f32 — the meter sample rings (order-independent:
      RMS and peak are permutation-invariant)
    * ``fresh``  [S] bool — capture younger than the 500 ms timeout
    * ``show``   [S] bool — source visible
    * ``run``    [S] bool — streams whose host tick ran (default all)

    Timeout semantics (src/source_generic.cpp:184-199): the *host* zeroes the
    ring for streams where ``~fresh & ~last_silent``; this step handles the
    level/latch updates for all gates.
    """
    check_config(cfg)
    floor_gate = float(cfg.floor - 10)

    def step(window: torch.Tensor, state: MeterState, dt,
             fresh: torch.Tensor, show: torch.Tensor,
             run: torch.Tensor | None = None) -> MeterState:
        new_buf = _level(cfg, window, state, dt)
        new_val = dbfs(new_buf)
        new_silent = torch.sum(new_val < floor_gate, dim=-1) >= max(
            cfg.capture_channels, 1)

        # gates: timeout (~fresh) or hidden (~show) -> zero levels + latch
        gated = ~(fresh & show)
        keep = (~fresh) & state.last_silent      # early return: frozen
        buf = torch.where(keep[:, None], state.meter_buf,
                          torch.where(gated[:, None],
                                      torch.zeros_like(new_buf), new_buf))
        val = torch.where(keep[:, None], state.meter_val,
                          torch.where(gated[:, None],
                                      torch.full_like(new_val, DB_MIN),
                                      new_val))
        silent = torch.where(keep, state.last_silent,
                             torch.where(gated, torch.ones_like(gated),
                                         new_silent))
        if run is not None:
            # streams whose host tick never ran freeze verbatim
            buf = torch.where(run[:, None], buf, state.meter_buf)
            val = torch.where(run[:, None], val, state.meter_val)
            silent = torch.where(run, silent, state.last_silent)
        return MeterState(meter_buf=buf, meter_val=val, last_silent=silent)

    return step


def make_meter_serving_step(cfg: ResolvedConfig):
    """Device-resident serving variant: every gate INCLUDING the timeout
    ring-zeroing runs on the device, so a tick keeps no host state.

    Builds ``step(ring, state, dt, fresh, show) -> (ring, state)`` matching
    the reference tick_meter (src/source_generic.cpp:182-269):

    * timeout + already latched -> early return: everything frozen
    * timeout + not latched     -> sample ring zeroed, levels zeroed,
      value DB_MIN, silence latched (the m_decibels memset, :184-199)
    * hidden (fresh, !show)     -> levels zeroed/latched but the ring KEEPS
      its drained samples (:225-232 — the drain runs before the show gate)
    * live                      -> RMS/peak over the ring, asymmetric-fast-
      peak EMA, dBFS, latch when every channel is under floor-10 dB

    The ring is zeroed in place (the JAX step returns a new ring) and the
    same ring is returned.  One accepted divergence from the reference,
    inherited from serving's push-then-step order (as in the JAX step):
    samples still queued at the timeout instant are pushed and then zeroed
    with the ring.
    """
    check_config(cfg)
    floor_gate = float(cfg.floor - 10)
    C = max(cfg.capture_channels, 1)

    def step(ring: DeviceRing, state: MeterState, dt, fresh: torch.Tensor,
             show: torch.Tensor) -> tuple[DeviceRing, MeterState]:
        out = _level(cfg, ring.buf, state, dt)
        new_val = dbfs(out)
        new_silent = torch.sum(new_val < floor_gate, dim=-1) >= C

        timeout = ~fresh
        frozen = timeout & state.last_silent   # early return (:187-188)
        gated = timeout | ~show                # zero levels + latch
        zero_ring = timeout & ~state.last_silent  # first timeout tick only

        buf = torch.where(frozen[:, None], state.meter_buf,
                          torch.where(gated[:, None],
                                      torch.zeros_like(out), out))
        val = torch.where(frozen[:, None], state.meter_val,
                          torch.where(gated[:, None],
                                      torch.full_like(new_val, DB_MIN),
                                      new_val))
        silent = torch.where(frozen, state.last_silent, gated | new_silent)
        ring.buf.masked_fill_(zero_ring[:, None, None], 0.0)
        return ring, MeterState(meter_buf=buf, meter_val=val,
                                last_silent=silent)

    return step
