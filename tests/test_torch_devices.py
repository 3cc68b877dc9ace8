"""The port's public builders place their tensors on the card by default.

The JAX package's builders put their arrays on JAX's default device, the
accelerator; the port's counterparts default to ``device="cuda"`` and, on
a machine without a CUDA device, raise RuntimeError naming themselves
rather than carry on on the CPU (as ``ServingEngine`` does).  A caller
that wants the CPU passes ``device="cpu"``, as the other CPU tests do.
"""

import dataclasses

import numpy as np
import pytest
import torch

import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp import devring, meter, spectrum
from waveform_tpu_torch.rebin import apply
from waveform_tpu_torch.runtime.engine import WaveformEngine
from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
from waveform_tpu_torch.runtime.waveform_device import DeviceWaveformEngine

S, C, L = 2, 2, 64


def _cfg():
    return wt.resolve(wt.Settings(fft_size=1024, width=200,
                                  window=wt.FFTWindow.HANN),
                      wt.AudioInfo(48000, C))


def _meter_cfg():
    return wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER),
                      wt.AudioInfo(48000, C))


def _waveform_cfg():
    return wt.resolve(wt.Settings(display_mode=wt.DisplayMode.WAVEFORM,
                                  width=200),
                      wt.AudioInfo(48000, C))


def _tensors(built):
    """The tensors a builder's result holds (a rebin or step function is
    probed by its closure)."""
    if isinstance(built, torch.Tensor):
        return [built]
    if isinstance(built, (tuple, list)):
        return [t for b in built for t in _tensors(b)]
    if dataclasses.is_dataclass(built):
        return _tensors([getattr(built, f.name)
                         for f in dataclasses.fields(built)])
    if callable(built) and getattr(built, "__closure__", None):
        # a cell stays empty for a name the builder never bound
        return _tensors([c.cell_contents for c in built.__closure__
                         if c != type(c)()])
    return []


BUILDERS = {
    "init_state": lambda cfg: spectrum.init_state(cfg, S),
    "state_from_numpy": lambda cfg: spectrum.state_from_numpy(
        np.zeros((S, C, 512)), np.zeros((S, C, 512)), np.zeros(S, bool)),
    "window_pair": lambda cfg: spectrum.window_pair(cfg),
    "make_spectrum_step": lambda cfg: spectrum.make_spectrum_step(cfg),
    "init_ring": lambda cfg: devring.init_ring(S, C, L),
    "ring_from_numpy": lambda cfg: devring.ring_from_numpy(
        np.zeros((S, C, L))),
    "make_rebin_fn": lambda cfg: apply.make_rebin_fn(cfg),
    "init_meter_state": lambda cfg: meter.init_meter_state(_meter_cfg(), S),
    "MeterServingEngine": lambda cfg: MeterServingEngine(
        _meter_cfg(), S).state,
    "DeviceWaveformEngine": lambda cfg: (
        lambda e: (e.ring, e.buf, e.latch))(
            DeviceWaveformEngine(_waveform_cfg(), S)),
    "WaveformEngine": lambda cfg: WaveformEngine(cfg, S).state,
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_defaults_to_the_card(name):
    """Called without ``device=``: on a machine without a CUDA device the
    builder raises RuntimeError naming itself; with one, every tensor it
    builds lies on the card."""
    cfg = _cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=f"{name}.*CUDA"):
            BUILDERS[name](cfg)
        return
    tensors = _tensors(BUILDERS[name](cfg))
    assert tensors and all(t.device.type == "cuda" for t in tensors)
