"""The ``serving`` adapter held to the float64 PyTorch reference: the
same engine (``ServingEngine``), feed and tick, with what the checked
ticks should hold computed by ``reference/spectrum_torch.py`` on the
run's own device, a block of streams at a time.  A look of hundreds of
streams at a large FFT is computed on the card in seconds, where the
NumPy reference would take the host minutes.

:func:`control_pixels` is the same reference one step below the
configuration's precision: float32 throughout, the rebin's product on
operands rounded to TF32 (``wfbench/control.py``'s ``tf32``), as a product
on the tensor cores with ``allow_tf32`` would round them.
"""

from __future__ import annotations

import numpy as np
import torch

from wfbench.control import tf32
from wfbench.engines.serving import Adapter as ServingAdapter
from wfbench.reference import spectrum_torch as reference


class Adapter(ServingAdapter):
    def __init__(self, deployment: dict, device: torch.device):
        super().__init__(deployment, device)
        self.look = reference.Look(deployment["settings"],
                                   deployment["audio"], deployment["fps"])

    def expected(self, traffic, ticks: list[int], history: int) -> np.ndarray:
        """What ticks ``ticks`` should have returned: [len(ticks), S, D,
        width] float64, computed in float64 on the run's device."""
        return reference.expected_pixels(
            self.look, traffic.ends, traffic.frames, traffic.first_tick,
            ticks, history, device=self.device)


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on operands rounded to TF32, accumulated in float32."""
    return tf32(a) @ tf32(b)


def control_pixels(look: reference.Look, traffic, ticks: list[int],
                   history: int, device) -> np.ndarray:
    """The pixels of ``ticks`` as the reference computes them in float32
    with the rebin's product in TF32: [len(ticks), S, D, width]."""
    return reference.expected_pixels(
        look, traffic.ends, traffic.frames, traffic.first_tick, ticks,
        history, device=device, dtype=torch.float32, product=tf32_product)
