"""The device a builder places its tensors on.

The port's builders default to the card, as the JAX package's put their
arrays on its default device, the accelerator; a caller that wants the
CPU says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def checked_device(device: torch.device | str, who: str) -> torch.device:
    """``device`` as a ``torch.device``.  Raises RuntimeError naming
    ``who`` when it is a CUDA device and none is available, rather than
    carrying on elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda') needs a CUDA device and "
                           "none is available")
    return dev


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 when none is
    initialized): the port's ``jax.process_count()``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 when none
    is initialized): the port's ``jax.process_index()``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
