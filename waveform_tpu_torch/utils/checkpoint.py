"""Checkpoint/resume of engine state.

The PyTorch counterpart of ``waveform_tpu/utils/checkpoint.py``, and the
same file: one ``.npz`` with the state's array leaves as ``leaf_0``,
``leaf_1``, ... and a ``__treedef__`` string, so each package loads the
other's checkpoints.  A state tree is walked as the JAX package's
``jax.tree.flatten`` walks its pytrees: tuples and lists in order, a state
dataclass field by field in declaration order, a :class:`DeviceRing` as
its one buffer, ``None`` as no leaf.

The port's rings are always ``[S, C, L]``.  The JAX spectrum engine stores
its sample and RMS rings flat, ``[S*C, L]`` (``DeviceRing.channels``), and
its meter engine ``[S, C, L]``: :func:`save_pytree` writes a ring flat
when asked (``flat_rings``), and :func:`load_pytree` reads either layout.

``load_pytree``'s optional ``keep`` performs the stream-row migration:
checkpoint row ``keep[i]`` lands in row ``i``, rows beyond ``len(keep)``
keep ``like``'s values.  The JAX module's multi-host gather is not ported
(every leaf here lives on one device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dsp.devring import DeviceRing


def _nodes(tree) -> list:
    """The leaf nodes of ``tree`` in the JAX package's flatten order: each
    tensor leaf, or the :class:`DeviceRing` that owns a ring buffer."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [n for t in tree for n in _nodes(t)]
    if isinstance(tree, DeviceRing):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [n for f in dataclasses.fields(tree)
                for n in _nodes(getattr(tree, f.name))]
    if isinstance(tree, torch.Tensor):
        return [tree]
    raise TypeError(f"checkpoint: unsupported node {type(tree).__name__}")


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    if isinstance(tree, DeviceRing):
        return DeviceRing(buf=next(leaves))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), leaves)
                             for f in dataclasses.fields(tree)})
    return next(leaves)


def _treedef(tree) -> str:
    """A readable description of the structure (the file's
    ``__treedef__``; no loader reads it)."""
    if tree is None:
        return "None"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_treedef(t) for t in tree) + ")"
    if isinstance(tree, DeviceRing):
        return "DeviceRing[*]"
    if dataclasses.is_dataclass(tree):
        return (f"{type(tree).__name__}["
                + ", ".join(_treedef(getattr(tree, f.name))
                            for f in dataclasses.fields(tree)) + "]")
    return "*"


def to_host(x) -> np.ndarray:
    """Leaf -> host numpy array."""
    if isinstance(x, DeviceRing):
        x = x.buf
    return x.detach().cpu().numpy()


def save_pytree(path: str, tree, flat_rings: bool = False) -> None:
    """Write ``tree``'s leaves to ``path`` (``.npz``).  ``flat_rings``
    writes each ring ``[S*C, L]``, as the JAX spectrum engine stores its
    rings; otherwise ``[S, C, L]``, as its meter engine does."""
    arrays = {}
    for i, node in enumerate(_nodes(tree)):
        arr = to_host(node)
        if isinstance(node, DeviceRing) and flat_rings:
            arr = arr.reshape(-1, arr.shape[-1])
        arrays[f"leaf_{i}"] = arr
    np.savez_compressed(path, __treedef__=_treedef(tree), **arrays)


def _ring_rows(i: int, arr: np.ndarray, ref_shape: tuple) -> np.ndarray:
    """A ring leaf of a checkpoint as ``[S', C, L]`` for a ring of
    ``ref_shape`` [S, C, L]: the flat ``[S'*C, L]`` form reshaped at the
    ring's channel count, the ``[S', C, L]`` form as it is."""
    _, c, L = ref_shape
    if arr.ndim == 2:
        if arr.shape[0] % c or arr.shape[1] != L:
            raise ValueError(
                f"checkpoint leaf {i} {arr.shape} incompatible with ring "
                f"{ref_shape} (channels={c}) for row migration")
        return arr.reshape(-1, c, L)
    return arr


def load_pytree(path: str, like, keep: list[int] | None = None):
    """Load into the structure of ``like``: the same structure, each leaf
    a tensor of its ``like`` leaf's dtype on its device.

    With ``keep=None`` shapes must match, a ring's in either layout (flat
    ``[S*C, L]`` with S*C rows, or ``[S, C, L]`` with the ring's own
    channel count: a mono 8-stream ring must not load into a stereo
    4-stream engine).  With ``keep`` the checkpoint may carry a DIFFERENT
    stream count: every leaf's leading axis is per-stream (per
    (stream, channel) for flat rings, migrated at stream granularity),
    new row ``i`` receives checkpoint row ``keep[i]``, and rows past
    ``len(keep)`` retain ``like``'s values.
    """
    data = np.load(path, allow_pickle=False)
    loaded = []
    for i, node in enumerate(_nodes(like)):
        ref = node.buf if isinstance(node, DeviceRing) else node
        ref_shape = tuple(ref.shape)
        arr = data[f"leaf_{i}"]
        if keep is not None:
            if isinstance(node, DeviceRing):
                arr = _ring_rows(i, arr, ref_shape)
            if arr.shape[1:] != ref_shape[1:]:
                raise ValueError(
                    f"checkpoint leaf {i} trailing shape {arr.shape} != "
                    f"expected {ref_shape}; row migration only remaps "
                    "the stream axis — was the config changed?")
            if any(not 0 <= j < arr.shape[0] for j in keep):
                raise ValueError(f"keep indices out of range for "
                                 f"checkpoint streams={arr.shape[0]}")
            base = to_host(ref).copy()
            base[:len(keep)] = arr[keep]
            arr = base
        elif arr.shape != ref_shape:
            if (isinstance(node, DeviceRing) and arr.ndim == 2
                    and arr.shape[0] == ref_shape[0] * ref_shape[1]
                    and arr.shape[1] == ref_shape[2]):
                # the JAX spectrum engine's flat [S*C, L] ring: the
                # row-major reshape is exactly its flatten
                arr = arr.reshape(ref_shape)
            else:
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != expected "
                    f"{ref_shape}; was the config or stream count changed?")
        loaded.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(loaded))
