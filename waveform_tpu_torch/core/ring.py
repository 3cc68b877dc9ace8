"""Host-side sample ring buffer with the reference's exact pop/peek semantics.

The reference buffers raw audio bytes in a byte-granular ring
(reference src/circular_buffer.hpp) that the audio thread pushes into
and the tick pops-to-sync-point then *peeks* (not drains) ``fft_size``
samples from — overlapping hop windows come free
(src/source_avx2.cpp:56-62).  This Python implementation is sample-granular
(the plugin only ever moves whole float32 samples) and is the reference
fallback for the C++ engine in ``waveform_tpu_torch/native`` which assembles
hundreds of stream rings per tick.

Capacity grows in 1 KiB-equivalent (256-sample) steps, mirroring the
reference's conservative growth (circular_buffer.hpp:29-41).

The port's own copy of ``waveform_tpu/core/ring.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

_GROW_STEP = 256  # samples; the byte ring grows in 1024-byte steps


class SampleRing:
    """Single-stream, single-channel float32 ring."""

    __slots__ = ("_data", "_pos", "_used")

    def __init__(self, capacity: int = 1024):
        self._data = np.zeros(max(int(capacity), _GROW_STEP), np.float32)
        self._pos = 0
        self._used = 0

    def reset(self) -> None:
        self._pos = 0
        self._used = 0

    @property
    def size(self) -> int:
        """Samples currently buffered."""
        return self._used

    def _reserve(self, size: int) -> None:
        if len(self._data) >= size:
            return
        # compact so the readable region starts at 0, then grow
        new_size = (size + _GROW_STEP) & ~(_GROW_STEP - 1)
        new = np.zeros(new_size, np.float32)
        n = self._used
        first = min(n, len(self._data) - self._pos)
        new[:first] = self._data[self._pos:self._pos + first]
        new[first:n] = self._data[:n - first]
        self._data = new
        self._pos = 0

    def push_back(self, src: np.ndarray) -> None:
        src = np.asarray(src, np.float32).ravel()
        n = len(src)
        if n == 0:
            return
        self._reserve(self._used + n)
        cap = len(self._data)
        w = (self._pos + self._used) % cap
        first = min(n, cap - w)
        self._data[w:w + first] = src[:first]
        self._data[:n - first] = src[first:]
        self._used += n

    def push_back_zero(self, n: int) -> None:
        if n <= 0:
            return
        self._reserve(self._used + n)
        cap = len(self._data)
        w = (self._pos + self._used) % cap
        first = min(n, cap - w)
        self._data[w:w + first] = 0.0
        self._data[:n - first] = 0.0
        self._used += n

    def pop_front(self, n: int, out: np.ndarray | None = None) -> int:
        """Drop (or copy out) up to n samples from the front; returns count."""
        n = min(int(n), self._used)
        if n <= 0:
            return 0
        if out is not None:
            self._peek_into(out, n)
        cap = len(self._data)
        self._pos = (self._pos + n) % cap
        self._used -= n
        return n

    def peek_front(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """Copy up to n front samples without consuming."""
        n = min(int(n), self._used)
        if out is None:
            out = np.empty(n, np.float32)
        self._peek_into(out, n)
        return out

    def _peek_into(self, out: np.ndarray, n: int) -> None:
        cap = len(self._data)
        first = min(n, cap - self._pos)
        out[:first] = self._data[self._pos:self._pos + first]
        if n > first:
            out[first:n] = self._data[:n - first]


def ns_to_audio_frames(samples_per_sec: int, ns: int) -> int:
    """util_mul_div64(ns, rate, 1e9) — OBS's conversion helper."""
    return (int(ns) * int(samples_per_sec)) // 1_000_000_000


def audio_frames_to_ns(samples_per_sec: int, frames: int) -> int:
    return (int(frames) * 1_000_000_000) // int(samples_per_sec)
