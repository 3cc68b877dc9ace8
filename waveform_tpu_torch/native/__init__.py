"""Native runtime bindings: the C++ multi-stream frame assembler.

The port's own copy of ``waveform_tpu/native``: the same ``assembler.cpp``
and the same ctypes binding.  It builds with g++ on first use into
``build/waveform_tpu_torch/`` at the repository root, named by a hash of
the source and the flags, so the port and the JAX package never share or
overwrite one library.  Falls back cleanly: ``load_library()`` returns
None if no toolchain is available, and callers keep the pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "assembler.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "waveform_tpu_torch")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def build_library(force: bool = False) -> str | None:
    """Compile the native assembler; returns the .so path or None."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + f.read())
    lib = os.path.join(_BUILD, f"libwaveform_{digest.hexdigest()[:16]}.so")
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    base = ["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"]
    for extra in (["-march=native"], []):  # fall back on exotic toolchains
        try:
            subprocess.run(base[:1] + extra + base[1:], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, lib)
            return lib
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                FileNotFoundError):
            continue
    return None


def load_library():
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.wf_create2.restype = ctypes.c_void_p
        lib.wf_create2.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int]
        lib.wf_destroy.argtypes = [ctypes.c_void_p]
        lib.wf_feed.restype = ctypes.c_int
        lib.wf_feed.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_longlong,
                                ctypes.c_int]
        lib.wf_feed_batch.restype = ctypes.c_int
        lib.wf_feed_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int]
        lib.wf_assemble.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.wf_assemble_hop.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.wf_assemble_hop_rms.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.wf_assemble_hop_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
        lib.wf_assemble_hop_packed2.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int]
        lib.wf_set_trim_cap.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.wf_assemble_waveform.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int]
        lib.wf_get_wf_state.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.wf_set_wf_state.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_longlong]
        lib.wf_set_show.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.wf_detach.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.wf_get_sync.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int)]
        lib.wf_set_sync.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_int]
        lib.wf_ring_size.restype = ctypes.c_longlong
        lib.wf_ring_size.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
        _lib = lib
        return _lib


class NativeAssembler:
    """ctypes wrapper over the C++ engine; one instance per stream batch."""

    def __init__(self, num_streams: int, channels: int, window: int,
                 sample_rate: int, ts_offset_ns: int = 0,
                 prefill: bool = True, rms: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native assembler unavailable (g++ missing "
                               "or build failed)")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.wf_create2(
            num_streams, channels, window, sample_rate, ts_offset_ns,
            1 if prefill else 0, 1 if rms else 0))
        self.S, self.C, self.W = num_streams, channels, window

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wf_destroy(h)
            self._h = None

    def feed(self, stream: int, data: np.ndarray | None, timestamp_ns: int,
             now_ns: int, muted: bool = False) -> bool:
        if data is None:
            return bool(self._lib.wf_feed(self._h, stream, None, 0,
                                          timestamp_ns, now_ns, 1))
        data = np.ascontiguousarray(data, np.float32)
        if data.shape[0] < self.C:
            # zero-fill missing channels (the reference nullptr-checks
            # audio->data[i] per channel, src/source.cpp:1878-1881)
            pad = np.zeros((self.C - data.shape[0], data.shape[-1]),
                           np.float32)
            data = np.ascontiguousarray(np.vstack([data, pad]))
        return bool(self._lib.wf_feed(
            self._h, stream, data.ctypes.data_as(ctypes.c_void_p),
            data.shape[-1], timestamp_ns, now_ns, 1 if muted else 0))

    def feed_batch(self, data: np.ndarray, timestamp_ns: int, now_ns: int,
                   muted: bool = False) -> int:
        data = np.ascontiguousarray(data, np.float32)
        assert data.shape[:2] == (self.S, self.C)
        return self._lib.wf_feed_batch(
            self._h, data.ctypes.data_as(ctypes.c_void_p), data.shape[-1],
            timestamp_ns, now_ns, 1 if muted else 0)

    def assemble(self, now_ns: int, out: np.ndarray | None = None):
        """Full windows: returns (frames [S,C,W], valid [S,C], active [S])."""
        if out is None:
            out = np.empty((self.S, self.C, self.W), np.float32)
        valid = np.empty((self.S, self.C), np.uint8)
        active = np.empty(self.S, np.uint8)
        self._lib.wf_assemble(self._h, now_ns,
                              out.ctypes.data_as(ctypes.c_void_p),
                              valid.ctypes.data_as(ctypes.c_void_p),
                              active.ctypes.data_as(ctypes.c_void_p))
        return out, valid.astype(bool), active.astype(bool)

    def assemble_hop(self, now_ns: int, hop_budget: int,
                     out: np.ndarray | None = None):
        """Serving mode: (new [S,C,H], counts [S], active [S])."""
        H = hop_budget
        if out is None:
            out = np.empty((self.S, self.C, H), np.float32)
        counts = np.empty(self.S, np.int32)
        active = np.empty(self.S, np.uint8)
        self._lib.wf_assemble_hop(self._h, now_ns, H,
                                  out.ctypes.data_as(ctypes.c_void_p),
                                  counts.ctypes.data_as(ctypes.c_void_p),
                                  active.ctypes.data_as(ctypes.c_void_p))
        return out, counts, active.astype(bool)

    def assemble_hop_rms(self, now_ns: int, hop_budget: int,
                         out: np.ndarray | None = None,
                         rms_out: np.ndarray | None = None):
        """Serving mode + raw-squares drain: (new, rms_sq [S,H], counts,
        active). Engine must be created with rms=True."""
        H = hop_budget
        if out is None:
            out = np.empty((self.S, self.C, H), np.float32)
        if rms_out is None:
            rms_out = np.empty((self.S, H), np.float32)
        counts = np.empty(self.S, np.int32)
        active = np.empty(self.S, np.uint8)
        self._lib.wf_assemble_hop_rms(
            self._h, now_ns, H, out.ctypes.data_as(ctypes.c_void_p),
            rms_out.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p),
            active.ctypes.data_as(ctypes.c_void_p))
        return out, rms_out, counts, active.astype(bool)

    def assemble_hop_packed(self, now_ns: int, hop_budget: int,
                            flat: np.ndarray, with_rms: bool,
                            split_active: bool = False) -> None:
        """Assemble directly into the packed single-upload buffer
        (serving.py _in_buf): per-stream row of C*H samples, H raw RMS
        squares, then counts/active as floats.  ``split_active=True``
        writes (counts, fresh, show) instead of (counts, show&&fresh) —
        the meter-serving meta layout.  ``flat`` must be a C-contiguous
        [S, row_stride] float32 array."""
        assert flat.flags.c_contiguous and flat.dtype == np.float32
        self._lib.wf_assemble_hop_packed2(
            self._h, now_ns, hop_budget,
            flat.ctypes.data_as(ctypes.c_void_p), flat.shape[1],
            1 if with_rms else 0, 1 if split_active else 0)

    def set_trim_cap(self, cap: int) -> None:
        """Switch the feed-side queue trim to waveform mode: keep the
        newest ``cap`` samples flat (the device ring's capacity) instead
        of the spectrum-mode sync-reserve + window rule."""
        self._lib.wf_set_trim_cap(self._h, cap)

    def assemble_waveform(self, now_ns: int, hop_budget: int, width: int,
                          step_ns: int, wf_window: int, ring_cap: int,
                          reserve_limit: int, flat: np.ndarray,
                          with_rms: bool) -> None:
        """Waveform-mode packed assembly (the DeviceWaveformEngine row
        layout: C*H samples, H RMS squares when ``with_rms``, W gather
        indices, 5 meta columns).  ``flat`` must be a C-contiguous
        [S, row_stride] float32 array."""
        assert flat.flags.c_contiguous and flat.dtype == np.float32
        self._lib.wf_assemble_waveform(
            self._h, now_ns, hop_budget, width, step_ns, wf_window,
            ring_cap, reserve_limit,
            flat.ctypes.data_as(ctypes.c_void_p), flat.shape[1],
            1 if with_rms else 0)

    def get_wf_state(self, stream: int) -> tuple[int, int]:
        """(waveform_ts, total) — the waveform scroll state, for live-
        resize migration alongside :meth:`get_sync`."""
        wts = ctypes.c_longlong()
        tot = ctypes.c_longlong()
        self._lib.wf_get_wf_state(self._h, stream, ctypes.byref(wts),
                                  ctypes.byref(tot))
        return int(wts.value), int(tot.value)

    def set_wf_state(self, stream: int, waveform_ts: int,
                     total: int) -> None:
        self._lib.wf_set_wf_state(self._h, stream, waveform_ts, total)

    def set_show(self, stream: int, show: bool) -> None:
        self._lib.wf_set_show(self._h, stream, 1 if show else 0)

    def get_sync(self, stream: int) -> tuple[int, int, bool]:
        """(capture_ts, audio_ts, show) — for live-resize migration."""
        ct = ctypes.c_longlong()
        at = ctypes.c_longlong()
        sh = ctypes.c_int()
        self._lib.wf_get_sync(self._h, stream, ctypes.byref(ct),
                              ctypes.byref(at), ctypes.byref(sh))
        return int(ct.value), int(at.value), bool(sh.value)

    def set_sync(self, stream: int, capture_ts: int, audio_ts: int,
                 show: bool) -> None:
        self._lib.wf_set_sync(self._h, stream, capture_ts, audio_ts,
                              1 if show else 0)

    def detach(self, stream: int) -> None:
        self._lib.wf_detach(self._h, stream)

    def ring_size(self, stream: int, channel: int = 0) -> int:
        return int(self._lib.wf_ring_size(self._h, stream, channel))
