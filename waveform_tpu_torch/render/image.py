"""Tiny PNG writer (stdlib-only) for saving rendered frames.

The reference hands frames to OBS's compositor; outside OBS the natural
sink is a file.  No imaging deps in this environment, so encode PNG
directly with zlib (RGBA8, no filtering).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_rgba8(img: np.ndarray) -> np.ndarray:
    """float RGBA [H, W, 4] in 0..1 → uint8."""
    img = np.asarray(img)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 4] float (0..1) or uint8 RGBA image as PNG."""
    rgba = img if img.dtype == np.uint8 else to_rgba8(img)
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
