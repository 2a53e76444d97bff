"""Host-side framebuffer output (replaces Image.cpp + FreeImage).

The reference writes binary PPM (P6) flipped vertically
(Image.cpp:98-115); we support PPM for bit-parity plus 8-bit RGB PNG,
both written with numpy and the standard library alone.
Row 0 of the in-memory buffer is the BOTTOM scanline (eyeRay's v axis
grows upward, Camera.cpp:158), matching the reference's Image layout.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    """rgb8: (H, W, 3) uint8, bottom-up rows. PPM stores top-down."""
    rgb8 = np.asarray(rgb8, np.uint8)
    h, w = rgb8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb8[::-1]).tobytes())


def write_png(path: str, rgb8: np.ndarray) -> None:
    """rgb8: (H, W, 3) uint8, bottom-up rows; PNG stores top-down."""
    rgb8 = np.ascontiguousarray(np.asarray(rgb8, np.uint8)[::-1])
    h, w = rgb8.shape[:2]
    # filter type 0 (none) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb8.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_image(path: str, rgb8: np.ndarray) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, rgb8)
    else:
        write_png(path, rgb8)
