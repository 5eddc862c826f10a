"""PNG encoding with the standard library only.

The HTTP server (`cli/serve.py`) answers each request with a PNG. The JAX
package's server writes it through PIL; this encoder needs only `zlib` and
`struct`, so serving depends on no imaging package. It writes 8-bit RGB,
no interlace, every row under filter 0 (none).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """An (H, W, 3) uint8 RGB image as the bytes of a PNG file."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row: filter type 0, then its RGB bytes
    rows[:, 1:] = image.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit depth, colour type 2 (RGB)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
