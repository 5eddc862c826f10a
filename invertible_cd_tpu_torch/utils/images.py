"""PNG encoding with the standard library only, and image grids.

The HTTP server (`cli/serve.py`) answers each request with a PNG, and the
training log writes its panels as PNGs (`utils.logging`). The JAX
package writes them through PIL; this encoder needs only `zlib` and
`struct`, so neither depends on an imaging package. It writes 8-bit RGB,
no interlace, every row under filter 0 (none).

`image_grid`, `to_pil_images` and `view_images` are the port's copies of
`invertible_cd_tpu/utils/images.py` (reference `utils/generation.py:
569-626`); PIL is imported only by the two that make a PIL image.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Union

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


def image_grid(images: Union[np.ndarray, Sequence[np.ndarray]], num_rows: int = 1,
               offset_ratio: float = 0.02) -> np.ndarray:
    """Tile images into one (grid_h, grid_w, 3) uint8 array (JAX :22).

    Takes one (H, W, 3) image, an (N, H, W, 3) stack or a list of equal-shape
    images; floats in [0, 1] are rescaled (truncated to uint8). A ragged last
    row is padded with white tiles to a full rectangle; the gutter is
    `int(H * offset_ratio)` white pixels."""
    if isinstance(images, np.ndarray) and images.ndim == 3:
        imgs: List[np.ndarray] = [images]
    else:
        imgs = [np.asarray(im) for im in images]
    if not imgs:
        raise ValueError("image_grid needs at least one image")
    imgs = [(im if im.dtype == np.uint8 else np.clip(np.asarray(im, np.float32) * 255.0, 0, 255))
            .astype(np.uint8) for im in imgs]
    num_empty = len(imgs) % num_rows
    if num_empty:
        imgs = imgs + [np.full_like(imgs[0], 255)] * (num_rows - num_empty)
    h, w, _ = imgs[0].shape
    offset = int(h * offset_ratio)
    num_cols = len(imgs) // num_rows
    grid = np.full((h * num_rows + offset * (num_rows - 1),
                    w * num_cols + offset * (num_cols - 1), 3), 255, np.uint8)
    for i in range(num_rows):
        for j in range(num_cols):
            grid[i * (h + offset): i * (h + offset) + h,
                 j * (w + offset): j * (w + offset) + w] = imgs[i * num_cols + j]
    return grid


def to_pil_images(images, num_rows: int = 1, offset_ratio: float = 0.02):
    """The grid as a PIL image (JAX :68, reference `to_pil_images`)."""
    from PIL import Image

    return Image.fromarray(image_grid(images, num_rows, offset_ratio))


def view_images(images, num_rows: int = 1, offset_ratio: float = 0.02,
                save_path: Optional[str] = None):
    """Reference `view_images` (JAX :79): the grid written to `save_path`,
    or shown in PIL's viewer without one. Returns the PIL image."""
    pil = to_pil_images(images, num_rows, offset_ratio)
    if save_path is not None:
        pil.save(save_path)
    else:  # needs a display
        pil.show()
    return pil
