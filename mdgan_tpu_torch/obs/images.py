"""Image-grid writing.

Copy of ``mdgan_tpu/obs/images.py:1-80`` (the module imports no JAX).

Rebuilds the reference's sample-grid channel (``make_grid`` + PNG save every
``log_interval`` — reference ``src/actors/server.py:141-149, 336-352``,
``standalone_gan.py:248-254``): tile images into a grid, save as PNG.

Uses PIL when available, else a minimal pure-python PNG writer (zlib +
struct — no native deps), so grids work in any environment.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 4, padding: int = 0) -> np.ndarray:
    """Tile (n, H, W, C) images in [0, 1] into one (GH, GW, C) array.

    Matches torchvision ``make_grid(nrow=4, padding=0)`` semantics used by the
    reference (``server.py:141-143, 344-345``): `nrow` is images per row.
    """
    imgs = np.clip(np.asarray(images, np.float32), 0.0, 1.0)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = imgs[i]
    return grid


def _write_png(path: Path, arr: np.ndarray) -> None:
    """Minimal PNG encoder for uint8 grayscale/RGB arrays."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    color_type = {1: 0, 3: 2}[c]
    raw = arr.reshape(h, w * c)
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(scanlines, 6)) + chunk(b"IEND", b""))
    path.write_bytes(png)


def save_image_grid(images: np.ndarray, path, nrow: int = 4) -> None:
    """Save (n, H, W, C) images in [0, 1] as a PNG grid."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    grid = (make_grid(images, nrow=nrow) * 255).round().astype(np.uint8)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    try:
        from PIL import Image

        Image.fromarray(grid).save(path)
    except ImportError:
        _write_png(path, grid)


def load_png(path) -> np.ndarray:
    """Read a PNG back (testing aid)."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path))
    except ImportError:
        raise NotImplementedError("PNG reading requires PIL")
