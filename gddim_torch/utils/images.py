"""Sample grids as PNG files (counterpart of ``gddim_tpu/utils/images.py``).

The PNG is written here with zlib and struct: 8-bit grayscale or RGB, one
IDAT chunk, every row with filter 0.
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """(N, H, W, C) in [0, 1] -> one (H', W', C) grid, ``nrow`` images a row."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    grid = np.full((nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
                   pad_value, dtype=np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y: y + h, x: x + w] = images[idx]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1 | 3) uint8 -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes (H, W), (H, W, 1) or (H, W, 3), not {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def save_image(images: np.ndarray, path: str | Path, nrow: int = 8):
    """Write (N, H, W, C) images in [0, 1] as one PNG grid."""
    grid = make_grid(np.clip(images, 0.0, 1.0), nrow=nrow)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png((grid * 255).astype(np.uint8)))
