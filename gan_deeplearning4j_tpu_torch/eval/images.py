"""Latent-manifold image rendering — counterpart of
``gan_deeplearning4j_tpu/eval/images.py`` (numpy only).

The reference notebook tiles the 100 decoded z-grid digits into a 280×280
image, ``DCGAN_Generated_Images.png``. This module writes that artifact
with a dependency-free PNG encoder (stdlib zlib)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tile_images(images: np.ndarray, grid: int) -> np.ndarray:
    """(grid², H, W[, C]) → one (grid·H, grid·W[, C]) mosaic, row-major —
    the notebook's nested paste loop."""
    images = np.asarray(images)
    n, h, w = images.shape[:3]
    if n != grid * grid:
        raise ValueError(f"need {grid * grid} images for a {grid}×{grid} grid, got {n}")
    rest = images.shape[3:]
    out = np.zeros((grid * h, grid * w) + rest, dtype=images.dtype)
    for idx in range(n):
        r, c = divmod(idx, grid)
        out[r * h : (r + 1) * h, c * w : (c + 1) * w] = images[idx]
    return out


def write_png(path: str, image: np.ndarray) -> str:
    """Minimal PNG encoder: float arrays in [0,1] or uint8; (H,W) grayscale,
    (H,W,3) RGB, or (H,W,1)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color_type = 0  # grayscale
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2  # RGB
    else:
        raise ValueError(f"unsupported image shape {image.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter 0 rows

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 9))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(png)
    return path


def render_manifold(
    manifold_csv_or_array, path: str, grid: int = 10, side: int = 28, channels: int = 1
) -> str:
    """Cell 6's ``DCGAN_Generated_Images.png`` flow: read the exported
    ``*_out_N.csv`` (grid² rows × side²·C features) or take the array
    directly, tile, write PNG."""
    if isinstance(manifold_csv_or_array, str):
        flat = np.loadtxt(manifold_csv_or_array, delimiter=",", ndmin=2)
    else:
        flat = np.asarray(manifold_csv_or_array)
    shape = (grid * grid, side, side) if channels == 1 else (grid * grid, side, side, channels)
    return write_png(path, tile_images(flat.reshape(shape), grid))
