"""Image IO: PNG dump of rendered frames (the swapchain-present analog
for headless operation) and EXR for HDR dumps — standard library and
numpy only."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb_u8(color) -> np.ndarray:
    """(3, H, W) linear [0,1] -> (H, W, 3) u8 sRGB-encoded.

    The reference's swapchain is an sRGB format, so the hardware applies
    this encode on write; we do it at dump time.
    """
    from ..models.texture import linear_to_srgb
    c = np.asarray(color, np.float32)
    c = np.clip(c, 0.0, 1.0).transpose(1, 2, 0)
    return (linear_to_srgb(c) * 255.0 + 0.5).astype(np.uint8)


def png_bytes(arr: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG file bytes (8-bit RGB/RGBA, filter
    type 0 on every row, zlib-compressed)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    assert c in (3, 4), arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path: str, color, already_u8: bool = False) -> None:
    arr = np.asarray(color) if already_u8 else to_srgb_u8(color)
    with open(path, "wb") as f:
        f.write(png_bytes(arr))


def save_exr(path: str, color) -> None:
    """(C, H, W) float -> scanline float32 EXR (uncompressed)."""
    from . import exr
    c = np.asarray(color, np.float32)
    exr.write_exr(path, c)
