"""PNG files without OpenCV: a zlib writer, and readers through the
port's frame decoder (`native.decoder()`).

`write_png` writes 8-bit RGB (H, W, 3) or 8/16-bit grey (H, W) images;
`read_png` returns a file's samples unchanged ((H, W) grey, 8 or 16 bit,
as OpenCV's IMREAD_UNCHANGED gives them) and `read_rgb8` an 8-bit RGB
image (for an 8-bit colour or grey file, OpenCV's IMREAD_COLOR with the
channels in RGB order).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def write_png(path, img: np.ndarray):
    """Write an 8-bit RGB (H, W, 3), or an 8-bit / 16-bit grey (H, W),
    PNG with zlib alone. Row y uses filter type y % 5, so a reader meets
    all five."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.ndim == 3:
        if img.dtype != np.uint8 or img.shape[2] != 3:
            raise ValueError(f"colour PNG must be (H, W, 3) uint8, not {img.shape} {img.dtype}")
        color_type, bit_depth, bpp = 2, 8, 3
        rows = img.reshape(h, -1)
    elif img.dtype == np.uint8:
        color_type, bit_depth, bpp = 0, 8, 1
        rows = img
    elif img.dtype == np.uint16:
        color_type, bit_depth, bpp = 0, 16, 2
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        raise ValueError(f"grey PNG must be uint8 or uint16, not {img.dtype}")
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.arange(h) % 5
    pred = np.select([kinds[:, None] == k for k in (1, 2, 3, 4)],
                     [a, b, (a + b) // 2, paeth], 0)
    raw = np.concatenate([kinds[:, None], (x - pred) % 256], 1).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """The samples unchanged: (H, W) for grey, (H, W, C) otherwise."""
    from .. import native

    px, _, _ = native.decoder().pixels(path)
    return px[..., 0] if px.shape[-1] == 1 else px


def read_rgb8(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as the frame decoder converts colour: 16-bit
    samples keep their high byte, grey is repeated, a palette is
    expanded, alpha is dropped."""
    from .. import native

    px, color_type, palette = native.decoder().pixels(path)
    if px.dtype != np.uint8:
        px = (px >> 8).astype(np.uint8)
    if color_type == 3:
        return palette[px[..., 0]]
    if color_type in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])
