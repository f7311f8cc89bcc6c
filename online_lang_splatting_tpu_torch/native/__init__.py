"""Frame decoding for the disk datasets: PNG / JPEG files -> float32 arrays.

Two decoders; `decoder()` chooses one per process at first use and keeps it:

* "libpng": the repository's `native/frame_decode.cpp` (libpng, libjpeg,
  zlib), compiled with g++ as the JAX package compiles it. PNG and JPEG.
* "zlib": where the libpng / libjpeg headers are missing, PNG is decoded
  here: the chunks parsed in Python, the image stream inflated by the
  standard library's zlib, the row filters undone by `png_unfilter.cpp`
  (built by the same g++ step, no dependency). JPEG is decoded by PIL,
  whose samples the tests hold to frame_decode.cpp's libjpeg decode.

Both give the values frame_decode.cpp gives: colour u8 * (1/255) and depth
u16 * (1/scale), each reciprocal rounded to float32 first. The libraries go
to `build/torch_native/` at the repository root, named by a hash of source
and flags; `native/` is never written. A file that does not decode raises:
no frame is ever returned as zeros, and no frame falls back to another
decoder. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO / "build" / "torch_native"
FRAME_DECODE_SRC = _REPO / "native" / "frame_decode.cpp"
UNFILTER_SRC = Path(__file__).resolve().parent / "png_unfilter.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
# frame_decode.cpp's return codes.
_ERRORS = {-1: "cannot open", -2: "not a PNG or JPEG", -3: "size mismatch",
           -4: "decode error"}


def _build(src: Path, libs: tuple = ()) -> Path:
    """Compile `src` into a shared library (once per source hash)."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(GXX_FLAGS + libs).encode())
    so = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        res = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp), *libs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name} ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _f32_reciprocal(x: float) -> np.float32:
    return np.float32(1.0) / np.float32(x)


class LibpngDecoder:
    """native/frame_decode.cpp through ctypes (PNG and JPEG)."""

    name = "libpng"

    def __init__(self):
        lib = ctypes.CDLL(str(_build(FRAME_DECODE_SRC, ("-lpng", "-ljpeg", "-lz"))))
        fp = ctypes.POINTER(ctypes.c_float)
        lib.fd_decode_rgb.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ctypes.c_int]
        lib.fd_decode_rgb.restype = ctypes.c_int
        lib.fd_decode_depth16.argtypes = [ctypes.c_char_p, fp, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_float]
        lib.fd_decode_depth16.restype = ctypes.c_int
        self._lib = lib

    @staticmethod
    def _check(rc: int, path):
        if rc != 0:
            raise RuntimeError(f"frame_decode: {path}: {_ERRORS.get(rc, rc)}")

    def rgb(self, path, h: int, w: int) -> np.ndarray:
        """(3, h, w) float32 in [0, 1]."""
        out = np.empty((3, h, w), np.float32)
        self._check(self._lib.fd_decode_rgb(
            str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w),
            path)
        return out

    def pixels(self, path):
        """A PNG's samples unchanged, as `ZlibDecoder.pixels` reads them
        (frame_decode.cpp converts while it decodes)."""
        return _zlib_decoder().pixels(path)

    def depth(self, path, h: int, w: int, scale: float) -> np.ndarray:
        """(h, w) float32, the PNG value / scale."""
        out = np.empty((h, w), np.float32)
        self._check(self._lib.fd_decode_depth16(
            str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
            ctypes.c_float(scale)), path)
        return out


class ZlibDecoder:
    """PNG through the standard library's zlib and png_unfilter.cpp, JPEG
    through PIL. Non-interlaced PNG of bit depth 8 or 16, every colour
    type; JPEG as 8-bit RGB."""

    name = "zlib"
    _CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

    def __init__(self):
        lib = ctypes.CDLL(str(_build(UNFILTER_SRC)))
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
        self._lib = lib

    def pixels(self, path):
        """(h, w, channels) uint8 / uint16 samples, colour type, palette.
        A JPEG reads as (h, w, 3) uint8 RGB, colour type 2."""
        data = Path(path).read_bytes()
        if data[:2] == JPEG_SOI:
            from PIL import Image

            with Image.open(path) as im:
                return np.asarray(im.convert("RGB")), 2, None
        if data[:8] != PNG_SIGNATURE:
            raise RuntimeError(f"{path}: neither a PNG nor a JPEG")
        pos, idat, palette, header = 8, [], None, None
        while pos + 8 <= len(data):
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            pos += 12 + length
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
        if header is None or not idat:
            raise RuntimeError(f"{path}: PNG without IHDR or IDAT")
        w, h, bit_depth, color_type, _, _, interlace = header
        if interlace or bit_depth not in (8, 16) or color_type not in self._CHANNELS:
            raise RuntimeError(f"{path}: unsupported PNG (bit depth {bit_depth}, colour "
                               f"type {color_type}, interlace {interlace})")
        channels = self._CHANNELS[color_type]
        bpp = channels * bit_depth // 8
        stride = w * bpp
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        if raw.size != h * (stride + 1):
            raise RuntimeError(f"{path}: image stream of {raw.size} bytes, want "
                               f"{h * (stride + 1)}")
        out = np.empty(h * stride, np.uint8)
        rc = self._lib.png_unfilter(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
        if rc != 0:
            raise RuntimeError(f"{path}: unknown PNG filter type in row {-1 - rc}")
        px = out.view(">u2") if bit_depth == 16 else out
        return px.reshape(h, w, channels), color_type, palette

    @staticmethod
    def _size(px, path, h, w):
        if px.shape[:2] != (h, w):
            raise RuntimeError(f"{path}: {px.shape[1]}x{px.shape[0]}, want {w}x{h}")

    def rgb(self, path, h: int, w: int) -> np.ndarray:
        """(3, h, w) float32 in [0, 1], as libpng's expand / strip_16 /
        strip_alpha / gray_to_rgb transforms give it."""
        px, color_type, palette = self.pixels(path)
        self._size(px, path, h, w)
        if px.dtype != np.uint8:
            px = (px >> 8).astype(np.uint8)  # strip_16 keeps the high byte
        if color_type == 3:
            rgb = palette[px[..., 0]]
        elif color_type in (0, 4):
            rgb = np.repeat(px[..., :1], 3, axis=-1)
        else:
            rgb = px[..., :3]
        return np.transpose(rgb, (2, 0, 1)).astype(np.float32) * _f32_reciprocal(255.0)

    def depth(self, path, h: int, w: int, scale: float) -> np.ndarray:
        """(h, w) float32, the PNG value / scale (one-channel PNG)."""
        px, color_type, _ = self.pixels(path)
        self._size(px, path, h, w)
        if color_type != 0:
            raise RuntimeError(f"{path}: depth PNG of colour type {color_type}, want gray")
        return px[..., 0].astype(np.float32) * _f32_reciprocal(scale)


_lock = threading.Lock()
_decoder = None
_zlib = None


def _zlib_decoder() -> ZlibDecoder:
    global _zlib
    with _lock:
        if _zlib is None:
            _zlib = ZlibDecoder()
        return _zlib


def decoder():
    """The process's decoder: libpng where frame_decode.cpp builds and
    loads, else zlib. Chosen once; raises if neither builds."""
    global _decoder
    with _lock:
        if _decoder is None:
            try:
                _decoder = LibpngDecoder()
            except (RuntimeError, OSError) as e:
                lines = str(e).splitlines() or [type(e).__name__]
                why = next((ln for ln in lines if "error" in ln), lines[0])
                print(f"[native] libpng / libjpeg decoder unavailable ({why.strip()}); "
                      "PNG decodes through zlib + png_unfilter, JPEG through PIL")
                _decoder = ZlibDecoder()
        return _decoder
