"""Image output: PPM and PNG writers (format by file extension).

The same dependency-free writers as rrt_tpu.io; the port's CLI writes
its tonemapped RGB8 images through them."""

import struct
import zlib

import numpy as np


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    h, w = rgb8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb8, dtype=np.uint8).tobytes())


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Minimal dependency-free PNG encoder (8-bit RGB, zlib filter 0)."""
    h, w = rgb8.shape[:2]
    raw = b"".join(
        b"\x00" + np.ascontiguousarray(rgb8[y], np.uint8).tobytes()
        for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_image(path: str, rgb8: np.ndarray) -> None:
    if path.endswith(".png"):
        write_png(path, rgb8)
    else:
        write_ppm(path, rgb8)
