"""Image input and output, and checkpoints.

The same dependency-free PPM and PNG writers as rrt_tpu.io (format by
file extension), a reader of binary PPM and 8-bit PNG for a texture the
user supplies (`read_image`, numpy and zlib only), and rrt_tpu's
checkpoint format: an .npz of the float radiance accumulator (sum over
samples), the samples done, the seed and a JSON meta, so that a
checkpoint written by either package resumes in the other. Resuming is
exact because sample keys are (pixel, sample) addressed."""

import json
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


def _read_ppm(path: str, data: bytes) -> np.ndarray:
    """A binary (P6) PPM, rrt_tpu.io.read_image's header rules: the
    magic and three whitespace-separated integers, '#' comments to the
    end of a line between them, then exactly one whitespace byte before
    the raster (whose bytes may be whitespace values)."""
    pos = 0

    def token():
        nonlocal pos
        while True:
            while pos < len(data) and data[pos:pos + 1].isspace():
                pos += 1
            if data[pos:pos + 1] != b"#":
                break
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        return data[start:pos]

    if token() != b"P6":
        raise ValueError(f"{path}: only binary PPM (P6) supported")
    w, h, maxval = int(token()), int(token()), int(token())
    if not 0 < maxval < 256:
        raise ValueError(f"{path}: only 8-bit PPM supported (maxval {maxval})")
    pos += 1  # the single whitespace byte after maxval
    raster = data[pos:pos + w * h * 3]
    if len(raster) < w * h * 3:
        raise ValueError(f"{path}: truncated PPM raster")
    img = np.frombuffer(raster, np.uint8).reshape(h, w, 3)
    return img.astype(np.float32) / float(maxval)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (none, sub, up, average, Paeth) of h
    rows of `stride` bytes, `bpp` bytes a pixel. Returns (h, stride)
    uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:  # up
            cur = (line + prev) & 0xFF
        elif kind == 1:  # sub: a running sum of each byte of a pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif kind in (3, 4):  # average, Paeth: left to right
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if kind == 3:
                    cur[x] = (cur[x] + (a + b) // 2) & 0xFF
                    continue
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def _read_png(path: str, data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced RGB or RGBA PNG (alpha dropped, as PIL's
    convert("RGB"), which rrt_tpu.io.read_image uses)."""
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB or RGBA PNG supported "
            f"(bit depth {depth}, color type {color}, interlace "
            f"{interlace})")
    bpp = 3 if color == 2 else 4
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = px.reshape(h, w, bpp)[:, :, :3]
    return img.astype(np.float32) / 255.0


def read_image(path: str) -> np.ndarray:
    """Load an image file as (h, w, 3) float32 in [0, 1], the scene
    builders' `image=` argument (rrt_tpu.io.read_image's values): binary
    PPM (P6, 8-bit) and 8-bit non-interlaced RGB or RGBA PNG, told apart
    by their first bytes. Any other format raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        return _read_ppm(path, data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _read_png(path, data)
    raise ValueError(f"{path}: rrt_tpu_torch reads binary PPM (P6) and "
                     "8-bit RGB or RGBA PNG only")


def save_checkpoint(path: str, radiance_sum: np.ndarray, spp_done: int,
                    seed: int, meta: dict | None = None) -> None:
    """Persist the radiance accumulator (P,3) and the (seed, spp) cursor
    a resumed render needs (numpy adds .npz to a path without it)."""
    np.savez_compressed(
        path, radiance_sum=np.asarray(radiance_sum, np.float32),
        spp_done=np.int64(spp_done), seed=np.int64(seed),
        meta=json.dumps(meta or {}))


def load_checkpoint(path: str):
    """(radiance_sum (P,3) f32, spp_done, seed, meta dict)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    return z["radiance_sum"], int(z["spp_done"]), int(z["seed"]), meta
