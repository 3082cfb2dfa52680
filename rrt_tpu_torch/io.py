"""Image output and checkpoints.

The same dependency-free PPM and PNG writers as rrt_tpu.io (format by
file extension), and its checkpoint format: an .npz of the float
radiance accumulator (sum over samples), the samples done, the seed and
a JSON meta, so that a checkpoint written by either package resumes in
the other. Resuming is exact because sample keys are (pixel, sample)
addressed."""

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
