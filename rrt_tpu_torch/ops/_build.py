"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in csrc/ compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
build/rrt_tpu_torch/ at the root of the checkout. The file name carries
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing is built when this module is imported.
"""

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("tile_render.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rrt_tpu_torch"
# -fmad=false: no mul+add contraction into FMA; see the note on floats
# in csrc/tile_render.cu.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path  # the shared library
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas registers, shared memory, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build() -> Build:
    """Compile the kernels unless this exact build exists already."""
    srcs = [_CSRC / name for name in _SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"librrt_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a part
    return Build(out, seconds, log)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with C signatures."""
    lib = ctypes.CDLL(str(build().path))
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
    lib.rrt_tile_render.argtypes = [p, i, p, p, u, u, u, i, i, i, i, f,
                                    p, p, p]
    lib.rrt_tile_render.restype = i
    lib.rrt_error_string.argtypes = [i]
    lib.rrt_error_string.restype = ctypes.c_char_p
    return lib
