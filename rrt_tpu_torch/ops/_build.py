"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in csrc/ compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
build/rrt_tpu_torch/ at the root of the checkout: one nvcc per source,
all started together, then one link. The file name carries a hash of
the sources, the header and the flags, so an edited file builds anew
and an unchanged one is reused. Nothing is built when this module is
imported.
"""

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("tile_render.cu", "train.cu", "queue.cu", "chain.cu",
            "probes.cu")
# Hashed with the sources, not compiled alone.
_HEADERS = ("bounce.cuh", "adjoint.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rrt_tpu_torch"
# -fmad=false: no mul+add contraction into FMA; see the note on floats
# in csrc/tile_render.cu. The train kernels need it too: the backward
# replays the forward's paths bit for bit; the queue kernel, so that it
# traces the paths tile_render traces; and the chain's backward, which
# replays the queue kernel's bounces.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path  # the shared library
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas registers, shared memory, spills),
    # kept beside the library for a reused build


def _kernel_name(mangled: str) -> str:
    """The kernel's name in a mangled entry name, with " (moving)" for
    a kMoving = true instantiation. A name's length prefix may follow
    other digits (the anonymous namespace's hash), so every split of a
    run of digits is tried."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if name.endswith("_kernel") and name.isidentifier():
                moving = mangled[m.end() + len(name):].startswith("ILb1E")
                return name + (" (moving)" if moving else "")
    return mangled


def kernel_resources(log: str) -> dict:
    """ptxas's registers, stack frame and spill bytes of each kernel in
    a build log: {kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(zip(
                ("stack", "spill_stores", "spill_loads"),
                map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


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
    for src in srcs + [_CSRC / name for name in _HEADERS]:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"librrt_kernels-{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return Build(out, 0.0,
                     log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        for src, proc in zip(srcs, procs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        tmp = Path(tmp_dir) / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees a part
    return Build(out, time.perf_counter() - t0, log)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with C signatures."""
    lib = ctypes.CDLL(str(build().path))
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
    lib.rrt_tile_render.argtypes = [p, i, p, p, p, p, i, i, i, u, u, u, i,
                                    i, i, i, f, i, p, p, p]
    lib.rrt_tile_render.restype = i
    lib.rrt_train_fwd.argtypes = [p, i, p, p, u, u, u, i, i, i, i, f, i, i,
                                  p, p, p, p, p]
    lib.rrt_train_fwd.restype = i
    lib.rrt_train_bwd.argtypes = [p, i, p, p, p, p, p, i, u, u, u, i, i, i,
                                  i, f, i, p, p, p, p]
    lib.rrt_train_bwd.restype = i
    lib.rrt_bounce_steps.argtypes = [p, p, i, p, i, p, p, i, i, i, p, i, i,
                                     f, i, p]
    lib.rrt_bounce_steps.restype = i
    lib.rrt_intersect.argtypes = [p, p, p, i, p, i, p, p, i, i, i, f, i, p,
                                  p, p, p]
    lib.rrt_intersect.restype = i
    lib.rrt_chain_bwd.argtypes = [p, p, i, p, i, p, p, i, i, i, p, p, p, i,
                                  i, f, i, p, p, p, p, p]
    lib.rrt_chain_bwd.restype = i
    lib.rrt_probe_fma_chain.argtypes = [p, p, i, i, f, f, i, p]
    lib.rrt_probe_fma_chain.restype = i
    lib.rrt_probe_rng.argtypes = [p, p, i, i, i, p]
    lib.rrt_probe_rng.restype = i
    lib.rrt_error_string.argtypes = [i]
    lib.rrt_error_string.restype = ctypes.c_char_p
    return lib
