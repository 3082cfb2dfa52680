"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in csrc/ compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
build/rrt_tpu_torch/ at the root of the checkout: one nvcc per source,
all started together, then one link. The file name carries a hash of
the sources, the header and the flags, so an edited file builds anew
and an unchanged one is reused. Nothing is built when this module is
imported. Processes that load the kernels at once (the ranks of a
sharded run) build them once: the first takes a lock file beside the
library and builds in a temporary directory, renamed into place, while
the others wait on the lock and then load its library.
"""

import ctypes
import dataclasses
import fcntl
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
            "chain_walk.cu", "probes.cu")
# Hashed with the sources, not compiled alone.
_HEADERS = ("bounce.cuh", "adjoint.cuh", "chain.cuh")
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
    """The kernel's name in a mangled entry name, with " (moving)",
    " (solids)", " (tex)", " (walk)" or their combinations, such as "
    (moving, solids)", for an instantiation whose first bool template
    argument (kMoving), second (kSolids), third (kTex) or fourth (kWalk;
    intersect_kernel's third) is true. A
    name's length prefix may follow other digits (the anonymous
    namespace's hash), so every split of a run of digits is tried."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if name.endswith("_kernel") and name.isidentifier():
                args = re.match(r"I((?:Lb[01]E)+)",
                                mangled[m.end() + len(name):])
                flags = re.findall(r"Lb([01])E", args.group(1)) if args \
                    else []
                names = (("moving", "solids", "walk")
                         if name == "intersect_kernel"
                         else ("moving", "solids", "tex", "walk"))
                tags = [tag for tag, bit in zip(names, flags) if bit == "1"]
                return name + (f" ({', '.join(tags)})" if tags else "")
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
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return Build(out, 0.0, log_path.read_text()
                         if log_path.exists() else "")
        return _compile(srcs, out, log_path)


def _compile(srcs, out: Path, log_path: Path) -> Build:
    """nvcc each source in parallel into a temporary directory, link,
    write the log, then rename the library into place."""
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
        log_tmp = Path(tmp_dir) / log_path.name
        log_tmp.write_text(log)
        os.replace(log_tmp, log_path)
        os.replace(tmp, out)  # atomic: a concurrent load never sees a part
    return Build(out, time.perf_counter() - t0, log)


class SolidArgs(ctypes.Structure):
    """The solid families' C argument (csrc/bounce.cuh SolidArgs): the
    quad and box packs, their widths and active slot counts, the medium
    pack and its active media, and for the forward kernels and train_fwd
    the families' trees (accel.SolidBvh: each family's nodes, rows, node
    and row counts and always-tested rows; zeros for a family they loop
    over); a
    null pointer in its place launches the sphere variant."""

    _fields_ = [("quad", ctypes.c_void_p), ("quad_slots", ctypes.c_int),
                ("n_quads", ctypes.c_int), ("box", ctypes.c_void_p),
                ("box_slots", ctypes.c_int), ("n_boxes", ctypes.c_int),
                ("med", ctypes.c_void_p), ("n_media", ctypes.c_int),
                ("quad_nodes", ctypes.c_void_p),
                ("quad_rows", ctypes.c_void_p),
                ("quad_n_nodes", ctypes.c_int), ("quad_n_rows", ctypes.c_int),
                ("quad_n_always", ctypes.c_int),
                ("box_nodes", ctypes.c_void_p), ("box_rows", ctypes.c_void_p),
                ("box_n_nodes", ctypes.c_int), ("box_n_rows", ctypes.c_int),
                ("box_n_always", ctypes.c_int)]


class TexArgs(ctypes.Structure):
    """The textures' C argument (csrc/bounce.cuh TexArgs): the atlas
    (n_img * ah * aw texels of four floats: rgb, 0), its grid, and the
    backward's atlas cotangent of the same layout (null in a forward); a
    null pointer in its place launches the variant without textures."""

    _fields_ = [("atlas", ctypes.c_void_p), ("d_atlas", ctypes.c_void_p),
                ("n_img", ctypes.c_int), ("ah", ctypes.c_int),
                ("aw", ctypes.c_int)]


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with C signatures."""
    lib = ctypes.CDLL(str(build().path))
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
    s = ctypes.POINTER(SolidArgs)
    t = ctypes.POINTER(TexArgs)
    lib.rrt_tile_render.argtypes = [p, i, p, p, p, p, i, i, i, s, t, u, u, u,
                                    i, i, i, i, i, i, f, i, p, p, p]
    lib.rrt_tile_render.restype = i
    lib.rrt_train_fwd.argtypes = [p, i, p, p, s, t, u, u, u, i, i, i, i, i,
                                  i, f, i, i, p, p, p, p, p]
    lib.rrt_train_fwd.restype = i
    lib.rrt_train_bwd.argtypes = [p, i, p, p, s, t, p, p, p, i, u, u, u, i,
                                  i, i, i, i, i, f, i, p, p, p, p]
    lib.rrt_train_bwd.restype = i
    lib.rrt_bounce_steps.argtypes = [p, p, i, p, i, p, p, i, i, i, s, t, p,
                                     i, i, i, f, i, p]
    lib.rrt_bounce_steps.restype = i
    lib.rrt_intersect.argtypes = [p, p, p, p, p, i, p, i, p, p, i, i, i, s,
                                  f, i, p, p, p, p]
    lib.rrt_intersect.restype = i
    lib.rrt_chain_bwd.argtypes = [p, p, i, p, i, p, p, i, i, i, s, t, p, p,
                                  p, i, i, i, f, i, p, p, p, p, p]
    lib.rrt_chain_bwd.restype = i
    n = ctypes.POINTER(ctypes.c_int)
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.rrt_tile_render_blocks.argtypes = [i, i, i, s, i, n, ll]
    lib.rrt_tile_render_blocks.restype = i
    lib.rrt_queue_blocks.argtypes = [i, i, i, i, s, i, n, ll]
    lib.rrt_queue_blocks.restype = i
    lib.rrt_train_blocks.argtypes = [i, i, i, s, i, n, ll, ll]
    lib.rrt_train_blocks.restype = i
    lib.rrt_probe_fma_chain.argtypes = [p, p, i, i, f, f, i, p]
    lib.rrt_probe_fma_chain.restype = i
    lib.rrt_probe_rng.argtypes = [p, p, i, i, i, p]
    lib.rrt_probe_rng.restype = i
    lib.rrt_error_string.argtypes = [i]
    lib.rrt_error_string.restype = ctypes.c_char_p
    return lib
