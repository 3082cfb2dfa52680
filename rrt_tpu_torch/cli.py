"""Command-line renderer.

rrt_tpu's CLI (itself covering the reference's src/main.rs:12-46):
resolution, samples, seed (`-m/--random`: an entropy seed), scene,
output path, maximum depth and Russian roulette's first bounce
(`--rr-depth`); the driver (`--driver`: `tile`, one kernel launch for
all pixels; `queue`, the persistent ray queue; `batch`, fixed ray
batches in eager PyTorch; `auto` picks `tile` for every scene in the
kernels' scope), the queue size, progressive passes of `--spp-chunk`
samples, checkpoints to resume from (`--checkpoint`,
`--checkpoint-every`) with rrt_tpu's rules and file format, an image
file for the scene's image texture (`--texture`, `--texture-filter`,
`--texture-max`; io.read_image), a torch.profiler trace (`--profile`),
and sharded renders over a (dp, sp) mesh of processes (`--coordinator`,
`--num-processes`, `--process-id`, `--mesh`: parallel/mesh.py; one
pass, rank 0 writes the image). `--device` picks the device: `cuda`
(the default) launches the CUDA kernels, `cpu` runs their plain
PyTorch versions.

    python -m rrt_tpu_torch.cli            # book2chap2, 1200x800, 10 spp
    python -m rrt_tpu_torch.cli --scene chap12 -r 1200x800 -s 32 -o out.png
    python -m rrt_tpu_torch.cli --scene chap12 -s 64 --driver queue \\
        --spp-chunk 8 --checkpoint ck.npz -o out.png
    for i in 0 1; do  # two ranks on one host, dp 2
      python -m rrt_tpu_torch.cli --scene chap12 -r 400x266 -s 8 \\
        --coordinator localhost:29512 --num-processes 2 --process-id $i \\
        --mesh 2x1 -o mp.png &
    done; wait

RRT_FAULT_AFTER_CHUNKS=N ends the process with exit code 17 after N
progressive passes (rrt_tpu's crash hook): a render restarted with the
same --checkpoint then ends bit for bit as an uninterrupted one.
"""

import argparse
import contextlib
import dataclasses
import inspect
import math
import os
import sys
import time

import numpy as np
import torch

from .io import load_checkpoint, read_image, save_checkpoint, write_image
from .ops.megakernel import scope_gap
from .render import (RenderConfig, render_image, tonemap, trace_queue,
                     trace_tiles)
from .scene import resample_image
from .scenes import SCENES


def parse_resolution(s: str):
    try:
        w, h = s.lower().split("x")
        w, h = int(w), int(h)
        if w <= 0 or h <= 0:
            raise ValueError
        return w, h
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"resolution must be WIDTHxHEIGHT with positive integers, "
            f"got {s!r}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="rrt-tpu-torch",
        description="path tracer, PyTorch/CUDA port of rrt_tpu")
    p.add_argument("-r", "--resolution", type=parse_resolution,
                   default=(1200, 800), help="WIDTHxHEIGHT (default "
                   "1200x800, the reference default)")
    p.add_argument("-s", "--samples", type=int, default=10,
                   help="samples per pixel (default 10)")
    p.add_argument("-e", "--seed", type=int, default=0,
                   help="render seed (default 0)")
    p.add_argument("-m", "--random", action="store_true",
                   help="use an entropy seed instead of --seed (a sharded "
                   "render's rank 0 draws it for every rank)")
    p.add_argument("--scene", default="book2chap2",
                   help="scene name (default book2chap2, rrt_tpu's): "
                   + ", ".join(sorted(SCENES)))
    p.add_argument("-o", "--output", default="o.ppm",
                   help="output path; .png or .ppm by extension")
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--rr-depth", type=int, default=0,
                   help="Russian roulette from this bounce (0 = off, "
                   "the books' exact termination; every driver takes it)")
    p.add_argument("--driver", choices=("auto", "tile", "queue", "batch"),
                   default="auto",
                   help="auto (default): tile for scenes in the kernels' "
                   "scope; tile: one launch for all pixels; queue: "
                   "persistent ray queue; batch: fixed ray batches "
                   "(parity/debug)")
    p.add_argument("--queue-size", type=int, default=131072,
                   help="queue driver: lanes in flight")
    p.add_argument("--spp-chunk", type=int, default=-1,
                   help="samples per progressive pass (-1 = auto: "
                   "min(32, spp) so long renders report progress; "
                   "0 = all at once)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to save to / resume from")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint every N progressive passes")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the "
                   "kernels' plain PyTorch versions)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace of the render "
                   "to DIR")
    p.add_argument("--texture", default=None, metavar="PATH",
                   help="image file (binary PPM or 8-bit PNG) for the "
                   "scene's image texture (earth / rttnw_final)")
    p.add_argument("--texture-filter", choices=("nearest", "bilinear"),
                   default="nearest",
                   help="resampling of a --texture image past "
                   "--texture-max (default nearest; bilinear smooths "
                   "photos)")
    p.add_argument("--texture-max", type=parse_resolution,
                   default=(512, 256), metavar="WxH",
                   help="cap a loaded texture to this size (default "
                   "512x256, rrt_tpu's)")
    p.add_argument("--quiet", action="store_true")
    # A sharded render: every rank runs the same command with its own
    # --process-id (the recipe is in the module docstring).
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="sharded render: rank 0's address for the process "
                   "group (torch.distributed's TCP store)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="sharded render: the number of ranks")
    p.add_argument("--process-id", type=int, default=None,
                   help="sharded render: this process's rank")
    p.add_argument("--mesh", default=None, metavar="DPxSP",
                   help="the (dp, sp) mesh over the ranks (default: "
                   "rrt_tpu's factorization)")
    return p


def resolve_driver(driver: str, scene) -> str:
    """`auto` -> `tile` when the scene is in the kernels' scope, else
    `queue` (which then raises NotImplementedError naming the ROADMAP
    item), after rrt_tpu/cli.py resolve_driver; an explicit driver is
    honoured as it is."""
    if driver != "auto":
        return driver
    return "tile" if scope_gap(scene) is None else "queue"


@dataclasses.dataclass(frozen=True)
class RenderResult:
    image: torch.Tensor  # (H,W,3) f32 mean radiance, on the device
    n_traced: int  # ray segments traced by this run
    seconds: float  # render wall time, ending in a device synchronize
    driver: str = "tile"  # the driver that rendered
    passes: int = 1  # progressive passes this run rendered


def _chunk(driver, scene, camera, px, py, cfg, seed, lo, hi, device):
    """Radiance sums (P,3) and traced segments of samples [lo, hi)."""
    if driver == "tile":
        return trace_tiles(scene, camera, cfg, seed, sample_lo=lo,
                           n_samples=hi - lo, device=device)
    if driver == "queue":
        return trace_queue(scene, camera, px, py, cfg, seed, lo, hi,
                           device=device)
    spc = cfg.samples_per_pass  # batch: passes [lo/spc, hi/spc)
    img, n = render_image(scene, camera, cfg, seed, pass_start=lo // spc,
                          n_passes=(hi - lo) // spc, device=device)
    return img.reshape(-1, 3) * float(hi - lo), n


def _logger(args):
    return (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr, flush=True))


def entropy_seed() -> int:
    """A seed from the system's entropy (rrt_tpu's -m/--random)."""
    return int(np.random.SeedSequence().entropy % (2 ** 31))


def _textured_scenes():
    """The scenes whose builders take an image (`--texture`)."""
    return sorted(n for n, fn in SCENES.items()
                  if "image" in inspect.signature(fn).parameters)


def build_scene(args, log):
    """The scene and camera of args.scene at args.resolution, with
    args.texture (io.read_image, resampled to fit args.texture_max with
    args.texture_filter, as rrt_tpu's CLI does) as its image, for a scene
    of _textured_scenes()."""
    width, height = args.resolution
    kwargs = {}
    if args.texture:
        img = read_image(args.texture)
        max_w, max_h = args.texture_max
        if img.shape[0] > max_h or img.shape[1] > max_w:
            h2, w2 = min(img.shape[0], max_h), min(img.shape[1], max_w)
            log(f"texture {args.texture}: {img.shape[0]}x{img.shape[1]} -> "
                f"{h2}x{w2} ({args.texture_filter}; --texture-max)")
            img = resample_image(img, h2, w2, args.texture_filter)
        else:
            log(f"texture {args.texture}: {img.shape[0]}x{img.shape[1]}")
        kwargs = {"image": img, "image_resample": args.texture_filter}
    return SCENES[args.scene](width, height, **kwargs)


@contextlib.contextmanager
def _profiled(directory, device, log):
    """A torch.profiler trace of the block, written to directory as a
    chrome trace (trace.json); nothing without a directory."""
    if not directory:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    log(f"profile written to {path}")


def checkpoint_meta(args) -> dict:
    """Everything that changes the rendered radiance, with rrt_tpu's
    keys and the values its CLI writes for the same render, so a
    checkpoint of either package resumes in the other."""
    width, height = args.resolution
    return {"scene": args.scene, "width": width, "height": height,
            "max_depth": args.max_depth, "rr_depth": args.rr_depth,
            "texture": args.texture or "",
            "texture_filter": args.texture_filter,
            "texture_max": "x".join(map(str, args.texture_max))}


def render(args) -> RenderResult:
    """Build the scene, render it in progressive passes and write the
    image, for parsed arguments (`build_parser().parse_args(...)`)."""
    log = _logger(args)
    width, height = args.resolution
    spp = args.samples
    device = torch.device(args.device)
    seed = entropy_seed() if args.random else args.seed
    log(f"rrt-tpu-torch: {args.scene} {width}x{height} @ {spp}spp "
        f"seed={seed} depth={args.max_depth} rr_depth={args.rr_depth} "
        f"driver={args.driver} device={device}")
    scene, camera = build_scene(args, log)
    driver = resolve_driver(args.driver, scene)
    if driver != args.driver:
        log(f"driver {args.driver} -> {driver}")

    if args.spp_chunk < 0:  # auto: progress at least every 32 spp
        chunk = min(32, spp)
    else:
        chunk = args.spp_chunk if args.spp_chunk > 0 else spp
        if chunk > 32:
            log(f"rendering {chunk} spp a pass; no progress until a pass "
                f"completes (use --spp-chunk for updates)")
    # The batch driver's passes must divide both the chunk and spp;
    # per-sample radiance does not depend on them.
    spc = math.gcd(min(4, spp), chunk, spp)
    cfg = RenderConfig(
        width=width, height=height, spp=spp, max_depth=args.max_depth,
        queue_size=min(args.queue_size, width * height * spp),
        samples_per_pass=spc, rr_depth=args.rr_depth)

    n_pix = width * height
    ids = torch.arange(n_pix)
    px, py = ids % width, ids // width
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    spp_done = 0
    ck_meta = checkpoint_meta(args)
    if args.checkpoint:
        try:
            acc_l, spp_done, seed_ck, meta = load_checkpoint(args.checkpoint)
            compatible = (seed_ck == seed
                          and all(meta.get(k, v) == v
                                  for k, v in ck_meta.items())
                          and acc_l.shape == (n_pix, 3))
            if compatible and driver == "batch" and spp_done % spc:
                log("checkpoint spp_done not a multiple of the batch "
                    "driver's samples_per_pass; starting fresh")
                spp_done = 0
            elif compatible:
                acc = torch.from_numpy(acc_l).to(device)
                log(f"resumed checkpoint at {spp_done}/{spp} spp")
            else:
                log("checkpoint incompatible; starting fresh")
                spp_done = 0
        except FileNotFoundError:
            pass

    fault_after = int(os.environ.get("RRT_FAULT_AFTER_CHUNKS", 0))
    t0 = time.perf_counter()
    total_rays = passes = 0
    with _profiled(args.profile, device, log):
        while spp_done < spp:
            s_hi = min(spp_done + chunk, spp)
            rad, n_traced = _chunk(driver, scene, camera, px, py, cfg, seed,
                                   spp_done, s_hi, device)
            acc += rad
            total_rays += int(n_traced)  # copies to the host, after the pass
            spp_done = s_hi
            passes += 1
            elapsed = time.perf_counter() - t0
            log(f"  {spp_done}/{spp} spp  {elapsed:.3f}s  "
                f"{total_rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s")
            if args.checkpoint and (passes % args.checkpoint_every == 0
                                    or spp_done >= spp):
                save_checkpoint(args.checkpoint, acc.cpu().numpy(),
                                spp_done, seed, ck_meta)
            # rrt_tpu's crash hook: a restart with the same --checkpoint
            # ends bit for bit as an uninterrupted render.
            if passes == fault_after:
                os._exit(17)
        image = (acc / max(spp_done, 1)).reshape(height, width, 3)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    write_image(args.output, tonemap(image).cpu().numpy())
    log(f"wrote {args.output}  ({seconds:.3f}s, {total_rays / 1e6:.1f}M "
        f"rays, {total_rays / max(seconds, 1e-9) / 1e6:.1f} Mrays/s)")
    return RenderResult(image, total_rays, seconds, driver, passes)


def render_sharded(args, mesh, backend: str) -> RenderResult:
    """A sharded render on this rank's place in `mesh` (parallel/mesh.py's
    Mesh; a world of one without a process group), for parsed arguments:
    one pass of every sample (progressive passes and resuming are
    single-process features, as in rrt_tpu) through the driver's sharded
    route; rank 0 draws a -m seed for every rank, writes the image and,
    with --checkpoint, the assembled radiance sums (which a single
    process resumes or extends). Every rank calls it and returns the
    image; each logs the backend first, then its wall time, peak device
    memory and kernel launches."""
    from .ops import megakernel as ops_mega
    from .parallel import mesh as pmesh

    log = _logger(args)
    width, height = args.resolution
    spp = args.samples
    device, rank = mesh.device, mesh.rank
    log(f"backend {backend}: rank {rank} of {mesh.size}, device {device}")
    seed = pmesh.broadcast_int(
        mesh, entropy_seed() if args.random and rank == 0 else args.seed)
    log(f"rrt-tpu-torch: {args.scene} {width}x{height} @ {spp}spp "
        f"seed={seed} depth={args.max_depth} rr_depth={args.rr_depth} "
        f"driver={args.driver} mesh dp={mesh.dp} sp={mesh.sp} rank {rank} "
        f"device={device} backend={backend}")
    scene, camera = build_scene(args, log)
    driver = resolve_driver(args.driver, scene)
    spc = math.gcd(min(4, spp), spp // mesh.sp)  # passes split over sp
    cfg = RenderConfig(
        width=width, height=height, spp=spp, max_depth=args.max_depth,
        queue_size=min(args.queue_size, width * height * spp),
        samples_per_pass=spc, rr_depth=args.rr_depth)
    kernels = (ops_mega.render_tiles, ops_mega.bounce_steps,
               ops_mega.intersect_only)
    before = [k.launches for k in kernels]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with _profiled(args.profile, device, log):
        if driver == "batch":  # the batch driver gives means, as _chunk's
            image, n_traced = pmesh.render_image_sharded(
                scene, camera, cfg, seed, mesh)
            rad = image.reshape(-1, 3) * float(spp)
        else:
            route = (pmesh.trace_tiles_sharded if driver == "tile"
                     else pmesh.trace_queue_sharded)
            rad, n_traced = route(scene, camera, cfg, seed, mesh)
            image = (rad / float(spp)).reshape(height, width, 3)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    total_rays = int(n_traced)
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else 0.0)
    log(f"rank {rank}: {seconds:.3f}s, peak device memory {peak:.3f} GB, "
        "launches " + ", ".join(f"{k.__name__} {k.launches - b}"
                                for k, b in zip(kernels, before)))
    if rank == 0:
        write_image(args.output, tonemap(image).cpu().numpy())
        if args.checkpoint:
            save_checkpoint(args.checkpoint, rad.cpu().numpy(), spp, seed,
                            checkpoint_meta(args))
        log(f"wrote {args.output}  ({seconds:.3f}s, {total_rays / 1e6:.1f}M "
            f"rays, {total_rays / max(seconds, 1e-9) / 1e6:.1f} Mrays/s)")
    return RenderResult(image, total_rays, seconds, driver, 1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; available: "
              f"{', '.join(sorted(SCENES))}", file=sys.stderr)
        return 2
    if args.texture and args.scene not in _textured_scenes():
        print(f"scene {args.scene!r} has no image texture; --texture "
              f"applies to: {', '.join(_textured_scenes())}",
              file=sys.stderr)
        return 2
    from .parallel import mesh as pmesh

    error = pmesh.flags_error(args.coordinator, args.num_processes,
                              args.process_id)
    if error:
        print(error, file=sys.stderr)
        return 2
    if args.coordinator is None and args.mesh is None:
        render(args)
        return 0
    with pmesh.from_flags(args.coordinator, args.num_processes,
                          args.process_id, args.mesh,
                          args.device) as (mesh, backend):
        render_sharded(args, mesh, backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
