"""Command-line renderer on one device.

A subset of rrt_tpu's CLI (itself covering the reference's
src/main.rs:12-46): resolution, samples, seed, scene, output path and
maximum depth; the driver (`--driver`: `tile`, one kernel launch for
all pixels; `queue`, the persistent ray queue; `batch`, fixed ray
batches in eager PyTorch; `auto` picks `tile` for every scene in the
kernels' scope), the queue size, progressive passes of `--spp-chunk`
samples, and checkpoints to resume from (`--checkpoint`,
`--checkpoint-every`) with rrt_tpu's rules and file format. `--device`
picks the device: `cuda` (the default) launches the CUDA kernels, `cpu`
runs their plain PyTorch versions.

    python -m rrt_tpu_torch.cli            # book2chap2, 1200x800, 10 spp
    python -m rrt_tpu_torch.cli --scene chap12 -r 1200x800 -s 32 -o out.png
    python -m rrt_tpu_torch.cli --scene chap12 -s 64 --driver queue \\
        --spp-chunk 8 --checkpoint ck.npz -o out.png
"""

import argparse
import dataclasses
import math
import sys
import time

import torch

from .io import load_checkpoint, save_checkpoint, write_image
from .ops.megakernel import scope_gap
from .render import (RenderConfig, render_image, tonemap, trace_queue,
                     trace_tiles)
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
    p.add_argument("--scene", default="book2chap2",
                   help="scene name (default book2chap2, rrt_tpu's): "
                   + ", ".join(sorted(SCENES)))
    p.add_argument("-o", "--output", default="o.ppm",
                   help="output path; .png or .ppm by extension")
    p.add_argument("--max-depth", type=int, default=50)
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
    p.add_argument("--quiet", action="store_true")
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


def render(args) -> RenderResult:
    """Build the scene, render it in progressive passes and write the
    image, for parsed arguments (`build_parser().parse_args(...)`)."""
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr, flush=True))
    width, height = args.resolution
    spp = args.samples
    device = torch.device(args.device)
    log(f"rrt-tpu-torch: {args.scene} {width}x{height} @ {spp}spp "
        f"seed={args.seed} depth={args.max_depth} driver={args.driver} "
        f"device={device}")
    scene, camera = SCENES[args.scene](width, height)
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
        samples_per_pass=spc)

    n_pix = width * height
    ids = torch.arange(n_pix)
    px, py = ids % width, ids // width
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    spp_done = 0
    # Everything that changes the rendered radiance is in the meta, with
    # rrt_tpu's keys and the values its CLI writes for the same render,
    # so a checkpoint of either package resumes in the other.
    ck_meta = {"scene": args.scene, "width": width, "height": height,
               "max_depth": args.max_depth, "rr_depth": 0, "texture": "",
               "texture_filter": "nearest", "texture_max": "512x256"}
    if args.checkpoint:
        try:
            acc_l, spp_done, seed_ck, meta = load_checkpoint(args.checkpoint)
            compatible = (seed_ck == args.seed
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

    t0 = time.perf_counter()
    total_rays = passes = 0
    while spp_done < spp:
        s_hi = min(spp_done + chunk, spp)
        rad, n_traced = _chunk(driver, scene, camera, px, py, cfg,
                               args.seed, spp_done, s_hi, device)
        acc += rad
        total_rays += int(n_traced)  # copies to the host, after the pass
        spp_done = s_hi
        passes += 1
        elapsed = time.perf_counter() - t0
        log(f"  {spp_done}/{spp} spp  {elapsed:.3f}s  "
            f"{total_rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s")
        if args.checkpoint and (passes % args.checkpoint_every == 0
                                or spp_done >= spp):
            save_checkpoint(args.checkpoint, acc.cpu().numpy(), spp_done,
                            args.seed, ck_meta)
    image = (acc / max(spp_done, 1)).reshape(height, width, 3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    write_image(args.output, tonemap(image).cpu().numpy())
    log(f"wrote {args.output}  ({seconds:.3f}s, {total_rays / 1e6:.1f}M "
        f"rays, {total_rays / max(seconds, 1e-9) / 1e6:.1f} Mrays/s)")
    return RenderResult(image, total_rays, seconds, driver, passes)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; available: "
              f"{', '.join(sorted(SCENES))}", file=sys.stderr)
        return 2
    render(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
