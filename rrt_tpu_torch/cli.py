"""Command-line renderer: the one-launch tile path on one device.

A subset of rrt_tpu's CLI (itself covering the reference's
src/main.rs:12-46): resolution, samples, seed, scene, output path and
maximum depth, always through the tile-render kernel. `--device` picks
the device: `cuda` (the default) launches the CUDA kernel, `cpu` runs
its plain PyTorch version.

    python -m rrt_tpu_torch.cli --scene chap12 -r 1200x800 -s 32 -o out.png
"""

import argparse
import dataclasses
import sys
import time

import torch

from .io import write_image
from .render import RenderConfig, render_image_tiles, tonemap
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
    p.add_argument("--scene", default="chap12",
                   help="scene name: " + ", ".join(sorted(SCENES)))
    p.add_argument("-o", "--output", default="o.ppm",
                   help="output path; .png or .ppm by extension")
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the "
                   "kernel's plain PyTorch version)")
    p.add_argument("--quiet", action="store_true")
    return p


@dataclasses.dataclass(frozen=True)
class RenderResult:
    image: torch.Tensor  # (H,W,3) f32 mean radiance, on the device
    n_traced: int  # ray segments traced
    seconds: float  # render wall time, ending in a device synchronize


def render(args) -> RenderResult:
    """Build the scene, render it and write the image, for parsed
    arguments (`build_parser().parse_args(...)`)."""
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr, flush=True))
    width, height = args.resolution
    device = torch.device(args.device)
    log(f"rrt-tpu-torch: {args.scene} {width}x{height} @ {args.samples}spp "
        f"seed={args.seed} depth={args.max_depth} device={device}")
    scene, camera = SCENES[args.scene](width, height)
    cfg = RenderConfig(width=width, height=height, spp=args.samples,
                       max_depth=args.max_depth)
    t0 = time.perf_counter()
    image, n_traced = render_image_tiles(scene, camera, cfg, args.seed,
                                         device=device)
    n_traced = int(n_traced)  # copies to the host, after the render
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    write_image(args.output, tonemap(image).cpu().numpy())
    log(f"wrote {args.output}  ({seconds:.3f}s, {n_traced / 1e6:.1f}M "
        f"rays, {n_traced / max(seconds, 1e-9) / 1e6:.1f} Mrays/s)")
    return RenderResult(image, n_traced, seconds)


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
