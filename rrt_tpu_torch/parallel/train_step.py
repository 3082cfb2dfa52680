"""One sharded train step of a book scene, a process a rank.

    python -m rrt_tpu_torch.parallel.train_step --coordinator HOST:PORT \\
        --num-processes N --process-id I [--mesh DPxSP] --scene chap12 \\
        -r 1200x800 -s 8 [--max-depth 50] [--device cuda] --out DIR

Every rank runs the same command with its own --process-id (without the
three distributed flags, one process alone). Each takes `run`: it
renders a target with the scene as built (seed 1), then takes
diff.loss_and_grads and one diff.make_train_step step (learning rate
LR) on the mesh (seed 0), from the scene with its spheres' radii
scaled by 1.01, and writes DIR/rank{I}.npz: the loss, every gradient (`grad/<field>`,
`grad/camera.<field>`), every updated parameter (`param/...`), the
step's wall time, its peak device memory, the train kernels' launches
and the backend. Rank 0 prints the backend first. The gradients and
parameters of every rank are the same; run with one process, they are
the single-device step's.
"""

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .. import diff
from ..camera import Camera
from ..cli import parse_resolution
from ..ops import megakernel_train as ops_train
from ..render import RenderConfig, render_image_tiles
from ..scenes import SCENES
from . import mesh as pmesh

LR = 1e-2


def build_parser():
    p = argparse.ArgumentParser(prog="rrt-tpu-torch-train-step",
                                description=__doc__.split("\n")[0])
    p.add_argument("--scene", default="chap12")
    p.add_argument("-r", "--resolution", type=parse_resolution,
                   default=(48, 27))
    p.add_argument("-s", "--samples", type=int, default=2)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--spp-chunk", type=int, default=None,
                   help="take the chunked trainer with this many samples "
                   "a chunk (diff.make_train_step_chunked)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mesh", default=None, metavar="DPxSP")
    p.add_argument("--out", required=True, help="directory for rank*.npz")
    return p


def _flat(prefix: str, scene, camera) -> dict:
    out = {f"{prefix}/{k}": v for k, v in diff.partition(scene).items()}
    out.update({f"{prefix}/camera.{f.name}": getattr(camera, f.name)
                for f in dataclasses.fields(Camera)})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def run(cfg: RenderConfig, scene_name: str, device, mesh=None,
        spp_chunk: int | None = None) -> dict:
    """The step the module's docstring describes, on `device` (with a
    mesh, every rank calls it); with spp_chunk, the chunked trainer's
    (diff.loss_and_grads_chunked, make_train_step_chunked):
    {name: numpy array}."""
    device = torch.device(device)
    scene, cam = SCENES[scene_name](cfg.width, cfg.height)
    with torch.no_grad():
        target, _ = render_image_tiles(scene, cam, cfg, 1, device=device)
    start = dataclasses.replace(scene, sphere_radius=scene.sphere_radius
                                * 1.01)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kernels = (ops_train.render_tiles_train, ops_train.tiles_adjoint)
    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    if spp_chunk:
        loss, gp, gc = diff.loss_and_grads_chunked(
            cfg, start, cam, target, 0, spp_chunk, mesh, device=device)
        step = diff.make_train_step_chunked(cfg, LR, spp_chunk, mesh,
                                            device=device)
    else:
        loss, gp, gc = diff.loss_and_grads(cfg, start, cam, target, 0, mesh,
                                           device=device)
        step = diff.make_train_step(cfg, lr=LR, mesh=mesh, device=device)
    new_scene, new_cam, step_loss = step(start, cam, target, 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = {f"grad/{k}": v.cpu().numpy() for k, v in gp.items()}
    out.update({f"grad/camera.{f.name}": g.cpu().numpy()
                for f, g in zip(dataclasses.fields(Camera), gc)})
    out.update(_flat("param", new_scene, new_cam))
    out.update(loss=np.float32(float(loss)),
               step_loss=np.float32(float(step_loss)),
               wall_s=np.float64(wall), peak_bytes=np.int64(peak),
               launches=np.array([k.launches - b
                                  for k, b in zip(kernels, before)]))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    error = pmesh.flags_error(args.coordinator, args.num_processes,
                              args.process_id)
    if error:
        print(error, file=sys.stderr)
        return 2
    with pmesh.from_flags(args.coordinator, args.num_processes,
                          args.process_id, args.mesh,
                          args.device) as (mesh, backend):
        if mesh.rank == 0:
            print(f"backend {backend}, {mesh.size} rank(s) on {mesh.device}",
                  flush=True)
        width, height = args.resolution
        # The chain's passes split evenly over sp, as the CLI's.
        cfg = RenderConfig(width=width, height=height, spp=args.samples,
                           max_depth=args.max_depth,
                           samples_per_pass=math.gcd(min(4, args.samples),
                                                     args.samples // mesh.sp))
        out = run(cfg, args.scene, mesh.device, mesh, args.spp_chunk)
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{mesh.rank}.npz"),
                 backend=np.array(backend), dp=np.int64(mesh.dp),
                 sp=np.int64(mesh.sp), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
